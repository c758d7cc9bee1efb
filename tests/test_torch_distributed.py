"""The port's distributed runtime on gloo ranks (spawned processes on the
CPU), held against the port's single-rank step and the reference.

* one AdamW step of smoke llama3.2-1b sharded over (data 4, model 2)
  against the port's single-rank step and the reference's single-device
  step (called outside ``use_sharding``, whose Explicit-axis meshes jax
  0.9 refuses), to the reference's own bounds: params within 1e-3 after
  one step, loss within 1e-4 (``tests/test_distributed.py``);
* the 8-rank job's checkpoint restored by ``remesh_restore`` onto
  ``survivable_mesh`` of 4 ranks, bit for bit, the stale plans dropped;
* the ring collectives and GPipe against the reference's ``shard_map``
  bodies on the same numpy inputs (a subprocess with 4 forced host
  devices), f32 at 1e-5; ``compressed_allreduce`` within max|x|/127.

Two spawns in all (8 ranks, then 4), each joined with a 120 s limit.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _torch_train_ref import pair
from repro.launch import steps as j_steps
from repro.optim import adamw as j_adamw
from repro_torch.launch import steps as t_steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import adamw

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
B, S = 8, 32


@pytest.fixture(scope="module")
def setup():
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair("llama3_2_1b")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)}
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams, batch


@pytest.fixture(scope="module")
def sharded(setup, tmp_path_factory):
    """The (data 4, model 2) step on 8 ranks, its parameters saved."""
    _, _, _, tcfg, _, tparams, batch = setup
    tmp = tmp_path_factory.mktemp("dist8")
    np_params = L.tree_map(lambda t: t.numpy(), tparams)
    out = spawn_ranks(ranks.train_step_and_save, 8,
                      (tcfg, np_params, batch, (4, 2), str(tmp / "ckpt")),
                      init_file=str(tmp / "rdv"), timeout=120)[0]
    return out, str(tmp / "ckpt")


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(64, 32), "w": f(32, 16), "x2": f(64, 128),
            "w2": f(128, 16), "ws": f(4, 16, 16) / 4.0, "mb": f(8, 4, 16),
            "c": f(4, 64, 128) * 3.0}


@pytest.fixture(scope="module")
def four(setup, sharded, ring_inputs, tmp_path_factory):
    tcfg = setup[3]
    tmp = tmp_path_factory.mktemp("dist4")
    return spawn_ranks(ranks.remesh_and_rings, 4,
                       (tcfg, sharded[1], ring_inputs),
                       init_file=str(tmp / "rdv"), timeout=120)[0]


@pytest.fixture(scope="module")
def reference_rings(ring_inputs, tmp_path_factory):
    """The reference's shard_map collectives and pipeline on 4 forced host
    devices, on ``ring_inputs``."""
    tmp = tmp_path_factory.mktemp("jaxrings")
    np.savez(tmp / "in.npz", **ring_inputs)
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.runtime.collectives import (allgather_matmul,
            matmul_reducescatter, ring_allgather)
        from repro.runtime.pipeline_parallel import pipeline_apply
        from repro.runtime.streams import shard_map_compat
        i = dict(np.load(r"{tmp / 'in.npz'}"))
        d = jax.make_mesh((4,), ("d",))
        ag = shard_map_compat(lambda a, b: allgather_matmul(a, b, "d"), d,
                              (P("d", None), P(None, None)), P(None, None))
        rs = shard_map_compat(lambda a, b: matmul_reducescatter(a, b, "d"),
                              d, (P(None, "d"), P("d", None)), P("d", None))
        rg = shard_map_compat(lambda a: ring_allgather(a, "d"), d,
                              (P("d", None),), P(None, None))
        pod = jax.make_mesh((4,), ("pod",))
        pp = shard_map_compat(
            lambda w, x: pipeline_apply(lambda ww, h: jnp.tanh(h @ ww),
                                        w[0], x, "pod"),
            pod, (P("pod"), P(None)), P("pod"))
        np.savez(r"{tmp / 'out.npz'}",
                 allgather_matmul=ag(i["x"], i["w"]),
                 matmul_reducescatter=rs(i["x2"], i["w2"]),
                 ring_allgather=rg(i["x"]),
                 pipeline_last=np.asarray(pp(i["ws"], i["mb"]))[-8:])
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _port_single_step(tmodel, tparams, batch):
    p = L.tree_map(lambda t: t.clone(), tparams)
    step = t_steps.make_train_step(tmodel, opt_cfg=ranks.OPT_CFG)
    p, _, m = step(p, adamw.init(p),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    return tree_to_numpy(p), float(m["loss"])


def _reference_step(jmodel, jparams, batch):
    cfg = j_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    init, _ = j_steps.opt_init_and_update("adamw", cfg)
    step = jax.jit(j_steps.make_train_step(jmodel, opt_cfg=cfg))
    p, _, m = step(jparams, init(jparams),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(p)}
    return flat, float(m["loss"])


def _max_diff(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in a)


def test_sharded_train_step_matches_port_single_rank(setup, sharded):
    _, _, _, _, tmodel, tparams, batch = setup
    want, loss = _port_single_step(tmodel, tparams, batch)
    got = sharded[0]
    assert _max_diff(got["params"], want) < 1e-3
    assert abs(got["metrics"]["loss"] - loss) < 1e-4


def test_sharded_train_step_matches_reference_single_device(setup, sharded):
    _, jmodel, jparams, _, _, _, batch = setup
    want, loss = _reference_step(jmodel, jparams, batch)
    got = sharded[0]
    assert _max_diff(got["params"], want) < 1e-3
    assert abs(got["metrics"]["loss"] - loss) < 1e-4


def test_adamw_norm_counts_each_element_once_over_the_mesh(sharded):
    """The AdamW kernel's wrapper on a (data 4, model 2) mesh: each rank's
    owned shards (a leaf replicated over an axis counted at its coordinate
    0), all-reduced over both axes, sum to the whole tree's squares."""
    got, want = sharded[0]["norm_sq"]
    assert want > 0
    assert abs(got - want) <= 1e-12 * want


def test_sharded_params_split_over_model(setup, sharded):
    """Each rank holds the rules' share: the vocab, head and MLP dims
    halved over "model", the kv heads and norms whole."""
    tmodel, tparams = setup[4], setup[5]
    full = sum(t.numel() * 4 for _, t in L.tree_leaves(tparams))
    specs = dict(L.tree_leaves(tmodel.param_specs()))
    whole = sum(int(np.prod(s.shape)) * 4 for p, s in specs.items()
                if not {"vocab", "heads", "mlp"} & set(s.axes))
    want = whole + (full - whole) // 2
    assert sharded[0]["param_bytes"] == [want] * 8
    assert want < full


def test_remesh_restore_is_bitwise(sharded, four):
    with np.load(os.path.join(sharded[1], "step_00000005",
                              "arrays.npz")) as ck:
        saved = {k: ck[k] for k in ck.files}
    got = four["restored"]
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the checkpoint holds the 8-rank job's stepped parameters
    assert _max_diff(saved, sharded[0]["params"]) == 0.0


def test_remesh_report_drops_the_lost_topology(four):
    rep = four["remesh"]
    assert rep["step"] == 5 and rep["mesh"] == "data2.model2"
    assert rep["planner_dropped"] == 1 and rep["autotune_dropped"] == 1
    assert rep["plans_left"] == 1                 # the single-device plan
    assert rep["placements"]["embed"] == "(Replicate(), Shard(dim=0))"
    assert rep["placements"]["stack/layers/mixer/wk"] == \
        "(Replicate(), Replicate())"


@pytest.mark.parametrize("name", ["allgather_matmul", "matmul_reducescatter",
                                  "ring_allgather", "pipeline_last"])
def test_rings_match_reference_shard_map(four, reference_rings, name):
    np.testing.assert_allclose(four[name], reference_rings[name],
                               rtol=1e-5, atol=1e-5)


def test_rings_match_plain_torch(four, ring_inputs):
    i = {k: torch.from_numpy(v) for k, v in ring_inputs.items()}
    np.testing.assert_allclose(four["allgather_matmul"],
                               (i["x"] @ i["w"]).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(four["matmul_reducescatter"],
                               (i["x2"] @ i["w2"]).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(four["ring_allgather"], ring_inputs["x"])
    h = i["mb"]
    for s in range(4):
        h = torch.tanh(h @ i["ws"][s])
    # the same products as the stages, in this process's threads
    np.testing.assert_allclose(four["pipeline_last"], h.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_compressed_allreduce_error_bound(four, ring_inputs):
    x = ring_inputs["c"]
    want = x.mean(axis=0)
    err = float(np.abs(four["compressed"] - want).max())
    bound = float(np.abs(x).max()) / 127.0 + 1e-6
    assert err <= bound, (err, bound)
    assert err > 0                        # the int8 wire is really lossy
