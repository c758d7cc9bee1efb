"""Serving steps and Adafactor on a DeviceMesh: the port's uncompiled
prefill and decode steps, and its Adafactor, with DTensor operands on 4
gloo ranks (spawned processes on the CPU) as (data 2, model 2).

* smoke qwen1.5-0.5B (f32, the "xla" attention): a prefill of 4 x 16
  tokens, then 3 greedy decode steps, parameters, batches and caches
  placed by the rules, against the reference's single-device steps
  (called outside ``use_sharding``, whose Explicit-axis meshes jax 0.9
  refuses) within 1e-5, the greedy tokens equal;
* smoke grok-1 (its own optimizer, Adafactor; f32) trained 2 steps on the
  mesh against the port's one-rank steps: losses and parameters within
  1e-5;
* smoke rwkv6-7b (f32, the "xla" scan: its heads fold into the batch in
  a local body on each rank's rows) prefilled and stepped twice on the
  mesh against the port's one-rank steps within 1e-5;
* the dry run lowers smoke ``prefill_32k`` and ``decode_32k`` cells of
  qwen1.5-0.5B, and ``train_4k`` of grok-1, on a fake 8-rank group with
  the reference's keys, ``decode_32k`` of rwkv6-7b, zamba2-2.7b and
  deepseek-v2-lite, and ``train_4k`` of whisper-tiny (its sequence over
  "model": each product's output gradient keeps only its batch shards,
  ``runtime.sharding.product_output``);
* a compiled (CUDA-graph) step refuses DTensor operands.

One spawn of ranks, joined with a 120 s limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _torch_train_ref import batch as make_batch
from _torch_train_ref import pair
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro_torch.configs.base import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import adafactor

B, S, N_STEPS, S_MAX = 4, 16, 3, 24
TOL = 1e-5
OPT_CFG = adafactor.AdafactorConfig(lr_peak=1e-2, warmup_steps=1)
MESH = (("data", 4), ("model", 2))
SEQ_AXIS = 2            # the stacked dense cache: [L, B, S, KVH, hd]


def _identity(tree, axes):
    del axes
    return tree


@pytest.fixture(scope="module")
def serve_setup():
    jcfg, _, jparams, tcfg, _, tparams = pair("qwen1_5_0p5b")
    jmodel = j_build(jcfg.replace(attn_impl="xla"))
    tokens = np.random.default_rng(3).integers(
        1, tcfg.vocab, (B, S)).astype(np.int32)
    prefill = jax.jit(j_steps.make_prefill_step(jmodel))
    decode = jax.jit(j_steps.make_decode_step(jmodel))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(tokens)})
    cache = j_serve.pad_cache_to(cache, S, S_MAX, SEQ_AXIS)
    cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = {"logits": [np.asarray(logits)], "tokens": []}
    lengths = np.full((B,), S, np.int32)
    for _ in range(N_STEPS):
        cur, logits, cache = decode(
            jparams, {"token": cur, "lengths": jnp.asarray(lengths)}, cache)
        want["logits"].append(np.asarray(logits))
        want["tokens"].append(np.asarray(cur))
        lengths = lengths + 1
    np_params = L.tree_map(lambda t: t.numpy().copy(), tparams)
    return tcfg, np_params, tokens, want


@pytest.fixture(scope="module")
def train_setup():
    cfg = smoke_config("grok1_314b").replace(
        attn_impl="xla", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    np_batch = make_batch(cfg, seed=5, b=4, s=16)
    np_params = L.tree_map(lambda t: t.numpy().copy(), params)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    one = ranks._adafactor_steps(model, params, batch, 2, OPT_CFG)
    return cfg, np_params, np_batch, one


@pytest.fixture(scope="module")
def recurrent_setup():
    cfg = smoke_config("rwkv6_7b").replace(scan_impl="xla",
                                           compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(9).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)
    one = ranks._recurrent_steps(model, params, torch.from_numpy(tokens), 2,
                                 _identity)
    return cfg, L.tree_map(lambda t: t.numpy().copy(), params), tokens, one


@pytest.fixture(scope="module")
def mesh_run(serve_setup, train_setup, recurrent_setup, tmp_path_factory):
    tcfg, np_params, tokens, _ = serve_setup
    gcfg, g_params, g_batch, _ = train_setup
    rcfg, r_params, r_tokens, _ = recurrent_setup
    tmp = tmp_path_factory.mktemp("mesh_serve")
    return spawn_ranks(ranks.mesh_serve_and_adafactor, 4,
                       ((tcfg, np_params, tokens, N_STEPS, S_MAX),
                        (gcfg, g_params, g_batch, 2, OPT_CFG),
                        (rcfg, r_params, r_tokens, 2), (2, 2)),
                       init_file=str(tmp / "rdv"), timeout=120)[0]


def test_one_rank_port_steps_match_the_reference(serve_setup):
    """The comparison's base: the port's one-rank steps equal the
    reference's, so the mesh is held against both."""
    tcfg, np_params, tokens, want = serve_setup
    model = build_model(tcfg)
    params = {k: v for k, v in ranks._tensors(np_params).items()}
    got = ranks._serve_steps(model, params, torch.from_numpy(tokens),
                             N_STEPS, S_MAX, _identity)
    for g, w in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("step", range(N_STEPS + 1))
def test_mesh_serving_steps_match_reference(mesh_run, serve_setup, step):
    """Step 0 is the prefill's last logits, then each decode step's."""
    want = serve_setup[3]
    np.testing.assert_allclose(mesh_run["serve"]["logits"][step],
                               want["logits"][step], rtol=TOL, atol=TOL)
    if step:
        np.testing.assert_array_equal(mesh_run["serve"]["tokens"][step - 1],
                                      want["tokens"][step - 1])


def test_adafactor_on_the_mesh_matches_one_rank(mesh_run, train_setup):
    losses, params = mesh_run["train"]
    one_losses, one_params = train_setup[3]
    np.testing.assert_allclose(losses, one_losses, rtol=TOL, atol=TOL)
    assert set(params) == set(one_params)
    for k in one_params:
        np.testing.assert_allclose(params[k], one_params[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("step", range(3))
def test_recurrent_steps_on_the_mesh_match_one_rank(mesh_run,
                                                    recurrent_setup, step):
    np.testing.assert_allclose(mesh_run["recurrent"][step],
                               recurrent_setup[3][step], rtol=TOL, atol=TOL)


def test_adafactor_places_its_moments_like_opt_state_axes():
    """init places vr / vc as the parameter with the reduced dim dropped
    (what ``opt_state_axes`` gives), v as the parameter."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        w = distribute_tensor(torch.zeros(4, 8, 6), mesh,
                              [Shard(1), Shard(2)], src_data_rank=None)
        b = distribute_tensor(torch.zeros(6), mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
        st = adafactor.init({"w": w, "b": b})["v"]
        assert st["w"]["vr"].placements == (Shard(1), Replicate())
        assert st["w"]["vc"].placements == (Replicate(), Shard(1))
        assert tuple(st["w"]["vr"].shape) == (4, 8)
        assert tuple(st["w"]["vc"].shape) == (4, 6)
        assert st["b"]["v"].placements == (Replicate(), Shard(0))


@pytest.mark.parametrize("arch,shape", [
    ("qwen1_5_0p5b", "prefill_32k"), ("qwen1_5_0p5b", "decode_32k"),
    ("grok1_314b", "train_4k"), ("rwkv6_7b", "decode_32k"),
    ("zamba2_2p7b", "decode_32k"), ("deepseek_v2_lite_16b", "decode_32k"),
    ("whisper_tiny", "train_4k")])
def test_dry_run_lowers_serving_and_adafactor_cells(arch, shape, tmp_path):
    patch = dataclasses.asdict(smoke_config(arch))
    r = dryrun.run_cell(arch, shape, multi_pod=False, mesh_axes=MESH,
                        device="cpu", cfg_patch=patch, tag="__smoke",
                        out_dir=str(tmp_path), skip_variants=True)
    assert r["ok"], r.get("traceback")
    for key in ("memory", "cost_scan_program", "n_params",
                "n_active_params", "n_layer_units", "timings"):
        assert key in r
    assert r["cost_scan_program"]["flops"] > 0
    assert r["memory"]["peak_bytes_est"] >= r["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_compiled_step_refuses_dtensor_operands(kind):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    model = build_model(smoke_config("qwen1_5_0p5b"))
    make = (t_steps.make_prefill_step if kind == "prefill"
            else t_steps.make_decode_step)
    with dryrun.fake_world(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        params = {"w": distribute_tensor(torch.zeros(2, 2), mesh,
                                         [Replicate()], src_data_rank=None)}
        with pytest.raises(NotImplementedError, match="compiled=False"):
            make(model, compiled=True)(params, {})
