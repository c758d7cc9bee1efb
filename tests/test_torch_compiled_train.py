"""The compiled train step's CPU-side parts, at smoke sizes with batches
from numpy seeds.

``launch/steps.py`` ``make_train_step`` captures the step as a CUDA graph
on the card (``CompiledStep(in_place=True)``); the capture itself runs only
there (chip_smoke.py phase i). Here a stand-in with ``_cuda_capture``'s
signature does its bookkeeping: the warm-up runs the step eagerly, the
"capture" runs nothing (``reload`` is None for a step that writes its
operands), and a replay runs the step again. Checked:

* N calls apply N updates and equal N eager steps bit for bit (params,
  both moments or Adafactor's factors, the step counter, the metrics), for
  the smoke llama3.2-1b, grok-1 (MoE) and rwkv6-7b, under AdamW with
  accumulation (f32 and int8) and under Adafactor;
* one capture for a signature; every operand held by address: a new batch
  or a resumed state's new buffers capture anew, ``last_copies`` is 0, the
  params and optimizer state come back as themselves (no holder), the
  metrics in holders; a replay adds its capture's launch counts;
* DTensor operands are still refused; ``make_train_step`` is compiled by
  default and eager on the CPU;
* ``kernels.adamw``: the plain version the CPU runs matches the
  reference's AdamW within ``tests/test_torch_optim.py``'s tolerance, and
  the wrapper's host side (input checks, leaf table, groups) as the
  kernel reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro_torch.configs.base import smoke_config
from repro_torch.kernels.adamw import MAX_LEAVES, adamw_ref, adamw_update
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.launch import dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import adafactor, adamw

from _torch_train_ref import batch as np_batch

N_STEPS = 3
OPT_TOL = 1e-6                  # tests/test_torch_optim.py TOL


def _stand_in(counter, per_replay):
    """A capture stand-in: warm up (the step's eager run), capture nothing
    for a step that writes its operands (``reload`` None), replay by
    running the step again."""
    calls = {"capture": 0, "reload": []}

    def capture(run, reload, device):
        calls["capture"] += 1
        calls["reload"].append(reload)
        out = run()
        if reload is not None:
            reload()
            out = run()
        return (lambda: run()), out, [(counter, per_replay)]
    return capture, calls


def _model(arch):
    cfg = smoke_config(arch).replace(attn_impl="xla", scan_impl="xla",
                                     compute_dtype="float32")
    return cfg, build_model(cfg)


def _opt(optimizer):
    if optimizer == "adafactor":
        return adafactor, adafactor.AdafactorConfig(
            lr_peak=1e-2, warmup_steps=2, total_steps=10)
    return adamw, adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2,
                                    total_steps=10)


def _state(model, optimizer):
    mod, _ = _opt(optimizer)
    params = model.init(torch.Generator().manual_seed(0))
    return params, mod.init(params)


def _equal(got, want):
    got, want = tree_to_numpy(got), tree_to_numpy(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _write(buffers, cfg, seed):
    """Write the batch of ``seed`` into ``buffers`` (as the trainer does)."""
    for k, v in np_batch(cfg, seed=seed, b=4).items():
        buffers[k].copy_(torch.from_numpy(v))
    return buffers


CASES = [("llama3_2_1b", "adamw", 1, False), ("grok1_314b", "adamw", 1, False),
         ("rwkv6_7b", "adamw", 1, False), ("llama3_2_1b", "adamw", 2, False),
         ("llama3_2_1b", "adamw", 2, True),
         ("llama3_2_1b", "adafactor", 1, False)]


@pytest.mark.parametrize(
    "arch,optimizer,accum,quantized", CASES,
    ids=[f"{a}-{o}-accum{n}{'-int8' if q else ''}" for a, o, n, q in CASES])
def test_n_calls_apply_n_updates_equal_to_eager(arch, optimizer, accum,
                                                quantized):
    cfg, model = _model(arch)
    _, ocfg = _opt(optimizer)
    kw = dict(optimizer=optimizer, opt_cfg=ocfg, accum_steps=accum,
              quantized_accum=quantized)
    eager = t_steps.make_train_step(model, compiled=False, **kw)
    counter = adamw_update
    capture, calls = _stand_in(counter, 2)
    step = t_steps.CompiledStep(t_steps.make_train_step(
        model, compiled=False, **kw), capture=capture, devices=("cpu",),
        in_place=True)
    p_c, s_c = _state(model, optimizer)
    p_e, s_e = _state(model, optimizer)
    b_c = {k: torch.from_numpy(v) for k, v in
           np_batch(cfg, seed=0, b=4).items()}
    b_e = {k: v.clone() for k, v in b_c.items()}
    n0 = counter.launches
    p_leaves = [t for _, t in L.tree_leaves(p_c)]
    s_leaves = [t for _, t in L.tree_leaves(s_c)]
    for i in range(N_STEPS):
        out_p, out_s, m_c = step(p_c, s_c, _write(b_c, cfg, 100 + i))
        _, _, m_e = eager(p_e, s_e, _write(b_e, cfg, 100 + i))
        assert step.last_copies == 0
        # the params and the optimizer state come back as themselves
        assert all(a is b for a, b in zip(
            [t for _, t in L.tree_leaves(out_p)], p_leaves))
        assert all(a is b for a, b in zip(
            [t for _, t in L.tree_leaves(out_s)], s_leaves))
        assert set(m_c) == set(m_e)
        for k in m_e:
            assert m_c[k].item() == m_e[k].item(), (i, k)
        _equal(p_c, p_e)
        _equal({k: v for k, v in s_c.items() if k != "step"},
               {k: v for k, v in s_e.items() if k != "step"})
        assert int(s_c["step"]) == int(s_e["step"]) == i + 1
    assert calls["capture"] == 1 and calls["reload"] == [None]
    assert len(step.graphs) == 1
    # the first call was the warm-up (its launches counted eagerly: none on
    # the CPU); each replay adds the capture's count
    assert counter.launches - n0 == 2 * (N_STEPS - 1)
    # the metrics live in holders of their own, not in any operand
    graph = next(iter(step.graphs.values()))
    held = {t.untyped_storage().data_ptr() for t in p_leaves + s_leaves}
    for _, t in L.tree_leaves(graph.first[2]):
        assert t.untyped_storage().data_ptr() not in held


def test_new_addresses_capture_anew_and_the_same_replay():
    cfg, model = _model("llama3_2_1b")
    capture, calls = _stand_in(adamw_update, 2)
    step = t_steps.CompiledStep(t_steps.make_train_step(
        model, compiled=False, opt_cfg=_opt("adamw")[1]), capture=capture,
        devices=("cpu",), in_place=True)
    params, state = _state(model, "adamw")
    b = {k: torch.from_numpy(v) for k, v in np_batch(cfg, b=4).items()}
    step(params, state, b)
    step(params, state, _write(b, cfg, 1))
    assert calls["capture"] == 1
    # a fresh batch tensor: another signature, one more capture
    step(params, state, {k: v.clone() for k, v in b.items()})
    assert calls["capture"] == 2
    # a resumed state (new buffers, the same values): captured again
    params2 = L.tree_map(torch.clone, params)
    state2 = {"m": L.tree_map(torch.clone, state["m"]),
              "v": L.tree_map(torch.clone, state["v"]),
              "step": state["step"].clone()}
    step(params2, state2, b)
    assert calls["capture"] == 3 and len(step.graphs) == 3
    assert int(state2["step"]) == int(state["step"]) + 1 == 4


def test_make_train_step_is_compiled_and_runs_eagerly_on_the_cpu():
    cfg, model = _model("llama3_2_1b")
    ocfg = _opt("adamw")[1]
    step = t_steps.make_train_step(model, opt_cfg=ocfg)
    assert isinstance(step, t_steps.CompiledStep) and step.in_place
    eager = t_steps.make_train_step(model, opt_cfg=ocfg, compiled=False)
    assert not isinstance(eager, t_steps.CompiledStep)
    p_c, s_c = _state(model, "adamw")
    p_e, s_e = _state(model, "adamw")
    b = {k: torch.from_numpy(v) for k, v in np_batch(cfg, b=4).items()}
    for _ in range(2):
        _, _, m_c = step(p_c, s_c, b)
        _, _, m_e = eager(p_e, s_e, b)
        assert m_c["loss"].item() == m_e["loss"].item()
    assert not step.graphs                     # the CPU captures nothing
    _equal(p_c, p_e)


def test_compiled_train_step_refuses_dtensor_operands():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    model = build_model(smoke_config("llama3_2_1b"))
    with dryrun.fake_world(2):
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        params = {"w": distribute_tensor(torch.zeros(2, 2), mesh,
                                         [Replicate()], src_data_rank=None)}
        with pytest.raises(NotImplementedError, match="compiled=False"):
            t_steps.make_train_step(model)(params, adamw.init(params), {})


# ---------------------------------------------------------------------------
# kernels/adamw: the plain version and the wrapper's host side
# ---------------------------------------------------------------------------

SHAPES = {"w": (6, 8), "b": (8,), "stack": {"k": (2, 4, 3, 5), "n": (2, 4)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return make(SHAPES)


def _torch(tree):
    return L.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("entry", ["adamw_update", "adamw_ref"])
def test_the_cpus_plain_adamw_matches_the_reference(entry):
    fn = {"adamw_update": adamw_update, "adamw_ref": adamw_ref}[entry]
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = j_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _torch(_tree(0))
    js, ts = j_adamw.init(jp), adamw.init(tp)
    n0 = adamw_update.launches
    for step in range(3):
        g = _tree(10 + step, scale=3.0 if step else 0.01)   # clip, then not
        jp, js, jm = j_adamw.update(jcfg, jax.tree.map(jnp.asarray, g), js,
                                    jp)
        tp, ts, tm = fn(tcfg, _torch(g), ts, tp)
        want = tree_to_numpy(jax.tree.map(np.asarray, jp))
        got = tree_to_numpy(tp)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=OPT_TOL,
                                       atol=OPT_TOL * np.abs(w).max(),
                                       err_msg=k)
        for name in ("m", "v"):
            w_m = tree_to_numpy(jax.tree.map(np.asarray, js[name]))
            g_m = tree_to_numpy(ts[name])
            for k, w in w_m.items():
                np.testing.assert_allclose(g_m[k], w, rtol=OPT_TOL,
                                           atol=OPT_TOL * np.abs(w).max(),
                                           err_msg=(name, k))
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=OPT_TOL)
        assert int(ts["step"]) == step + 1
    assert adamw_update.launches == n0          # the CPU launches nothing


def test_adamw_update_matches_adamw_ref_bit_for_bit_on_the_cpu():
    cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=10)
    a, b = _torch(_tree(1)), _torch(_tree(1))
    sa, sb = adamw.init(a), adamw.init(b)
    for step in range(2):
        g = _torch(_tree(20 + step, scale=2.0))
        _, _, ma = adamw_update(cfg, g, sa, a)
        _, _, mb = adamw_ref(cfg, g, sb, b)
        _equal(a, b)
        _equal(sa["v"], sb["v"])
        assert ma["grad_norm"].item() == mb["grad_norm"].item()


def _quads(n_leaves=3):
    params = {f"l{i:02d}": torch.zeros(4 * i + 3) for i in range(n_leaves)}
    grads = L.tree_map(torch.ones_like, params)
    return params, grads, adamw.init(params)


def test_adamw_inputs_are_checked_before_any_launch():
    params, grads, state = _quads()
    quads = adamw_ops.check_adamw_inputs(grads, state, params)
    assert [q[0] for q in quads] == [p for _, p in L.tree_leaves(params)]
    # a transposed gradient is made contiguous, a parameter must be
    t = {"w": torch.zeros(4, 6)}
    gt = {"w": torch.ones(6, 4).t()}
    q = adamw_ops.check_adamw_inputs(gt, adamw.init(t), t)
    assert q[0][1].is_contiguous() and q[0][1].shape == (4, 6)
    with pytest.raises(ValueError, match="contiguous"):
        pt = {"w": torch.zeros(6, 4).t()}
        adamw_ops.check_adamw_inputs({"w": torch.ones(4, 6)},
                                     adamw.init({"w": torch.zeros(4, 6)}),
                                     pt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ph = {"w": torch.zeros(3, dtype=torch.float16)}
        adamw_ops.check_adamw_inputs(ph, adamw.init(ph), ph)
    with pytest.raises(ValueError, match="gradient"):
        adamw_ops.check_adamw_inputs({"w": torch.ones(5)},
                                     adamw.init({"w": torch.zeros(4)}),
                                     {"w": torch.zeros(4)})
    with pytest.raises(TypeError, match="int32"):
        bad = dict(state, step=torch.zeros((), dtype=torch.int64))
        adamw_ops.check_adamw_inputs(grads, bad, params)


def test_the_leaf_table_numbers_tiles_and_splits_into_groups():
    n = MAX_LEAVES + 6
    params, grads, state = _quads(n)
    quads = adamw_ops.check_adamw_inputs(grads, state, params)
    tables = adamw_ops._tables(quads)
    assert [t.n_leaves for t in tables] == [MAX_LEAVES, 6]
    for t, group in zip(tables, (quads[:MAX_LEAVES],
                                 quads[MAX_LEAVES:])):
        tile = 0
        for j, (p, g, m, v) in enumerate(group):
            leaf = t.leaf[j]
            assert (leaf.p, leaf.g, leaf.m, leaf.v) == (
                p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
            assert leaf.n == p.numel() and leaf.tile0 == tile
            tile += -(-p.numel() // adamw_ops._TILE)
        assert t.tiles == tile
    # the table rides in a launch's parameters: under 4 KB with the rest
    import ctypes
    assert ctypes.sizeof(adamw_ops._Table) + 128 < 4096
    bf = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    q = adamw_ops.check_adamw_inputs({"w": torch.ones(8)}, adamw.init(bf),
                                     bf)
    assert adamw_ops._leaf_flags(*q[0]) & adamw_ops._P_BF16
    assert not adamw_ops._leaf_flags(*q[0]) & adamw_ops._G_BF16

