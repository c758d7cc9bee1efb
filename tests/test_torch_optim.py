"""The port's optimizers and int8 accumulation against the reference's, on
the CPU, given the same gradients (the first AdamW step is close to
sign(g), so a whole-step comparison would flip wherever a gradient is
near zero: the gradients are held on their own in test_torch_loss*.py).

- AdamW: three updates of a tree of rank 1-3 leaves, params, both moments,
  the step and the metrics (``grad_norm``, ``lr``) within 1e-6 relative;
  the schedule and ``clip_by_global_norm``;
- Adafactor: the same, with factored ``vr``/``vc`` for rank >= 2;
- a reference optimizer state carried across (``opt_state_from_jax``) and
  stepped on in both packages;
- ``quantize`` (round half to even) and ``QuantizedAccumulator`` bit for
  bit;
- ``opt_state_axes`` equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro_torch.models.convert import opt_state_from_jax, tree_to_numpy
from repro_torch.optim import adafactor as t_adafactor
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp

TOL = 1e-6
SHAPES = {"w": (6, 8), "b": (8,), "stack": {"k": (2, 4, 3, 5), "n": (2, 4)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return make(SHAPES)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    got, want = tree_to_numpy(got), tree_to_numpy(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


OPTS = {"adamw": (j_adamw, t_adamw, dict(lr_peak=1e-2, warmup_steps=2,
                                         total_steps=10)),
        "adafactor": (j_adafactor, t_adafactor,
                      dict(lr_peak=1e-2, warmup_steps=2, total_steps=10,
                           weight_decay=0.1))}


@pytest.mark.parametrize("name", OPTS)
def test_updates_match_reference_given_the_same_grads(name):
    jmod, tmod, kw = OPTS[name]
    jcfg = (j_adamw.AdamWConfig if name == "adamw"
            else j_adafactor.AdafactorConfig)(**kw)
    tcfg = (t_adamw.AdamWConfig if name == "adamw"
            else t_adafactor.AdafactorConfig)(**kw)
    jp, tp = _jax(_tree(0)), _torch(_tree(0))
    js, ts = jmod.init(jp), tmod.init(tp)
    for step in range(3):
        g = _tree(10 + step, scale=3.0 if step else 0.01)   # clip, then not
        jp, js, jm = jmod.update(jcfg, _jax(g), js, jp)
        tp_in = tp
        tp, ts, tm = tmod.update(tcfg, _torch(g), ts, tp)
        assert tp is tp_in                  # written in place
        _close(tp, jax.tree.map(np.asarray, jp))
        _close({k: v for k, v in ts.items() if k != "step"},
               jax.tree.map(np.asarray, {k: v for k, v in js.items()
                                         if k != "step"}))
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=TOL)


def test_adafactor_state_is_factored():
    st = t_adafactor.init(_torch(_tree(0)))
    assert set(st["v"]["w"]) == {"vr", "vc"}
    assert tuple(st["v"]["w"]["vr"].shape) == (6,)
    assert tuple(st["v"]["w"]["vc"].shape) == (8,)
    assert tuple(st["v"]["stack"]["k"]["vr"].shape) == (2, 4, 3)
    assert tuple(st["v"]["stack"]["k"]["vc"].shape) == (2, 4, 5)
    assert set(st["v"]["b"]) == {"v"}


def test_schedule_and_clip_match_reference():
    cfg_kw = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    jcfg, tcfg = j_adamw.AdamWConfig(**cfg_kw), t_adamw.AdamWConfig(**cfg_kw)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(j_adamw.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        got = t_adamw.schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=TOL, atol=1e-12)
    g = _tree(3, scale=5.0)
    jc, jn = j_adamw.clip_by_global_norm(_jax(g), 1.0)
    tc, tn = t_adamw.clip_by_global_norm(_torch(g), 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=TOL)
    _close(tc, jax.tree.map(np.asarray, jc))
    np.testing.assert_allclose(t_adamw.global_norm(tc).item(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("name", OPTS)
def test_reference_state_carried_across(name):
    """A reference state after one update, converted, steps on in the port
    as it does in the reference."""
    jmod, tmod, kw = OPTS[name]
    jcfg = (j_adamw.AdamWConfig if name == "adamw"
            else j_adafactor.AdafactorConfig)(**kw)
    tcfg = (t_adamw.AdamWConfig if name == "adamw"
            else t_adafactor.AdafactorConfig)(**kw)
    jp = _jax(_tree(0))
    jp, js, _ = jmod.update(jcfg, _jax(_tree(20)), jmod.init(jp), jp)
    tp = _torch(jax.tree.map(np.asarray, jp))
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), tp)
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int32
    g = _tree(21)
    jp, js, _ = jmod.update(jcfg, _jax(g), js, jp)
    tmod.update(tcfg, _torch(g), ts, tp)
    _close(tp, jax.tree.map(np.asarray, jp))
    bad = jax.tree.map(np.asarray, js)
    first = "m" if name == "adamw" else "v"
    bad[first]["b"] = np.zeros((3,), np.float32) if name == "adamw" \
        else {"v": np.zeros((3,), np.float32)}
    with pytest.raises(ValueError, match="b"):
        opt_state_from_jax(bad, tp)


def test_quantize_matches_reference_bit_for_bit():
    """Exact halves round to even in both (max 127 makes the scale 1)."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -126.6],
                 np.float32)
    rng = np.random.default_rng(5)
    for arr in (x, rng.standard_normal((7, 9)).astype(np.float32) * 3,
                np.zeros(4, np.float32)):
        jq, js = j_comp.quantize(jnp.asarray(arr))
        tq, ts = t_comp.quantize(torch.from_numpy(arr))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(
            t_comp.dequantize(tq, ts).numpy(),
            np.asarray(j_comp.dequantize(jq, js)))
    tq, _ = t_comp.quantize(torch.from_numpy(x))
    assert tq[1:7].tolist() == [0, 2, 2, 0, -2, -2]


def test_quantized_accumulator_matches_reference_bit_for_bit():
    p = _tree(0)
    js = j_comp.QuantizedAccumulator.init(_jax(p))
    ts = t_comp.QuantizedAccumulator.init(_torch(p))
    for i in range(3):
        g = _tree(30 + i, scale=10.0 ** (i - 1))
        js = j_comp.QuantizedAccumulator.add(js, _jax(g))
        ts = t_comp.QuantizedAccumulator.add(ts, _torch(g))
        want = tree_to_numpy(jax.tree.map(np.asarray, js))
        got = tree_to_numpy(ts)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        *(lambda a, b: (a["w"], b["w"]))(
            tree_to_numpy(t_comp.QuantizedAccumulator.read(ts)),
            tree_to_numpy(jax.tree.map(
                np.asarray, j_comp.QuantizedAccumulator.read(js)))))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_axes_match_reference(optimizer):
    from repro.launch import steps as j_steps
    from repro_torch.launch import steps as t_steps
    axes = {"w": ("embed", "mlp"), "b": ("mlp",),
            "stack": {"k": ("layers", "embed", "heads", None),
                      "n": ("layers", "embed")}}
    assert t_steps.opt_state_axes(optimizer, axes) == \
        j_steps.opt_state_axes(optimizer, axes)
