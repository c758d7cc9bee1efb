"""The port's decode-layer kernels (their plain versions, which the
wrappers run for CPU tensors) against the JAX reference on the same numpy
inputs: the ``ff_layer`` programs run through ``compile_program`` in
interpret mode, and the whole ``decode_layer`` graph with
``PipePolicy(mode="ff", interpret=True)`` and through its XLA oracle
(``mode="ref"``, which calls ``_decode_layer_ref``).

Tolerances: float32 2e-4 (f32 sums over other tile orders; the reference
registry holds ``decode_layer`` to 5e-4), bfloat16 2e-2 (one bf16 rounding
of a value either side of a boundary moves it by 2**-8 relative), both
relative and absolute. Inputs are drawn from numpy and rounded to bfloat16
the same way on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.program import PipePolicy, compile_program
from repro.kernels.ff_layer.kernel import (build_matmul_program,
                                           build_swiglu_program)
from repro.models import layers as JL
from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                          ff_layer_mlp_tail,
                                          ff_layer_swiglu, mlp_tail_staged)
from repro_torch.models import layers as TL

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
POLICY = PipePolicy(mode="ff", interpret=True)
THETA = 1e6


def _jx(a, dtype):
    """numpy f32 -> JAX array in ``dtype`` (integers and the f32 norm
    weights as they are)."""
    x = jnp.asarray(a)
    return x.astype(dtype) if a.dtype == np.float32 else x


def _pt(a, dtype):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(getattr(torch, dtype)) if a.dtype == np.float32 else x


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _mats(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w2 = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    return a, w, w2, nw


# ---------------------------------------------------------------------------
# the two programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "rmsnorm"])
def test_matmul_matches_reference_program(dtype, norm):
    m, k, n = 16, 64, 96
    a, w, _, nw = _mats(0, m, k, n)
    jdt = getattr(jnp, dtype)
    prog = build_matmul_program(m, n, k, norm=norm, dtype=jdt)
    ops = [_jx(a, jdt), _jx(w, jdt)]
    if norm:
        ops.append(jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    ref = compile_program(prog, interpret=True)(*ops)
    out = ff_layer_matmul(_pt(a, dtype), _pt(w, dtype),
                          norm_weight=torch.from_numpy(nw) if norm else None)
    assert out.dtype == getattr(torch, dtype) and out.shape == (m, n)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "rmsnorm"])
def test_swiglu_matches_reference_program(dtype, norm):
    m, k, f = 16, 64, 128
    x, wg, wu, nw = _mats(1, m, k, f)
    jdt = getattr(jnp, dtype)
    prog = build_swiglu_program(m, f, k, norm=norm, dtype=jdt)
    ops = [_jx(x, jdt), _jx(wg, jdt), _jx(wu, jdt)]
    if norm:
        ops.append(jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    ref = compile_program(prog, interpret=True)(*ops)
    out = ff_layer_swiglu(_pt(x, dtype), _pt(wg, dtype), _pt(wu, dtype),
                          norm_weight=torch.from_numpy(nw) if norm else None)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_tail_equals_staged_composition_bitwise(dtype):
    rng = np.random.default_rng(2)
    m, hq, d, f = 5, 48, 32, 80
    a = rng.standard_normal((m, hq)).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    wo = (rng.standard_normal((hq, d)) / np.sqrt(hq)).astype(np.float32)
    wi = (rng.standard_normal((d, 2 * f)) / np.sqrt(d)).astype(np.float32)
    wo2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    nw2 = torch.from_numpy((1 + 0.1 * rng.standard_normal(d))
                           .astype(np.float32))
    wi_t = _pt(wi, dtype)
    args = (_pt(a, dtype), _pt(wo, dtype), _pt(x, dtype), nw2,
            wi_t[:, :f], wi_t[:, f:], _pt(wo2, dtype))
    before = ff_layer_mlp_tail.launches
    fused = ff_layer_mlp_tail(*args)
    assert ff_layer_mlp_tail.launches == before    # the CPU launches nothing
    assert torch.equal(fused, mlp_tail_staged(*args))


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 32)
    w = torch.zeros(32, 64)
    with pytest.raises(TypeError):
        ff_layer_matmul(a, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="is not"):
        ff_layer_matmul(a, torch.zeros(16, 64))
    with pytest.raises(ValueError, match="bias"):
        ff_layer_matmul(a, w, bias=torch.zeros(64))
    pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one epilogue"):
        ff_layer_matmul(a, w, positions=pos, rope_theta=1e4, head_dim=16,
                        residual=torch.zeros(4, 64))
    with pytest.raises(ValueError, match="head_dim"):
        ff_layer_matmul(a, w, positions=pos, rope_theta=1e4, head_dim=24)
    with pytest.raises(ValueError, match="norm weight"):
        ff_layer_swiglu(a, w, w, norm_weight=torch.ones(32,
                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ff_layer_matmul(a.to("meta"), w.to("meta"))


# ---------------------------------------------------------------------------
# the whole decode layer
# ---------------------------------------------------------------------------

CASES = {
    # name: (b, h, kvh, lengths)  (hd 16, d 64, f 128, cache 32, block 8)
    "mha": (4, 4, 4, [32, 9, 17, 1]),
    "gqa": (8, 8, 2, [3, 32, 25, 8, 16, 31, 1, 12]),
    "ragged": (5, 4, 4, [7, 0, 30, 19, 32]),
}
HD, D, F_, S, BKV = 16, 64, 128, 32, 8


def _layer_inputs(case):
    b, h, kvh, lengths = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    lengths = np.array(lengths, np.int32)
    return (
        (0.5 * rng.standard_normal((b, D))).astype(np.float32),       # x
        (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),        # nw1
        (rng.standard_normal((D, h * HD)) / np.sqrt(D)).astype(np.float32),
        (0.1 * rng.standard_normal(h * HD)).astype(np.float32),       # bq
        np.maximum(lengths - 1, 0),                                   # pos
        (0.5 * rng.standard_normal((b, kvh, S, HD))).astype(np.float32),
        rng.standard_normal((b, kvh, S, HD)).astype(np.float32),      # v
        lengths,
        (rng.standard_normal((h * HD, D)) / np.sqrt(h * HD))
        .astype(np.float32),                                          # wo
        (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),        # nw2
        (rng.standard_normal((D, F_)) / np.sqrt(D)).astype(np.float32),
        (rng.standard_normal((D, F_)) / np.sqrt(D)).astype(np.float32),
        (rng.standard_normal((F_, D)) / np.sqrt(F_)).astype(np.float32),
    )


NORM_ARGS = (1, 9)           # nw1, nw2 stay float32 on both sides


def _jax_args(inputs, dtype):
    jdt = getattr(jnp, dtype)
    return [jnp.asarray(a) if i in NORM_ARGS else _jx(a, jdt)
            for i, a in enumerate(inputs)]


def _port_args(inputs, dtype):
    return [torch.from_numpy(a) if i in NORM_ARGS else _pt(a, dtype)
            for i, a in enumerate(inputs)]


@pytest.fixture(scope="module")
def reference_layers():
    """The reference's decode_layer (interpret mode) and its XLA oracle
    on every case and dtype, computed once: a graph call costs seconds in
    interpret mode."""
    out = {}
    for case in CASES:
        inputs = _layer_inputs(case)
        for dtype in DTYPES:
            args = _jax_args(inputs, dtype)
            kw = dict(rope_theta=THETA, block_kv=BKV)
            out[case, dtype] = (
                np.asarray(JL.decode_layer(*args, policy=POLICY, **kw)
                           .astype(jnp.float32)),
                np.asarray(JL.decode_layer(*args, policy=PipePolicy(
                    mode="ref"), **kw).astype(jnp.float32)))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_decode_layer_matches_reference_graph(reference_layers, case,
                                              dtype):
    graph, oracle = reference_layers[case, dtype]
    args = _port_args(_layer_inputs(case), dtype)
    out = TL.decode_layer(*args, rope_theta=THETA, block_kv=BKV)
    assert out.shape == (CASES[case][0], D)
    _close(out, graph, dtype)
    _close(out, oracle, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_decode_layer_ref_matches_reference_oracle(reference_layers, case,
                                                   dtype):
    _, oracle = reference_layers[case, dtype]
    args = _port_args(_layer_inputs(case), dtype)
    _close(TL.decode_layer_ref(*args, rope_theta=THETA), oracle, dtype)


def test_decode_layer_default_block_pads_the_cache():
    """block_kv=None takes the reference's 128-row tile: the 32-row cache
    is padded (masked rows), and the result is the block-8 one's within
    f32 rounding."""
    args = _port_args(_layer_inputs("gqa"), "float32")
    a = TL.decode_layer(*args, rope_theta=THETA)
    b = TL.decode_layer(*args, rope_theta=THETA, block_kv=BKV)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
