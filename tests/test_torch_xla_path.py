"""The port of the reference's ``"xla"`` implementation path against the
reference on the same numpy inputs: ``attention_xla`` (causal, masked by
``lengths``, GQA, a v head dim other than q's, the q-chunked branch), the
``"xla"`` decode and paged decode ops (an inactive slot, sentinel table
entries), ``chunk_scan_xla`` untiled and tiled, the scan dispatch that
the models take by ``cfg.scan_impl`` (ragged S padded to the chunk), and
the smoke rwkv6 (``scan_impl="xla_tiled"``) and zamba2 (``scan_impl`` and
``attn_impl`` "xla") prefills, logits and states within 1e-3 (the
reference registry's ff_chunk_scan tolerance, as test_torch_ssm.py).

Tolerances: f32 attention 1e-5 (the same f32 formula, the libraries'
reduction orders); f32 scan 1e-4 (the reference composes the chunks'
transitions as a tree, the port in order); bf16 outputs 2e-2 (one bf16
rounding of the output apart, the reference registry's bf16 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy
from repro.kernels.ff_chunk_scan import chunk_scan as j_chunk_scan
from repro.kernels.ff_chunk_scan.ref import chunk_scan_xla as j_scan_xla
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.kernels.ff_chunk_scan.ref import chunk_scan_xla
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax

ATTN_TOL, SCAN_TOL, BF16_TOL, MODEL_TOL = 1e-5, 1e-4, 2e-2, 1e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _qkv(rng, b, s, skv, h, kvh, d, dv):
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, dv)).astype(np.float32)
    return q, k, v


# (b, s, skv, h, kvh, d, dv, causal, lengths)
ATTN_CASES = {
    "causal-gqa": (2, 12, 12, 4, 2, 16, 16, True, None),
    "causal-mla-dv": (2, 9, 9, 4, 4, 24, 16, True, None),
    "lengths-inactive": (3, 5, 20, 4, 1, 16, 16, False, [20, 7, 0]),
    "causal-and-lengths": (2, 16, 16, 2, 2, 8, 8, True, [16, 11]),
    "q-chunked": (1, 2048, 2048, 2, 1, 8, 8, True, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_attention_xla_matches_reference(case):
    b, s, skv, h, kvh, d, dv, causal, lengths = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, b, s, skv, h, kvh, d, dv)
    lens = None if lengths is None else np.array(lengths, np.int32)
    ref = JL.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal,
                           lengths=None if lens is None else jnp.asarray(lens))
    port = TL.attention_xla(_t(q), _t(k), _t(v), causal=causal,
                            lengths=None if lens is None else _t(lens))
    assert tuple(port.shape) == (b, s, h, dv)
    _close(port, ref, ATTN_TOL)


def test_attention_op_xla_bf16_matches_reference():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 12, 12, 4, 2, 16, 16)
    ref = JL.attention_op(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                          causal=True, impl="xla")
    port = TL.attention_op(*(_t(x).bfloat16() for x in (q, k, v)),
                           causal=True, impl="xla")
    assert port.dtype == torch.bfloat16
    _close(port, ref, BF16_TOL)


def test_decode_attention_op_xla_matches_reference():
    rng = np.random.default_rng(2)
    b, h, kvh, d, skv = 3, 4, 2, 16, 24
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    _, k, v = _qkv(rng, b, 1, skv, h, kvh, d, d)
    lens = np.array([24, 9, 0], np.int32)            # row 2 inactive
    ref = JL.decode_attention_op(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 impl="xla")
    port = TL.decode_attention_op(_t(q), _t(k), _t(v), _t(lens), impl="xla")
    _close(port, ref, ATTN_TOL)


def test_paged_decode_attention_op_xla_matches_reference():
    """Sentinel entries clip into the pool, an inactive row attends to
    nothing; the port's xla paged read equals its dense read bit for bit."""
    rng = np.random.default_rng(3)
    b, h, kvh, d, nb, page, npg = 3, 4, 2, 16, 10, 8, 4
    pool = rng.standard_normal((nb, 2, page, kvh, d)).astype(np.float32)
    perm = rng.permutation(nb)
    bt = np.full((b, npg), nb, np.int32)
    bt[0, :3] = perm[:3]
    bt[1, :] = perm[3:7]
    lens = np.array([19, npg * page, 0], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ref = JL.paged_decode_attention_op(jnp.asarray(q), jnp.asarray(pool),
                                       jnp.asarray(bt), jnp.asarray(lens),
                                       impl="xla")
    port = TL.paged_decode_attention_op(_t(q), _t(pool), _t(bt), _t(lens),
                                        impl="xla")
    _close(port, ref, ATTN_TOL)
    kv = _t(pool)[_t(bt).long().clamp(0, nb - 1)]
    dense = TL.decode_attention_op(
        _t(q), kv[:, :, 0].reshape(b, npg * page, kvh, d),
        kv[:, :, 1].reshape(b, npg * page, kvh, d), _t(lens), impl="xla")
    assert torch.equal(port, dense)


def test_attention_ops_refuse_an_unknown_impl():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="impl"):
        TL.attention_op(q, q, q, causal=True, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        TL.decode_attention_op(q[:, 0], q, q, torch.ones(1, dtype=torch.int32),
                               impl="XLA")
    with pytest.raises(ValueError, match="scan impl"):
        TL.chunk_scan_op(q[0], q[0], q[0], q[0], impl="tiled", chunk=4,
                         inclusive=True)


def _scan_inputs(rng, bh, s, n, p, exclusive):
    q = 0.5 * rng.standard_normal((bh, s, n)).astype(np.float32)
    k = 0.5 * rng.standard_normal((bh, s, n)).astype(np.float32)
    v = rng.standard_normal((bh, s, p)).astype(np.float32)
    lw = (-0.5 * np.exp(rng.standard_normal((bh, s, n)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((bh, n)).astype(np.float32)
         if exclusive else None)
    return q, k, v, lw, u


# (tiled, inclusive, dtype)
SCAN_CASES = [(False, True, "float32"), (False, False, "float32"),
              (True, True, "float32"), (True, False, "float32"),
              (True, True, "bfloat16"), (True, False, "bfloat16")]


@pytest.mark.parametrize(
    "tiled,inclusive,dtype", SCAN_CASES,
    ids=[f"{'tiled' if t else 'untiled'}-"
         f"{'inclusive' if i else 'exclusive'}-{d}" for t, i, d in SCAN_CASES])
def test_chunk_scan_xla_matches_reference(tiled, inclusive, dtype):
    """Four chunks of 32 (two subtiles each), N = 16, P = 32."""
    rng = np.random.default_rng(5)
    q, k, v, lw, u = _scan_inputs(rng, 3, 128, 16, 32, not inclusive)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_scan_xla(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                     jnp.asarray(lw), None if u is None else jnp.asarray(u),
                     chunk=32, inclusive=inclusive, tiled=tiled)
    port = chunk_scan_xla(*(_t(x).to(tdt) for x in (q, k, v)), _t(lw),
                          None if u is None else _t(u), chunk=32,
                          inclusive=inclusive, tiled=tiled)
    assert port.dtype == tdt
    _close(port, ref, SCAN_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("impl", ["xla", "xla_tiled"])
def test_chunk_scan_op_pads_as_the_reference_dispatch(impl):
    """S = 100 against chunk 64: padded to 128 and cut back, as the
    reference's ``chunk_scan(policy=mode)`` does."""
    rng = np.random.default_rng(6)
    q, k, v, lw, u = _scan_inputs(rng, 2, 100, 16, 16, True)
    ref = j_chunk_scan(*(jnp.asarray(x) for x in (q, k, v, lw, u)),
                       inclusive=False, chunk=64,
                       policy=PipePolicy(mode=impl))
    port = TL.chunk_scan_op(*(_t(x) for x in (q, k, v, lw, u)), impl=impl,
                            inclusive=False, chunk=64)
    assert tuple(port.shape) == (2, 100, 16)
    _close(port, ref, SCAN_TOL)


def test_chunk_scan_xla_refuses_a_ragged_s():
    x = torch.zeros(1, 40, 4)
    with pytest.raises(ValueError, match="multiple"):
        chunk_scan_xla(x, x, x, x, chunk=32)


@pytest.mark.parametrize("arch,impls", [
    ("rwkv6_7b", dict(scan_impl="xla_tiled")),
    ("zamba2_2p7b", dict(scan_impl="xla", attn_impl="xla"))],
    ids=["rwkv6-xla_tiled", "zamba2-xla"])
def test_recurrent_prefill_under_xla_matches_reference(arch, impls):
    jcfg = j_smoke(arch).replace(remat="none", **impls)
    tcfg = t_smoke(arch).replace(**impls)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab, size=(2, 40)).astype(np.int32)
    jlog, jcache = jax.jit(j_steps.make_prefill_step(jmodel))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = t_steps.make_prefill_step(t_build(tcfg))(
        tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog, MODEL_TOL)
    t_leaves = jax.tree.leaves(jax.tree.map(lambda a: a.numpy(), tcache))
    j_leaves = jax.tree.leaves(jcache)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(t, np.asarray(j), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
