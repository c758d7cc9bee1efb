"""The port's attention kernels (their plain versions, which the wrappers
run for CPU tensors) against the JAX reference's Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerance 2e-4, the reference registry's ``tol`` for these kernels: both
sides accumulate in f32 over tiles of different sizes. Paged == contiguous
inside the port is checked bit for bit, as the reference holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.program import PipePolicy
from repro.models import layers as JL
from repro.runtime import paged_kv as jpk
from repro_torch.kernels.ff_attention import (BLOCK_KV, attention,
                                              attention_proj, attention_ref,
                                              max_depth)
from repro_torch.kernels.ff_decode_attention import decode_attention
from repro_torch.models import layers as TL
from repro_torch.runtime import paged_kv as tpk

TOL = 2e-4
POLICY = PipePolicy(mode="ff", interpret=True)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _paged_case(seed=4):
    """A pool full of stale values, a permuted table with sentinels past
    each row's reservation, a recycled block shared by a live row's tail
    and a retired row, and one inactive row (length 0, all sentinels)."""
    rng = np.random.default_rng(seed)
    b, h, kvh, d = 3, 4, 2, 16
    nb, page, npg = 10, 8, 4
    pool = rng.standard_normal((nb, 2, page, kvh, d)).astype(np.float32)
    perm = rng.permutation(nb)
    bt = np.full((b, npg), nb, np.int32)               # sentinel-filled
    bt[0, :3] = perm[:3]                               # 3 pages reserved
    bt[1, :] = perm[3:7]                               # full table
    lens = np.array([19, npg * page, 0], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, pool, bt, lens


@pytest.mark.parametrize("causal,s", [(True, 40), (False, 32)])
def test_prefill_attention_matches_reference(causal, s):
    """GQA groups 2; S=40 is ragged against the reference's 16-row blocks
    (its wrapper pads, the port's kernel masks)."""
    rng = np.random.default_rng(0)
    bh, groups, d = 4, 2, 16
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    v = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    ref = repro.ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_groups=groups, causal=causal, block_q=16,
                              block_kv=16, policy=POLICY)
    port = attention(_t(q), _t(k), _t(v), kv_groups=groups, causal=causal)
    _close(port, ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 80])
def test_plain_attention_at_the_tensor_core_tiling(d, causal):
    """The plain version at the bf16 kernel's KV tiling (64 rows, its order
    of rescales), in f32, against the reference's Pallas kernel: head dims
    16 and 80 (zamba2's, which the kernel pads to two 64-column slabs),
    GQA 2, S ragged against the 64-row tiles: 150 causal, 160 non-causal
    (the reference refuses a ragged Skv there: its padded keys would take
    softmax mass)."""
    rng = np.random.default_rng(6)
    bh, groups, s = 4, 2, 150 if causal else 160
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    v = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    ref = repro.ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_groups=groups, causal=causal, block_q=16,
                              block_kv=16, policy=POLICY)
    port = attention_ref(_t(q), _t(k), _t(v), kv_groups=groups,
                         causal=causal, block_kv=BLOCK_KV[torch.bfloat16])
    _close(port, ref)


def test_attention_pipe_keywords_are_checked_and_keep_the_result():
    """``depth`` and ``streams`` are validated for both types against the
    type's own tiles (K/V tiles of 64 rows bf16, 32 f32: streams up to 8
    and 4) and ring, and, on the CPU, leave the plain result as it is."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((2, 40, 16)).astype(np.float32))
               for _ in range(3))
    w = _t(rng.standard_normal((16, 24)).astype(np.float32))
    before = (attention.launches, attention_proj.launches)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, c, ww = (x.to(dtype) for x in (q, k, v, w))
        base = attention(a, b, c)
        base_p = attention_proj(a, b, c, ww)
        most = BLOCK_KV[dtype] // 8
        for depth in (1, 2, 4):
            for streams in (1, 2, most):
                assert torch.equal(attention(a, b, c, depth=depth,
                                             streams=streams), base)
                assert torch.equal(attention_proj(a, b, c, ww, depth=depth,
                                                  streams=streams), base_p)
        for bad in (dict(depth=0), dict(streams=0), dict(streams=3),
                    dict(streams=2 * most), dict(streams=16),
                    dict(depth=max_depth(16, dtype) + 1)):
            with pytest.raises(ValueError):
                attention(a, b, c, **bad)
            with pytest.raises(ValueError):
                attention_proj(a, b, c, ww, **bad)
    assert (attention.launches, attention_proj.launches) == before
    # the deepest ring shrinks with the head dim: 6 stages at 80 (two
    # slabs), 3 at 256 (four)
    assert (max_depth(64), max_depth(80), max_depth(256)) == (13, 6, 3)
    with pytest.raises(ValueError, match="depth 4"):
        attention(torch.zeros(1, 8, 256), torch.zeros(1, 8, 256),
                  torch.zeros(1, 8, 256), depth=4)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(1)
    b, h, kvh, s, d = 3, 4, 2, 32, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    lens = np.array([0, 13, s], np.int32)              # inactive row first
    ref = repro.ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     block_kv=8, policy=POLICY)
    port = decode_attention(_t(q), _t(k), _t(v), _t(lens), block_kv=8)
    _close(port, ref)
    assert torch.equal(port[0], torch.zeros_like(port[0]))


def test_paged_decode_attention_matches_reference():
    q, pool, bt, lens = _paged_case()
    ref = jpk.paged_decode_attention(jnp.asarray(q), jnp.asarray(pool),
                                     jnp.asarray(bt), jnp.asarray(lens),
                                     policy=POLICY)
    port = tpk.paged_decode_attention(_t(q), _t(pool), _t(bt), _t(lens))
    _close(port, ref)
    assert torch.equal(port[2], torch.zeros_like(port[2]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_equals_contiguous_bitwise(dtype):
    """The same pool read through the table and as a dense cache at
    block_kv == page gives the same bits (stale rows past lengths mask to
    exactly 0)."""
    q, pool, bt, lens = _paged_case(seed=7)
    q, pool = _t(q).to(dtype), _t(pool).to(dtype)
    paged = tpk.paged_decode_attention(q, pool, _t(bt), _t(lens))
    k, v = tpk.paged_gather(pool, _t(bt))
    dense = decode_attention(q, k, v, _t(lens), block_kv=pool.shape[2])
    assert torch.equal(paged, dense)


def test_attention_op_dispatch_matches_reference():
    """layers.attention_op: [B,S,H,D] layout, GQA, ragged S."""
    rng = np.random.default_rng(2)
    b, s, h, kvh, d = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    ref = JL.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, impl="ff")
    port = TL.attention_op(_t(q), _t(k), _t(v), causal=True)
    _close(port, ref)


@pytest.mark.parametrize("skv,block_kv", [(20, 8), (40, None), (136, None)])
def test_decode_attention_op_pads_and_pins(skv, block_kv):
    """layers.decode_attention_op on the [B,S,KVH,D] cache: the pinned
    tile pads S up (20 -> 24), the heuristic picks its own tile."""
    rng = np.random.default_rng(3)
    b, h, kvh, d = 2, 4, 2, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    lens = np.array([skv // 3, skv], np.int32)
    ref = JL.decode_attention_op(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 impl="ff", block_kv=block_kv)
    port = TL.decode_attention_op(_t(q), _t(k), _t(v), _t(lens),
                                  block_kv=block_kv)
    _close(port, ref)


def test_paged_decode_attention_op_matches_reference():
    q, pool, bt, lens = _paged_case(seed=5)
    ref = JL.paged_decode_attention_op(jnp.asarray(q), jnp.asarray(pool),
                                       jnp.asarray(bt), jnp.asarray(lens),
                                       impl="ff")
    port = TL.paged_decode_attention_op(_t(q), _t(pool), _t(bt), _t(lens))
    _close(port, ref)


def test_wrappers_validate_and_count_only_kernel_launches():
    """CPU tensors take the plain version without counting a launch;
    malformed inputs and devices without a kernel raise."""
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(1, 4, 16)
    before = (attention.launches, decode_attention.launches,
              tpk.paged_decode_attention.launches)
    attention(q, k, k, kv_groups=2)
    decode_attention(torch.zeros(1, 2, 16), torch.zeros(1, 1, 8, 16),
                     torch.zeros(1, 1, 8, 16), torch.tensor([3]), block_kv=8)
    assert (attention.launches, decode_attention.launches,
            tpk.paged_decode_attention.launches) == before
    with pytest.raises(TypeError):
        attention(q.half(), k.half(), k.half(), kv_groups=2)
    with pytest.raises(ValueError):
        attention(q, k, k, kv_groups=1)
    with pytest.raises(ValueError):
        attention(q.to("meta"), k.to("meta"), k.to("meta"), kv_groups=2)
    with pytest.raises(ValueError):                    # 8 % 3 != 0
        decode_attention(torch.zeros(1, 2, 16), torch.zeros(1, 1, 8, 16),
                         torch.zeros(1, 1, 8, 16), torch.tensor([3]),
                         block_kv=3)
