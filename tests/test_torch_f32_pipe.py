"""The float32 (and mixed f32/bf16) rings of the port's matmul and prefill
attention, on the CPU.

Both f32 bodies run behind a ring of their own tiles: the product takes
A [128, 32] and B [32, 128] stages, each operand in its own type; the
attention takes K and V tiles of 32 rows beside a 64-row q tile and its
p tile. So ``depth`` and ``streams`` are checked against those tiles as
the reference's ``Pipe`` checks them, the deepest ring is the f32 one, the
cost model counts the f32 stages and the pipe policy plans f32 call sites
under the f32 cap. The wrappers' CPU path (the plain versions) is held
against the reference's Pallas kernels in interpret mode at depth {1, 2,
3} x streams {1, 2}: the product within 5e-4 (the reference registry's
graph tolerance), attention within 2e-4 (its kernel tolerance).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.pipe import Pipe
from repro.core.program import PipePolicy as JPolicy
from repro.kernels.ff_matmul.kernel import matmul_ff
from repro_torch import PipePolicy
from repro_torch.core import autotune
from repro_torch.kernels import ff_attention as A
from repro_torch.kernels.ff_attention import ops as AO
from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                           dispatch_matmul_ref, matmul,
                                           matmul_ref)
from repro_torch.kernels.ff_matmul import ops as M

F32, BF16 = torch.float32, torch.bfloat16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
MM_TOL, ATT_TOL = 5e-4, 2e-4
PAIRS = [(F32, F32), (F32, BF16), (BF16, F32)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ref_pipe_raises(tiles, dtypes, depth, streams):
    """Does the reference's Pipe refuse these values for any of ``tiles``
    (each carried in its type of ``dtypes``)?"""
    try:
        for tile, dt in zip(tiles, dtypes):
            Pipe(tile=tile, dtype=JDT[dt], depth=depth, streams=streams)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("ta,tb", PAIRS, ids=["f32_f32", "f32_bf16",
                                              "bf16_f32"])
def test_matmul_f32_ring_is_its_own(ta, tb):
    """The CUDA-core ring: 32-deep slabs, stages of A [128, 32] and B [32,
    128] in their own types (32 KB in f32, 24 KB with a bf16 operand), as
    many as fit in 227 KB, whatever the output tile; the tensor-core ring
    stays as it was."""
    stage = 128 * 32 * ta.itemsize + 32 * 128 * tb.itemsize
    assert M._stage_bytes(ta, tb) == stage
    deepest = M.max_depth(ta, tb)
    assert M._smem_bytes(deepest, ta, tb) <= M._MAX_SMEM
    assert M._smem_bytes(deepest + 1, ta, tb) > M._MAX_SMEM
    assert deepest == (7 if ta == tb else 9)
    assert M.MAX_DEPTH == M.max_depth(BF16, BF16) == 7
    # 128 x 128 output tiles, 64 x 64 where those would leave SMs idle
    # (the MoE dispatch's 11); never a k split
    assert M._plan(4096, 4096, 4096, ta, tb, 132) == M.Plan(
        "fma", (128, 128, 32), 1)
    assert M._plan(1024, 5632, 1024, ta, tb, 132).tile == (128, 128, 32)
    assert M._plan(64, 1408, 2048, ta, tb, 132) == M.Plan(
        "fma", (64, 64, 32), 1)


@pytest.mark.parametrize("ta,tb", PAIRS, ids=["f32_f32", "f32_bf16",
                                              "bf16_f32"])
@pytest.mark.parametrize("depth,streams", itertools.product(
    [-1, 0, 1, 2, 7, 9, 10], [-2, 0, 1, 2, 3, 4, 5, 8, 16, 32, 48]))
def test_matmul_f32_pipe_checked_as_the_reference_pipe(ta, tb, depth,
                                                       streams):
    """``depth`` and ``streams`` of an f32 or mixed product are refused
    where the reference's Pipe refuses them for the f32 ring's tiles,
    where a sub-copy of the swizzled f32 A tile would be under 8 rows
    (streams 32), and past the ring's deepest stage; else the result is
    the plain version's."""
    a, b = torch.ones(4, 8, dtype=ta), torch.ones(8, 3, dtype=tb)
    kw = dict(depth=depth, streams=streams)
    refused = (_ref_pipe_raises([(128, 32), (32, 128)], [ta, tb], depth,
                                streams)
               or 128 // max(streams, 1) < 8 or depth > M.max_depth(ta, tb))
    assert M.stream_options(range(1, 49), ta, tb) == (1, 2, 4, 8, 16)
    if refused:
        with pytest.raises(ValueError):
            matmul(a, b, **kw)
        with pytest.raises(ValueError):
            M._pipe(depth, streams, ta, tb)
    else:
        assert torch.equal(matmul(a, b, **kw), matmul_ref(a, b))
        assert M._pipe(depth, streams, ta, tb) == (depth, streams)


def test_gathered_f32_launch_takes_the_f32_ring():
    tokens = torch.ones(5, 8)
    idx = torch.tensor([1, 0, 4], dtype=torch.int32)
    b = torch.ones(8, 3)
    for kw in (dict(depth=M.max_depth(F32) + 1), dict(streams=32),
               dict(streams=3)):
        with pytest.raises(ValueError):
            dispatch_matmul(tokens, idx, b, **kw)
    assert torch.equal(dispatch_matmul(tokens, idx, b, depth=M.max_depth(F32),
                                       streams=16),
                       dispatch_matmul_ref(tokens, idx, b))


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
def test_attention_f32_ring_is_its_own(d):
    """The f32 block: a 64-row q tile and a p tile of 64 x 32 floats beside
    ``depth`` stages of K and V tiles of 32 rows, d padded to 32-float
    slabs; the deepest ring that fits 227 KB (2 at head dim 256, where a
    stage is 64 KB), which is not the bf16 one."""
    slabs = -(-d // 32)
    for depth in (1, 2, 3):
        assert AO._smem_bytes(d, depth, F32) == (
            1024 + slabs * 64 * 128 + 64 * 128
            + depth * 2 * slabs * 32 * 128 + 8 * (2 * depth + 1))
    deepest = A.max_depth(d, F32)
    assert AO._smem_bytes(d, deepest, F32) <= AO._MAX_SMEM
    assert AO._smem_bytes(d, deepest + 1, F32) > AO._MAX_SMEM
    assert deepest == {16: 26, 32: 26, 64: 12, 80: 8, 128: 5, 256: 2}[d]
    assert (A.BLOCK_Q[F32], A.BLOCK_KV[F32]) == (64, 32)


@pytest.mark.parametrize("depth,streams", itertools.product(
    [-1, 0, 1, 2, 12, 13], [-2, 0, 1, 2, 3, 4, 8, 16]))
def test_attention_f32_pipe_checked_as_the_reference_pipe(depth, streams):
    """At head dim 64: refused where the reference's Pipe refuses the 32-
    row K/V tile, where a box would be under 8 rows (streams 8), and past
    the f32 ring's 12 stages (13 fits the bf16 ring at this head dim); the
    fused attention_proj takes the same checks."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal((2, 40, 64)).astype(np.float32))
               for _ in range(3))
    w = _t(rng.standard_normal((64, 24)).astype(np.float32))
    refused = (_ref_pipe_raises([(32, 64)], [F32], depth, streams)
               or 32 // max(streams, 1) < 8 or depth > 12)
    kw = dict(depth=depth, streams=streams)
    if refused:
        with pytest.raises(ValueError):
            A.attention(q, k, v, **kw)
        with pytest.raises(ValueError):
            A.attention_proj(q, k, v, w, **kw)
    else:
        assert torch.equal(A.attention(q, k, v, **kw), A.attention_ref(q, k, v))
        assert torch.equal(A.attention_proj(q, k, v, w, **kw),
                           A.attention_proj_ref(q, k, v, w))
    assert AO.stream_options((1, 2, 4, 8), F32) == (1, 2, 4)


def test_costs_count_the_f32_stages():
    """matmul_cost and attention_cost give f32 calls the shared memory of
    their own rings (they gave 0 while f32 ran no ring)."""
    c = M.matmul_cost(4096, 4096, 4096, dtype=F32, depth=3)
    assert c.smem_bytes == 1024 + 3 * 32768 + 16 * 3 + 8 * 128
    assert c.hbm_bytes == (4096 * 4096 * 32 * 2 + 4096 * 4096) * 4
    assert c.flops == 2.0 * 4096 ** 3
    assert M.matmul_cost(4096, 4096, 4096, dtype=BF16,
                         depth=3).smem_bytes == c.smem_bytes
    a = AO.attention_cost(64, 256, 64, dtype=F32, depth=2)
    assert a.smem_bytes == 58408
    # 4 q tiles of 64 rows read 2, 4, 6, 8 K/V tiles of 32 rows a head
    assert a.hbm_bytes == 64 * 20 * 2 * 32 * 64 * 4 + 2 * 64 * 256 * 64 * 4
    assert AO.attention_cost(64, 256, 64, dtype=BF16,
                             depth=2).smem_bytes == 1024 + 8192 * 5 + 40


def _spy(monkeypatch):
    seen = []
    real = autotune.resolve_call

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((op, kw["depth_cap"], kw["dtype"], choice))
        return choice

    monkeypatch.setattr(autotune, "resolve_call", spy)
    return seen


@pytest.mark.parametrize("d", [64, 256])
def test_policy_plans_f32_attention_under_the_f32_cap(monkeypatch, d):
    seen = _spy(monkeypatch)
    q = torch.zeros(2, 32, d)
    with repro_torch_policy():
        A.attention(q, q, q)
        A.attention(q.to(BF16), q.to(BF16), q.to(BF16))
    (op, cap, dt, choice), (_, bcap, bdt, _) = seen
    assert op == "ff_attention" and (dt, bdt) == (F32, BF16)
    assert cap == A.max_depth(d, F32) != A.max_depth(d, BF16) == bcap
    assert 1 <= choice.depth <= cap
    assert choice.streams in AO.stream_options((1, 2, 4, 8), F32)


@pytest.mark.parametrize("ta,tb", PAIRS, ids=["f32_f32", "f32_bf16",
                                              "bf16_f32"])
def test_policy_plans_f32_products_under_the_f32_cap(monkeypatch, ta, tb):
    seen = _spy(monkeypatch)
    with repro_torch_policy():
        matmul(torch.zeros(300, 256, dtype=ta), torch.zeros(256, 200,
                                                             dtype=tb))
    (op, cap, dt, choice), = seen
    assert op == "ff_matmul" and dt == ta
    assert cap == M.max_depth(ta, tb)
    assert 1 <= choice.depth <= cap
    assert choice.streams in M.stream_options((1, 2, 4, 8, 16), ta, tb)


def test_graph_plans_f32_attention_proj_under_the_f32_cap(monkeypatch):
    seen = []
    real = autotune.resolve_graph

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((kw["depth_cap"], choice))
        return choice

    monkeypatch.setattr(autotune, "resolve_graph", spy)
    q = torch.zeros(2, 64, 256)
    with repro_torch_policy():
        A.attention_proj(q, q, q, torch.zeros(256, 32))
    (cap, choice), = seen
    assert cap == A.max_depth(256, F32) == 2 and choice.depth <= cap


def repro_torch_policy():
    import repro_torch
    return repro_torch.policy(mode="ff")


@pytest.mark.parametrize("depth,streams", itertools.product([1, 2, 3],
                                                            [1, 2]))
@pytest.mark.parametrize("tb", [F32, BF16], ids=["f32", "f32_bf16"])
def test_plain_f32_matmul_matches_reference_matmul_ff(tb, depth, streams):
    rng = np.random.default_rng(10 * depth + streams)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    bt = torch.from_numpy(b).to(tb)
    out = matmul(_t(a), bt, policy=PipePolicy(depth=depth, streams=streams))
    ref = matmul_ff(jnp.asarray(a), jnp.asarray(bt.float().numpy(),
                                                dtype=JDT[tb]),
                    depth=depth, streams=streams, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MM_TOL,
                               atol=MM_TOL)


@pytest.mark.parametrize("depth,streams", itertools.product([1, 2, 3],
                                                            [1, 2]))
def test_plain_f32_attention_matches_reference_at_pipe(depth, streams):
    """GQA 2, causal, S = 96 (three of the port's 32-row K/V tiles,
    against the reference's 32-row blocks) at the same depth and
    streams."""
    rng = np.random.default_rng(20 + 10 * depth + streams)
    bh, groups, s, d = 4, 2, 96, 32
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    v = rng.standard_normal((bh // groups, s, d)).astype(np.float32)
    ref = repro.ops.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_groups=groups,
        causal=True, block_q=32, block_kv=32,
        policy=JPolicy(mode="ff", depth=depth, streams=streams,
                       interpret=True))
    port = A.attention(_t(q), _t(k), _t(v), kv_groups=groups, causal=True,
                       policy=PipePolicy(depth=depth, streams=streams))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=ATT_TOL,
                               atol=ATT_TOL)
