"""The chunk scan's launch plan, ring arguments and shared-memory layout
(``repro_torch/kernels/ff_chunk_scan/ops.py``), and its plain version
against the reference's Pallas program (``build_program`` via
``chunk_scan_ff``, interpret mode) at every ring depth x streams.

Tolerances: float32 within 3e-5 of max |reference| (the reference's own
kernel test), bfloat16 streams within 2e-2 (both sides read the same bf16
values, compute in f32 and round the output once).
"""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipe import Pipe
from repro.kernels.ff_chunk_scan.kernel import chunk_scan_ff
from repro_torch.kernels.ff_chunk_scan import (chunk_scan, chunk_scan_plain,
                                               max_depth, ring_smem_bytes)
from repro_torch.kernels.ff_chunk_scan import ops as O

H100_SMS = 132
# the two models' prefill scans: (bh, s, n, p) at batch 4, 256 tokens
RWKV6_7B = (256, 256, 64, 64)      # 64 heads of 64
ZAMBA2_2P7B = (320, 256, 64, 64)   # 80 heads, d_state 64, head dim 64
PIPES = list(itertools.product([1, 2, 4], [1, 2]))


def _cover(bh, s, n, p, chunk, sms):
    """Each block of the plan walks its row's chunks in order over its
    slice of columns; count how often each (row, chunk, column) is
    visited."""
    plan = O._plan(bh, s, n, p, chunk, sms)
    chunks = -(-s // chunk)
    seen = np.zeros((bh, chunks, p), np.int64)
    for row in range(bh):
        for sl in range(plan.slices):
            cols = slice(sl * plan.cols, (sl + 1) * plan.cols)
            for c in range(chunks):
                seen[row, c, cols] += 1
    return plan, seen


@pytest.mark.parametrize("shape", [RWKV6_7B, ZAMBA2_2P7B, (8, 200, 64, 64),
                                   (2, 77, 16, 32), (1, 64, 16, 16),
                                   (2, 300, 128, 128), (64, 256, 64, 64),
                                   (3, 100, 32, 48), (1, 40, 64, 256)])
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_plan_covers_every_row_chunk_and_column_once(shape, chunk):
    bh, s, n, p = shape
    plan, seen = _cover(bh, s, n, p, chunk, H100_SMS)
    assert (seen == 1).all()
    assert plan.blocks == bh * plan.slices
    assert plan.cols % 16 == 0 and 16 <= plan.cols <= 128
    assert plan.slices * plan.cols == p


@pytest.mark.parametrize("shape", [RWKV6_7B, ZAMBA2_2P7B],
                         ids=["rwkv6_7b", "zamba2_2p7b"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_plan_fills_the_sms_at_the_models_prefill_shapes(shape, chunk):
    """Every SM gets a block, and a row keeps its columns in one block (its
    cumsum and exponents are then computed once)."""
    plan = O._plan(*shape, chunk, H100_SMS)
    assert plan.blocks >= H100_SMS
    assert plan.slices == 1


def test_plan_splits_p_when_the_rows_leave_sms_idle():
    """rwkv6-7b prefill at batch 1 (64 rows): two slices of 32 columns,
    128 blocks (four more would not fit on the SMs); a single row: four of
    16, the narrowest a block takes."""
    assert O._plan(64, 256, 64, 64, 64, H100_SMS).slices == 2
    assert O._plan(66, 256, 64, 64, 64, H100_SMS).slices == 2
    assert O._plan(67, 256, 64, 64, 64, H100_SMS).slices == 1
    assert O._plan(1, 256, 64, 64, 64, H100_SMS).slices == 4
    assert O._plan(256, 256, 64, 64, 64, 100).slices == 1
    assert O._plan(2, 256, 128, 256, 64, H100_SMS).slices == 16


def test_plan_depends_on_the_shapes_and_sm_count_alone():
    assert O._plan(*RWKV6_7B, 64, H100_SMS) == O._plan(*RWKV6_7B, 64,
                                                       H100_SMS)
    assert O._plan(8, 256, 64, 64, 64, 132) != O._plan(8, 256, 64, 64, 64,
                                                        16)


def _reference_pipe_raises(depth, streams, chunk, n=16):
    try:
        Pipe(tile=(chunk, n), dtype=jnp.float32, depth=depth,
             streams=streams)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams,chunk", [
    (1, 1, 64), (2, 1, 64), (4, 2, 64), (6, 4, 32), (2, 16, 16),
    (0, 1, 64), (-1, 1, 64), (2, 0, 64), (2, 3, 64), (1, 5, 32),
    (2, 64, 64)])
def test_depth_and_streams_are_checked_as_the_reference_pipe(depth, streams,
                                                            chunk):
    """The wrapper raises exactly where the reference's ``Pipe`` raises for
    the scan's (chunk, N) tiles; the CPU plain version takes every valid
    value and ignores it."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32))
    lw = -torch.rand(2, 64, 16)
    if _reference_pipe_raises(depth, streams, chunk):
        with pytest.raises(ValueError):
            chunk_scan(q, q, q, lw, chunk=chunk, depth=depth,
                       streams=streams)
    else:
        out = chunk_scan(q, q, q, lw, chunk=chunk, depth=depth,
                         streams=streams)
        assert torch.equal(out, chunk_scan_plain(q, q, q, lw, chunk=chunk))


def test_defaults_are_the_reference_keywords():
    """The port's entry point plans its ring (keywords default to None);
    the reference's fixed keywords, depth 2 and streams 1, pinned through
    it give the planned call's result."""
    params = inspect.signature(chunk_scan_ff).parameters
    assert (params["depth"].default, params["streams"].default) == (2, 1)
    params = inspect.signature(chunk_scan).parameters
    assert (params["depth"].default, params["streams"].default) == (
        None, None)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32))
    lw = -torch.rand(2, 64, 16, generator=torch.Generator().manual_seed(2))
    assert torch.equal(chunk_scan(q, q, q, lw, chunk=16, depth=2, streams=1),
                       chunk_scan(q, q, q, lw, chunk=16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,streams", PIPES)
@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
def test_plain_version_matches_reference_program_at_pipe(dtype, depth,
                                                         streams, inclusive):
    """The reference's Pallas program (interpret mode) at a ring depth and
    streams, and the port's wrapper given the same keywords (its plain
    version on the CPU), on the same values: q, k and v in ``dtype``,
    log_w in ``dtype`` (RWKV6) or f32 (Mamba2), u in f32."""
    bh, s, n, p, chunk = 2, 64, 16, 16, 32
    rng = np.random.default_rng(10 * depth + streams + 100 * inclusive)
    q = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    k = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    v = rng.standard_normal((bh, s, p)).astype(np.float32)
    lw = (-0.5 * np.exp(rng.standard_normal((bh, s, n)))).astype(np.float32)
    u = None if inclusive else (0.3 * rng.standard_normal((bh, n))).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    w_t = torch.float32 if inclusive else tdt
    ts = [torch.from_numpy(x).to(dt) for x, dt in
          ((q, tdt), (k, tdt), (v, tdt), (lw, w_t))]
    tu = torch.from_numpy(u) if u is not None else None
    js = [jnp.asarray(t.float().numpy(),
                      jnp.float32 if t.dtype == torch.float32 else jdt)
          for t in ts]
    ref = chunk_scan_ff(*js, jnp.asarray(u) if u is not None else None,
                        chunk=chunk, subtile=16, inclusive=inclusive,
                        depth=depth, streams=streams, interpret=True)
    out = chunk_scan(*ts, tu, chunk=chunk, inclusive=inclusive, depth=depth,
                     streams=streams)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    rel = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert rel < (3e-5 if dtype == "float32" else 2e-2)


def test_ring_smem_bytes_mirrors_the_layout():
    """``csrc/ff_chunk_scan.cu`` Layout at N = 64, 64 columns, depth 2:
    a stage is q and k 2 x 16 x 72 x 2, v 16 x 72 x 2 and log_w 16 x 68 x
    4 (f32) or 16 x 72 x 2 (bf16) bytes; a derived buffer 3 x 16 x 72 x 2
    + 17 x 68 x 4 + 16 x 24 x 2 + 16 x 4 + 2 x 64 x 4; then u and the
    carried cumsum 3 x 64 x 4, h 64 x 64 x 4, and 16 bytes of mbarriers a
    stage."""
    stage_f32 = 2 * 16 * 72 * 2 + 16 * 72 * 2 + 16 * 68 * 4
    stage_bf16 = 3 * 16 * 72 * 2 + 16 * 72 * 2
    buf = 3 * 16 * 72 * 2 + 17 * 68 * 4 + 16 * 24 * 2 + 16 * 4 + 2 * 64 * 4
    tail = 3 * 64 * 4 + 64 * 64 * 4
    assert ring_smem_bytes(64, 64, 4, 2) == (2 * stage_f32 + 2 * buf + tail
                                             + 32) == 65472
    assert ring_smem_bytes(64, 64, 2, 2) == 2 * stage_bf16 + 2 * buf + tail \
        + 32
    # the depth grows the stages only; the chunk nothing
    assert (ring_smem_bytes(64, 64, 4, 3) - ring_smem_bytes(64, 64, 4, 2)
            == stage_f32 + 16)
    # three blocks of the models' shape share an SM's 228 KB at depth 2
    assert 3 * (ring_smem_bytes(64, 64, 4, 2) + 1024) <= 228 * 1024


@pytest.mark.parametrize("n,p,w", [(64, 64, torch.float32),
                                   (64, 64, torch.bfloat16),
                                   (128, 128, torch.float32),
                                   (16, 16, torch.bfloat16),
                                   (64, 256, torch.float32)])
def test_max_depth_is_the_deepest_ring_that_fits(n, p, w):
    d = max_depth(n, p, w)
    cols, wb = min(p, 128), torch.finfo(w).bits // 8
    assert d >= 2
    assert ring_smem_bytes(n, cols, wb, d) <= O.SMEM_LIMIT
    assert ring_smem_bytes(n, cols, wb, d + 1) > O.SMEM_LIMIT


def test_body_is_picked_from_types_and_shapes():
    bf, f32 = torch.bfloat16, torch.float32

    def t(n, dt, p=None):
        return torch.zeros(1, 8, n if p is None else p, dtype=dt)

    assert O._body(t(64, bf), t(64, bf), t(64, bf, 64), 64, 16) == "ring"
    assert O._body(t(128, bf), t(128, bf), t(128, bf, 128), 256,
                   16) == "ring"
    assert O._body(t(16, bf), t(16, bf), t(16, bf, 48), 32, 16) == "ring"
    # f32 or mixed q/k/v, an N the ring is not built for, P not a multiple
    # of 16, a chunk not a multiple of 16 or another subtile: the f32 ring
    # body (CUDA cores)
    assert O._body(t(64, f32), t(64, f32), t(64, f32, 64), 64,
                   16) == "f32_ring"
    assert O._body(t(64, bf), t(64, bf), t(64, f32, 64), 64,
                   16) == "f32_ring"
    assert O._body(t(48, bf), t(48, bf), t(48, bf, 64), 64,
                   16) == "f32_ring"
    assert O._body(t(64, bf), t(64, bf), t(64, bf, 40), 64,
                   16) == "f32_ring"
    assert O._body(t(64, bf), t(64, bf), t(64, bf, 64), 40,
                   8) == "f32_ring"
    assert O._body(t(64, bf), t(64, bf), t(64, bf, 64), 64,
                   32) == "f32_ring"


def test_fma_body_splits_p_only_to_fit():
    """The CUDA-core body (the f32 ring body since it replaced the first
    port's) cuts P into slices of at most 32 columns, one a consumer lane,
    whatever N is: N only sets its shared memory, and an N whose every
    stage overflows it is refused (naming shared memory) before any CUDA
    call."""
    assert O._f32_plan(1, 64) == O.Plan(slices=2, cols=32, blocks=2)
    assert O._f32_plan(1, 128) == O.Plan(slices=4, cols=32, blocks=4)
    assert O._f32_plan(1, 256) == O.Plan(slices=8, cols=32, blocks=8)
    assert O.f32_max_depth(256, 256) == 3
    x, v = torch.zeros(1, 64, 1024), torch.zeros(1, 64, 256)
    with pytest.raises(ValueError, match="shared memory"):
        O._launch(x, x, v, x, None, 256, 16, True, 1, 1)
