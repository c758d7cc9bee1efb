"""The float32 ring of the port's decode-layer kernels, on the CPU.

``csrc/ff_layer.cu`` runs one ring body for both types: 64-column tiles
times a split of k on every SM, 16 KB stages of weight rows (64 or 32 f32
rows a matmul or SwiGLU stage, against 128 or 64 in bf16), the same f32
partial tiles and tickets. So the f32 launches take the bf16 plan, a
tile's columns sit where ``mm_col`` puts them in 4-column chunks, the
stage the cost model counts is the kernel's, ``depth`` and ``streams``
are checked as the reference's ``Pipe`` checks them, and the pipe policy
plans f32 call sites (and the decode layer's one graph plan) under the
cap. The wrappers' CPU path (the plain versions) is held against the
reference's ``build_matmul_program`` / ``build_swiglu_program`` in
interpret mode at depth {1, 2, 3} x streams {1, 2} in f32, within 2e-4
(``tests/test_torch_ff_layer.py``'s f32 tolerance).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipe import Pipe
from repro.core.program import compile_program
from repro.kernels.ff_layer.kernel import (build_matmul_program,
                                           build_swiglu_program)
import repro_torch
from repro_torch.core import autotune
from repro_torch.kernels.ff_decode_attention import ops as DO
from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                          ff_layer_matmul_ref,
                                          ff_layer_mlp_tail,
                                          ff_layer_mlp_tail_ref,
                                          ff_layer_swiglu,
                                          ff_layer_swiglu_ref)
from repro_torch.kernels.ff_layer import ops as L
from repro_torch.models import layers as TL

F32, BF16 = torch.float32, torch.bfloat16
SMS = 132                      # the H100's SM count, passed in
TOL = 2e-4
# (m, hq, d, f): qwen1.5-0.5B's decode layer, qwen2-72b's (k 29568 in the
# down-projection)
WIDTHS = {"qwen": (4, 1024, 1024, 2816), "qwen2_72b": (4, 8192, 8192, 29568)}


def _record(monkeypatch):
    """Fake the C entries: every launch's (kernel, dtype, args)."""
    seen = []

    def fake_entry(kernel, dtype):
        return lambda *args: seen.append((kernel, dtype, args)) or 0

    monkeypatch.setattr(L, "_entry", fake_entry)
    monkeypatch.setattr(L, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(L._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(L, "_TICKETS", {})
    return seen


def _shaped(*shape, dtype):
    """A tensor of ``shape`` with one element behind it (the fake launches
    read shapes, strides and pointers only)."""
    return torch.zeros((), dtype=dtype).expand(*shape)


def _launch_all(m, hq, d, f, dtype):
    """The standalone launches at the tail's three shapes, then the tail."""
    z = lambda *s: _shaped(*s, dtype=dtype)  # noqa: E731
    nw = torch.ones(d)
    kw = dict(norm_weight=None, eps=1e-6, epilogue="residual", bias=None,
              pos=None, freqs=None, head_dim=None, depth=2, streams=1)
    L._launch_matmul(z(m, hq), z(hq, d), z(m, d), residual=z(m, d), **kw)
    L._launch_swiglu(z(m, d), z(d, f), z(d, f), z(m, f), norm_weight=nw,
                     eps=1e-6, depth=2, streams=1)
    L._launch_matmul(z(m, f), z(f, d), z(m, d), residual=z(m, d), **kw)
    L._launch_tail(z(m, hq), z(hq, d), z(m, d), nw, z(d, f), z(d, f),
                   z(f, d), z(m, d), z(m * (d + f)), eps=1e-6, depth=2,
                   streams=1)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_f32_launches_take_the_bf16_plan(monkeypatch, width):
    """Each f32 launch passes the k split, a workspace where it splits and
    the tickets exactly as its bf16 twin does (no split of 1 left over
    from the CUDA-core body), and the split is ``_plan``'s, from the shape
    alone; at qwen2-72b's widths k 29568 splits into pieces of at most
    2048 rows."""
    m, hq, d, f = WIDTHS[width]
    seen = _record(monkeypatch)
    _launch_all(m, hq, d, f, F32)
    _launch_all(m, hq, d, f, BF16)
    f32, bf16 = seen[:4], seen[4:]
    assert [dt for _, dt, _ in f32] == [F32] * 4
    assert [dt for _, dt, _ in bf16] == [BF16] * 4
    want = [L._plan(d, hq, SMS).split, L._plan(f, d, SMS).split,
            L._plan(d, f, SMS).split]
    for (kernel, _, a32), (_, _, a16) in zip(f32, bf16):
        # (..., split(s), ws, tickets, stream): the same splits, a
        # workspace where they split, the tickets
        n = 3 if kernel == "ff_layer_mlp_tail" else 1
        assert a32[-3 - n:-3] == a16[-3 - n:-3]
        assert (a32[-3] is None) == (a16[-3] is None)
        assert a32[-2] is not None and a16[-2] is not None
    splits = [a[-4] for _, _, a in f32[:3]]
    assert splits == want and list(f32[3][2][-6:-3]) == want
    assert all((a[-3] is None) == (sp == 1)
               for sp, (_, _, a) in zip(want, f32))
    if width == "qwen2_72b":
        rows = L._split_rows(f, want[2])
        assert max(hi - lo for lo, hi in rows) <= L._MAX_SPLIT_ROWS + 8
        assert rows[-1][1] == 29568


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_f32_ring_size_is_the_bf16_one(width):
    """``ring_size`` (the splits, the workspace words of the splits' f32
    partial tiles, the tickets) is one function of the shapes: the
    kernel's partial tile is 64 (SwiGLU 128) f32 columns in both types,
    so the workspace the wrapper allocates is what the f32 launch
    writes."""
    m, hq, d, f = WIDTHS[width]
    stages = [("matmul", d, hq), ("swiglu", f, d), ("matmul", d, f)]
    splits, words, tickets = L.ring_size(m, stages, SMS)
    assert splits == [L._plan(n, k, SMS).split for _, n, k in stages]
    assert words == max(L._plan(n, k, SMS).tiles * L._plan(n, k, SMS).split
                        * m * L._PARTIAL_COLS[kind]
                        for kind, n, k in stages)
    assert tickets == max(L._plan(n, k, SMS).tiles for _, n, k in stages) + 2
    for kind, cols in L._PARTIAL_COLS.items():
        # chunks a staged row holds x columns a chunk, both types
        for dtype in (F32, BF16):
            chunks = cols * dtype.itemsize // 16
            assert chunks * L._VEC[dtype] == cols


@pytest.mark.parametrize("n,head_dim", [(1024, None), (1000, None),
                                        (1024, 64), (896, 64), (8192, 128),
                                        (256, 128), (640, 80), (48, 16),
                                        (96, 24)])
def test_f32_tiles_hold_4_column_chunks(n, head_dim):
    """Every column in one f32 tile; with RoPE each tile is 32 columns of
    the first halves of heads in chunks of 4, then the same columns of the
    second halves (a head of 64 is one tile, a head of 128 two tiles of 32
    columns of each half). Where bf16 takes the head dim (half a multiple
    of 8) the f32 tiles hold the same columns in the same order."""
    tiles = L._plan(n, 1024, SMS).tiles
    cols = [L._tile_columns(n, t, head_dim, F32) for t in range(tiles)]
    flat = [c for tile in cols for c in tile]
    assert sorted(flat) == list(range(n)) and len(set(flat)) == n
    if head_dim is None:
        assert cols[0] == list(range(64))
        return
    half = head_dim // 2
    for tile in cols:
        first, second = tile[:len(tile) // 2], tile[len(tile) // 2:]
        assert [c + half for c in first] == second
        assert all(c % head_dim < half for c in first)
        for i in range(0, len(first), 4):         # whole 4-column chunks
            assert first[i:i + 4] == list(range(first[i], first[i] + 4))
    if head_dim == 64:
        assert cols[3] == list(range(192, 256))
    if head_dim == 128:
        assert cols[1] == list(range(32, 64)) + list(range(96, 128))
    if half % 8 == 0:
        assert cols == [L._tile_columns(n, t, head_dim, BF16)
                        for t in range(tiles)]


def test_f32_stage_is_the_workload_word():
    """ff_layer_workload counts the kernel's f32 stage: a 16 KB word of 64
    weight rows of a 64-column tile (SwiGLU: 32 rows of wg's and wu's
    columns), ceil(k / rows) of them a tile, twice bf16's words at the
    same shape."""
    for gated, rows in ((False, 64), (True, 32)):
        w, tile = L.ff_layer_workload(4, 29568, 8192, dtype=F32, gated=gated)
        assert tile == (rows, 64)
        assert w.word_bytes == L._STAGE_BYTES
        assert w.n_words == 8192 // 64 * -(-29568 // rows)
        assert w.flops_per_word == 2.0 * 4 * rows * 64 * (2 if gated else 1)
        b, btile = L.ff_layer_workload(4, 29568, 8192, dtype=BF16,
                                       gated=gated)
        assert btile == (2 * rows, 64)
        assert w.n_words == 2 * b.n_words - (
            8192 // 64 if 29568 % (2 * rows) else 0)
        # the stage is what the kernel's ring holds: 16-byte chunks of
        # 4 columns, L._PARTIAL_COLS columns a row
        cols = L._PARTIAL_COLS["swiglu" if gated else "matmul"]
        assert L._STAGE_BYTES // (cols // L._VEC[F32] * 16) == rows


def _pipe_raises(depth, streams, k=16):
    try:
        Pipe(tile=(8, k), dtype=jnp.float32, depth=depth, streams=streams)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams", itertools.product(
    [-1, 0, 1, 2, 3, L.MAX_DEPTH, L.MAX_DEPTH + 1], [0, 1, 2, 3, 4, 8, 16]))
def test_f32_pipe_checked_as_the_reference_pipe(depth, streams):
    """f32 calls refuse what the reference's f32 ``Pipe`` refuses on the
    programs' activation stream (8 rows of k), and a ring deeper than the
    f32 stages' shared memory allows: MAX_DEPTH is the f32 cap too (the
    stages and sums take the same bytes in both types)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 16, generator=g)
    w = torch.randn(16, 16, generator=g)
    nw = torch.ones(16)
    kw = dict(depth=depth, streams=streams)
    calls = ((lambda: ff_layer_matmul(a, w, **kw), ff_layer_matmul_ref(a, w)),
             (lambda: ff_layer_swiglu(a, w, w, **kw),
              ff_layer_swiglu_ref(a, w, w)),
             (lambda: ff_layer_mlp_tail(a, w, a, nw, w, w, w, **kw),
              ff_layer_mlp_tail_ref(a, w, a, nw, w, w, w)))
    for call, want in calls:
        if _pipe_raises(depth, streams) or depth > L.MAX_DEPTH:
            with pytest.raises(ValueError):
                call()
        else:
            assert torch.equal(call(), want)
    assert L._smem_bytes(L.MAX_DEPTH) <= L._MAX_SMEM < L._smem_bytes(
        L.MAX_DEPTH + 1)


def _spy(monkeypatch, name):
    seen = []
    real = getattr(autotune, name)

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((op, kw["depth_cap"], kw["dtype"], choice))
        return choice

    monkeypatch.setattr(autotune, name, spy)
    return seen


def test_policy_plans_f32_layer_calls_under_the_cap(monkeypatch):
    """The pipe policy resolves each f32 call site through the same plan
    as bf16, capped at MAX_DEPTH, with streams the stages take."""
    seen = _spy(monkeypatch, "resolve_call")
    m, hq, d, f = 4, 64, 64, 128
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    with repro_torch.policy(mode="ff"):
        ff_layer_matmul(z(m, d), z(d, hq))
        ff_layer_swiglu(z(m, d), z(d, f), z(d, f))
        ff_layer_mlp_tail(z(m, hq), z(hq, d), z(m, d), torch.ones(d),
                          z(d, f), z(d, f), z(f, d))
    assert [op for op, _, _, _ in seen] == [
        "ff_layer_matmul", "ff_layer_swiglu", "ff_layer_mlp_tail"]
    for _, cap, dt, choice in seen:
        assert dt == F32 and cap == L.MAX_DEPTH
        assert 1 <= choice.depth <= cap
        assert choice.streams in L.stream_options((1, 2, 4, 8, 16))


def test_decode_layer_graph_plans_f32_under_the_cap(monkeypatch):
    """The f32 decode layer resolves one plan for its three launches,
    capped at the shallower of the layer ring's MAX_DEPTH and decode
    attention's f32 ring."""
    seen = _spy(monkeypatch, "resolve_graph")
    g = torch.Generator().manual_seed(1)
    b, h, kvh, hd, d, f, s = 2, 4, 2, 16, 64, 96, 32
    r = lambda *sh: torch.randn(*sh, generator=g) * 0.1  # noqa: E731
    args = (r(b, d), torch.ones(d), r(d, h * hd), None,
            torch.tensor([3, 7]), r(b, kvh, s, hd), r(b, kvh, s, hd),
            torch.tensor([4, 8]), r(h * hd, d), torch.ones(d), r(d, f),
            r(d, f), r(f, d))
    with repro_torch.policy(mode="ff"):
        out = TL.decode_layer(*args, block_kv=16)
    ref = TL.decode_layer_ref(*args)
    (op, cap, dt, choice), = seen
    assert op == "decode_layer" and dt == F32
    assert cap == min(L.MAX_DEPTH, DO.max_depth(hd, F32, h // kvh))
    assert 1 <= choice.depth <= cap
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


PIPES = list(itertools.product([1, 2, 3], [1, 2]))


@pytest.mark.parametrize("depth,streams", PIPES)
def test_f32_matmul_matches_reference_program_at_pipe(depth, streams):
    m, k, n = 8, 200, 136
    rng = np.random.default_rng(300 + depth * 10 + streams)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    prog = build_matmul_program(m, n, k, norm=True, dtype=jnp.float32,
                                depth=depth, streams=streams)
    ref = compile_program(prog, interpret=True)(
        jnp.asarray(a), jnp.asarray(w),
        jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    out = ff_layer_matmul(torch.from_numpy(a), torch.from_numpy(w),
                          norm_weight=torch.from_numpy(nw), depth=depth,
                          streams=streams)
    _close(out, ref)


@pytest.mark.parametrize("depth,streams", PIPES)
def test_f32_swiglu_matches_reference_program_at_pipe(depth, streams):
    m, k, f = 8, 128, 200
    rng = np.random.default_rng(400 + depth * 10 + streams)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wg = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    wu = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    prog = build_swiglu_program(m, f, k, norm=True, dtype=jnp.float32,
                                depth=depth, streams=streams)
    ref = compile_program(prog, interpret=True)(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
        jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    out = ff_layer_swiglu(torch.from_numpy(x), torch.from_numpy(wg),
                          torch.from_numpy(wu),
                          norm_weight=torch.from_numpy(nw), depth=depth,
                          streams=streams)
    _close(out, ref)
