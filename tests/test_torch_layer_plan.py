"""The launch plan and the ring-pipe arguments of the port's decode-layer
kernels (``repro_torch.kernels.ff_layer``), on the CPU.

``_plan`` picks the bf16 launch's 64-column tiles and k split from the
output columns, k and the SM count alone, and the MLP tail's stages take
the plan of the standalone launches at their shapes; the tiles cover every
column once (with RoPE each rotation pair in one tile) and the splits every
k row once. ``depth`` and ``streams`` are checked as the reference's
``Pipe`` checks them. The wrappers' CPU path (the plain version) is held
against the reference's ``build_matmul_program`` / ``build_swiglu_program``
at the same ``depth`` and ``streams`` through ``compile_program`` in
interpret mode, at the tolerances of ``tests/test_torch_ff_layer.py``:
float32 2e-4, bfloat16 2e-2, relative and absolute.
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
from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                          ff_layer_matmul_ref,
                                          ff_layer_mlp_tail,
                                          ff_layer_mlp_tail_ref,
                                          ff_layer_swiglu,
                                          ff_layer_swiglu_ref)
from repro_torch.kernels.ff_layer import ops as L

BF16 = torch.bfloat16
SMS = 132                      # the H100's SM count, passed in
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _record(monkeypatch):
    """Fake the C entries: every launch's (kernel, args) is recorded."""
    seen = []

    def fake_entry(kernel, dtype):
        return lambda *args: seen.append((kernel, args)) or 0

    monkeypatch.setattr(L, "_entry", fake_entry)
    monkeypatch.setattr(L, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(L._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(L, "_TICKETS", {})
    return seen


def _zeros(*shape):
    return torch.zeros(*shape, dtype=BF16)


@pytest.mark.parametrize("m,hq,d,f", [(4, 1024, 1024, 2816), (1, 1024,
                                                              1024, 2816),
                                      (13, 896, 896, 4864), (5, 777, 100,
                                                             3000)])
def test_tail_stages_take_the_standalone_plans(monkeypatch, m, hq, d, f):
    """The tail's three splits are the ones the staged launches get at the
    same shapes, and they depend on (n, k) and the SM count, not on m."""
    seen = _record(monkeypatch)
    a, x = _zeros(m, hq), _zeros(m, d)
    wo, wi, wo2 = _zeros(hq, d), _zeros(d, 2 * f), _zeros(f, d)
    nw = torch.ones(d)
    out, scratch = _zeros(m, d), _zeros(m * (d + f))
    pipe = dict(depth=2, streams=1)
    L._launch_tail(a, wo, x, nw, wi[:, :f], wi[:, f:], wo2, out, scratch,
                   eps=1e-6, **pipe)
    kw = dict(norm_weight=None, eps=1e-6, epilogue="residual", bias=None,
              pos=None, freqs=None, head_dim=None, **pipe)
    L._launch_matmul(a, wo, out, residual=x, **kw)
    L._launch_swiglu(x, wi[:, :f], wi[:, f:], _zeros(m, f), norm_weight=nw,
                     eps=1e-6, **pipe)
    L._launch_matmul(_zeros(m, f), wo2, out, residual=x, **kw)
    L._launch_matmul(_zeros(m + 7, f), wo2, _zeros(m + 7, d),
                     residual=_zeros(m + 7, d), **kw)
    (_, tail), (_, oproj), (_, gateup), (_, down), (_, down_m) = seen
    # tail: (..., depth, streams, split1, split2, split3, ws, tickets,
    # stream); matmul / swiglu: (..., depth, streams, split, ws, tickets,
    # stream)
    splits = tail[-6:-3]
    assert splits == (oproj[-4], gateup[-4], down[-4])
    assert down_m[-4] == down[-4]
    assert splits == (L._plan(d, hq, SMS).split, L._plan(f, d, SMS).split,
                      L._plan(d, f, SMS).split)
    assert tail[-8:-6] == oproj[-6:-4] == gateup[-6:-4] == (2, 1)


def test_serve_shapes_fill_the_sms():
    """qwen1.5-0.5B's decode layer (d 1024, 16 heads of 64, f 2816): every
    projection's tiles x splits puts one item on each SM but fewer than a
    tile's worth (the cooperative tail's grid is one block an SM)."""
    for n, k, want in ((1024, 1024, (16, 8)), (2816, 1024, (44, 3)),
                       (1024, 2816, (16, 8))):
        plan = L._plan(n, k, SMS)
        assert (plan.tiles, plan.split) == want
        assert SMS - plan.tiles < plan.tiles * plan.split <= SMS
    for sms in (114, 80, 16):
        plan = L._plan(1024, 1024, sms)
        assert sms - plan.tiles < plan.tiles * plan.split <= sms


@pytest.mark.parametrize("n,k", [(1, 1), (64, 8192), (5, 3000),
                                 (100000, 16), (1000, 1000), (72, 31),
                                 (8192, 29568), (29568, 8192),
                                 (64, 29568)])
def test_splits_cover_every_row_once_within_the_staging(n, k):
    plan = L._plan(n, k, SMS)
    rows = L._split_rows(k, plan.split)
    assert [r for lo, hi in rows for r in range(lo, hi)] == list(range(k))
    assert all(0 < hi - lo <= L._MAX_SPLIT_ROWS + 8 for lo, hi in rows)
    assert all(lo % 8 == 0 for lo, _ in rows)


@pytest.mark.parametrize("kind,n,k", [("matmul", 8192, 29568),
                                      ("swiglu", 29568, 8192),
                                      ("matmul", 8192, 8192)])
def test_qwen2_72b_tail_widths_fit_the_ring(kind, n, k):
    """qwen2-72b's MLP tail (d 8192, d_ff 29568): every split of k is
    staged within a block's shared memory at the deepest ring, the
    stages' splits cover k once in order, and the workspace and tickets
    are sized; no k is refused."""
    plan = L._plan(n, k, SMS)
    rows = L._split_rows(k, plan.split)
    most = max(hi - lo for lo, hi in rows)
    assert most <= L._MAX_SPLIT_ROWS + 8
    assert L._smem_bytes(L.MAX_DEPTH, most) <= L._MAX_SMEM
    assert rows[0][0] == 0 and rows[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    splits, words, tickets = L.ring_size(4, [(kind, n, k)], SMS)
    assert splits == [plan.split] and tickets == plan.tiles + 2
    assert words == (plan.tiles * plan.split * 4 * L._PARTIAL_COLS[kind]
                     if plan.split > 1 else 0)
    assert not hasattr(L, "_check_k") and not hasattr(L, "_MAX_K")


@pytest.mark.parametrize("n,head_dim", [(1024, None), (1000, None),
                                        (5, None), (1024, 64), (896, 64),
                                        (640, 80), (256, 128), (48, 16)])
def test_tiles_cover_every_column_once(n, head_dim):
    """Every output column in exactly one tile; with RoPE the two columns
    of each rotation pair in the same tile, the second half 32 tile
    columns after the first."""
    tiles = L._plan(n, 1024, SMS).tiles
    cols = [L._tile_columns(n, t, head_dim) for t in range(tiles)]
    flat = [c for tile in cols for c in tile]
    assert sorted(flat) == list(range(n)) and len(set(flat)) == n
    if head_dim is not None:
        half = head_dim // 2
        for tile in cols:
            first, second = tile[:len(tile) // 2], tile[len(tile) // 2:]
            assert [c + half for c in first] == second
            assert all(c % head_dim < half for c in first)


def _pipe_raises(depth, streams, k=16):
    """Does the reference's Pipe refuse these values on the programs'
    activation stream (a tile of 8 rows of k)?"""
    try:
        Pipe(tile=(8, k), dtype=jnp.bfloat16, depth=depth, streams=streams)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams", itertools.product(
    [-1, 0, 1, 2, 4, L.MAX_DEPTH], [-2, 0, 1, 2, 3, 4, 5, 8, 16]))
def test_depth_and_streams_are_checked_as_the_reference_pipe(depth,
                                                              streams):
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
        if _pipe_raises(depth, streams):
            with pytest.raises(ValueError):
                call()
        else:
            assert torch.equal(call(), want)


def test_depth_beyond_shared_memory_raises():
    assert L._smem_bytes(L.MAX_DEPTH) <= L._MAX_SMEM
    assert L._smem_bytes(L.MAX_DEPTH + 1) > L._MAX_SMEM
    # the reference's fixed ring (depth 2, streams 1) fits
    assert L._smem_bytes(2) <= L._MAX_SMEM
    with pytest.raises(ValueError):
        ff_layer_matmul(torch.ones(4, 8), torch.ones(8, 8),
                        depth=L.MAX_DEPTH + 1)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


PIPES = list(itertools.product([1, 2, 4], [1, 2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,streams", PIPES)
def test_matmul_matches_reference_program_at_pipe(dtype, depth, streams):
    m, k, n = 16, 64, 96
    rng = np.random.default_rng(depth * 10 + streams)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    prog = build_matmul_program(m, n, k, norm=True, dtype=jdt, depth=depth,
                                streams=streams)
    ref = compile_program(prog, interpret=True)(
        jnp.asarray(a).astype(jdt), jnp.asarray(w).astype(jdt),
        jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    tdt = getattr(torch, dtype)
    out = ff_layer_matmul(torch.from_numpy(a).to(tdt),
                          torch.from_numpy(w).to(tdt),
                          norm_weight=torch.from_numpy(nw), depth=depth,
                          streams=streams)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth,streams", PIPES)
def test_swiglu_matches_reference_program_at_pipe(dtype, depth, streams):
    m, k, f = 16, 64, 128
    rng = np.random.default_rng(100 + depth * 10 + streams)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wg = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    wu = (rng.standard_normal((k, f)) / np.sqrt(k)).astype(np.float32)
    nw = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    prog = build_swiglu_program(m, f, k, norm=True, dtype=jdt, depth=depth,
                                streams=streams)
    ref = compile_program(prog, interpret=True)(
        jnp.asarray(x).astype(jdt), jnp.asarray(wg).astype(jdt),
        jnp.asarray(wu).astype(jdt),
        jnp.broadcast_to(jnp.asarray(nw)[None], (8, k)))
    tdt = getattr(torch, dtype)
    out = ff_layer_swiglu(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(wg).to(tdt),
                          torch.from_numpy(wu).to(tdt),
                          norm_weight=torch.from_numpy(nw), depth=depth,
                          streams=streams)
    _close(out, ref, dtype)
