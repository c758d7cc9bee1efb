"""The launch plan and the ring-pipe arguments of the port's row gather
(``repro_torch.kernels.ff_gather``), on the CPU.

``_plan`` cuts the gather into words of ``8 * streams`` rows by a slab of
the row (the whole row where ``depth`` stages fit in 227 KB of shared
memory; short rows take a multiple of those rows, up to a 16 KB stage)
and runs one block an SM; ``max_depth`` is the deepest ring that fits.
The plan is held at the qwen1.5-0.5B embedding lookup, the reference
registry's bench shape, the MoE combine (rows of d_ff 2816 in f32, cut
into slabs), the staged paged-decode baseline's 128-byte rows, 128-byte
rows by the million and a 7-element row, at the H100's 132 SMs: the
stages fit, every output row lies in exactly one bundle, and the slabs of
a word cover each row's bytes once. ``depth`` and ``streams`` are checked
as the reference's ``Pipe`` checks them, ``streams`` is clamped as the
reference's ``_apply`` clamps it, and the wrapper's CPU path (the plain
version) equals the reference's ``gather_ff`` in interpret mode exactly
(the reference registry's ``tol=0.0``) at depth {1, 2, 4} x streams {1,
2}, in f32 and bf16.
"""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipe import Pipe
from repro.core.program import PipePolicy
from repro.kernels.ff_gather import ops as RO
from repro.kernels.ff_gather.kernel import build_program, gather_ff
from repro_torch.kernels.ff_gather import gather, max_depth
from repro_torch.kernels.ff_gather import ops as G

SMS = 132                      # the H100's SM count, passed in
# the reference gather_ff's fixed ring (kernel.py:35, :67)
REF_DEPTH, REF_STREAMS = 4, 1
MAX_SMEM = 232448
BF16, F32 = torch.bfloat16, torch.float32
# (label, n, C, dtype)
SHAPES = [("qwen-embedding", 1024, 1024, BF16),
          ("registry-bench", 1 << 20, 512, F32),
          ("moe-combine", 512, 2816, F32),
          ("paged-baseline", 6144, 64, BF16),
          ("short-rows-2^20", 1 << 20, 64, BF16),
          ("row-of-7-f32", 1001, 7, F32),
          ("row-of-7-bf16", 1001, 7, BF16)]
IDS = [x[0] for x in SHAPES]
PIPES = [(d, s) for d in (1, 2, 4) for s in (1, 2)]


def _words(plan, n, row_bytes):
    """Each word's (first row, rows, byte offset, bytes), as the kernel's
    ``Word`` reads them from the plan."""
    w = np.arange(plan.words)
    bundle, sl = w // plan.slabs, w % plan.slabs
    r0 = bundle * plan.rows
    off = sl * plan.slab
    return (r0, np.minimum(plan.rows, n - r0), off,
            np.minimum(plan.slab, row_bytes - off))


def _depths(deepest):
    """Every depth up to ``deepest``, or a spread of them past 64."""
    if deepest <= 64:
        return range(1, deepest + 1)
    return sorted({1, 2, 3, 4, 6, 8, 16, 64, deepest // 2, deepest - 1,
                   deepest})


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("label,n,c,dtype", SHAPES, ids=IDS)
def test_every_depth_up_to_max_depth_fits_and_the_next_raises(label, n, c,
                                                              dtype, streams):
    deepest = max_depth(c, dtype, streams)
    assert deepest >= 6                    # the depth sweep's deepest
    for depth in _depths(deepest):
        plan = G._plan(n, c, dtype, depth, streams, SMS)
        assert plan.rows % (8 * streams) == 0
        assert plan.rows == 8 * streams or plan.stage <= G._STAGE
        assert plan.smem == depth * (plan.stage + 16) <= MAX_SMEM
        assert plan.stage == plan.rows * plan.pitch
        assert plan.pitch % 16 == 0 and plan.slab <= plan.pitch
        assert plan.grid == min(plan.words, SMS)
    with pytest.raises(ValueError, match="max_depth"):
        G._plan(n, c, dtype, deepest + 1, streams, SMS)
    table = torch.zeros(4, c, dtype=dtype)
    with pytest.raises(ValueError, match="max_depth"):
        gather(table, torch.zeros(n, dtype=torch.int32), depth=deepest + 1,
               streams=streams)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("label,n,c,dtype", SHAPES, ids=IDS)
def test_words_hold_every_row_once_and_slabs_cover_it_once(label, n, c,
                                                           dtype, streams):
    row_bytes = c * (2 if dtype == BF16 else 4)
    for depth in sorted({1, REF_DEPTH, max_depth(c, dtype, streams)}):
        plan = G._plan(n, c, dtype, depth, streams, SMS)
        r0, nr, off, length = _words(plan, n, row_bytes)
        assert (nr > 0).all() and (length > 0).all()
        assert plan.words == -(-n // plan.rows) * plan.slabs
        # every row in exactly one bundle: the bundles tile [0, n)
        first = r0[::plan.slabs]
        assert (first == np.arange(0, n, plan.rows)).all()
        assert nr[::plan.slabs].sum() == n
        # a row's slabs tile its bytes in 16-byte-aligned pieces
        offs, lens = off[:plan.slabs], length[:plan.slabs]
        assert offs[0] == 0 and (offs[1:] == offs[:-1] + lens[:-1]).all()
        assert offs[-1] + lens[-1] == row_bytes
        assert (offs % 16 == 0).all()
        # the blocks' strided walks take every word once
        local = [(plan.words - 1 - b) // plan.grid + 1
                 for b in range(plan.grid)]
        assert sum(local) == plan.words


def test_wide_rows_are_cut_into_slabs_only_where_whole_rows_do_not_fit():
    qwen = G._plan(1024, 1024, BF16, REF_DEPTH, 1, SMS)
    assert (qwen.slabs, qwen.slab, qwen.words, qwen.grid) == (1, 2048, 128,
                                                              128)
    bench = G._plan(1 << 20, 512, F32, REF_DEPTH, 1, SMS)
    assert (bench.slabs, bench.words, bench.grid) == (1, 131072, SMS)
    combine = G._plan(512, 2816, F32, REF_DEPTH, 1, SMS)
    assert combine.slabs == 2 and combine.slab == 5632      # d_ff in halves
    assert G._plan(512, 2816, F32, 2, 1, SMS).slabs == 1    # two fit whole
    assert G._plan(512, 2816, F32, max_depth(2816, F32), 1,
                   SMS).slabs == 6
    seven = G._plan(1001, 7, F32, REF_DEPTH, 1, SMS)
    assert (seven.slab, seven.pitch, seven.words) == (28, 32, 126)
    assert G._plan(0, 7, F32, REF_DEPTH, 1, SMS).words == 0


def test_short_rows_take_more_rows_a_word_up_to_a_16_kb_stage():
    """Rows of 2 KB keep the reference's 8 * streams a word; shorter ones
    take a multiple, enough for one word a block (the staged paged
    baseline: 6,144 rows of 128 bytes), at most a 16 KB stage, and no
    more than ``depth`` stages leave room for."""
    paged = G._plan(6144, 64, BF16, REF_DEPTH, 1, SMS)
    assert (paged.rows, paged.stage, paged.words, paged.grid) == (
        48, 6144, 128, 128)
    assert G._plan(6144, 64, BF16, REF_DEPTH, 2, SMS).rows == 48
    many = G._plan(1 << 20, 64, BF16, REF_DEPTH, 1, SMS)
    assert (many.rows, many.stage, many.grid) == (128, 16384, SMS)
    assert G._plan(1 << 20, 4, F32, REF_DEPTH, 1, SMS).rows == 1024
    assert G._plan(1 << 20, 512, F32, REF_DEPTH, 1, SMS).rows == 8
    assert G._plan(6144, 64, BF16, max_depth(64, BF16), 1, SMS).rows == 8
    fewer = G._plan(1001, 7, F32, REF_DEPTH, 1, 40)
    assert (fewer.rows, fewer.words, fewer.grid) == (32, 32, 32)
    assert G._plan(5, 0, F32, REF_DEPTH, 1, SMS).rows == 8


def _pipe_raises(**kw):
    try:
        Pipe(**kw)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams", list(itertools.product(
    (-1, 0, 1, 2, 4), (-1, 0, 1, 2, 3))))
def test_depth_and_streams_checked_as_the_reference_pipe(depth, streams):
    table = torch.zeros(16, 128)
    idx = torch.arange(40, dtype=torch.int32) % 16
    want = _pipe_raises(tile=(8 * max(streams, 1), 128), dtype=jnp.float32,
                        depth=depth, streams=streams)
    if want:
        with pytest.raises(ValueError, match="pipe"):
            gather(table, idx, depth=depth, streams=streams)
    else:
        assert gather(table, idx, depth=depth, streams=streams).shape == (
            40, 128)


def test_defaults_are_the_reference_kernels():
    for fn in (gather_ff, build_program):
        params = inspect.signature(fn).parameters
        assert (params["depth"].default, params["streams"].default) == (
            REF_DEPTH, REF_STREAMS)
    # the entry point sizes its ring by the pipe policy: its keywords
    # default to None (planned), and the reference's defaults pinned
    # through them give the same rows
    params = inspect.signature(gather).parameters
    assert (params["depth"].default, params["streams"].default) == (
        None, None)
    table = torch.arange(64.0).view(16, 4)
    idx = torch.tensor([3, 1, 15, 0] * 5, dtype=torch.int32)
    assert torch.equal(gather(table, idx, depth=REF_DEPTH,
                              streams=REF_STREAMS), gather(table, idx))


def test_streams_clamped_as_the_reference_apply(monkeypatch):
    """The streams the reference's ``_apply`` hands its kernel, recorded,
    against the rows of the port's word."""
    seen = []

    def record(table, idx, **kw):
        seen.append(kw["streams"])
        return jnp.zeros((idx.shape[0], table.shape[1]), table.dtype)

    monkeypatch.setattr(RO, "gather_ff", record)
    table = jnp.zeros((96, 16), jnp.float32)
    for streams, n in itertools.product((1, 2, 3, 4, 8, 100),
                                        (1, 3, 8, 20, 52, 300)):
        RO._apply(table, jnp.zeros((n,), jnp.int32),
                  policy=PipePolicy(mode="ff", depth=2, streams=streams,
                                    interpret=True))
        plan = G._plan(n, 16, F32, 2, streams, SMS)
        assert plan.rows == 8 * seen[-1], (streams, n)


def test_the_launch_passes_the_plan_and_the_widest_unit(monkeypatch):
    """The C entry's arguments, recorded with CPU tensors: the plan, the
    depth, and 16-byte units (cp.async) only where the row and both
    pointers allow them."""
    seen = []
    monkeypatch.setattr(G, "_entry",
                        lambda: lambda *args: seen.append(args) or 0)
    monkeypatch.setattr(G._build, "stream_ptr", lambda device: 0)
    for c, dtype, cut, unit in ((512, F32, 0, 16), (7, F32, 0, 4),
                                (7, BF16, 0, 2), (6, F32, 1, 8),
                                (2816, F32, 0, 16)):
        table = torch.zeros(9, c, dtype=dtype)[cut:]
        idx = torch.arange(21, dtype=torch.int32) % 8
        out = torch.empty(21, c, dtype=dtype)
        plan = G._plan(21, c, dtype, 3, 2, SMS)
        G._launch(table, idx, out, plan, 3)
        args = seen[-1]
        assert args[3:5] == (21, c * table.element_size())
        assert args[5:-1] == (plan.rows, plan.slab, plan.slabs, plan.pitch,
                              plan.words, 3, plan.grid, unit)


def _case(seed, dtype, rows=96, c=32, n=52):
    """A numpy-seeded table and n indices (repeats, no order), for both."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, c)).astype(np.float32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    idx[:4] = [rows - 1, 0, rows - 1, 0]
    t = torch.from_numpy(table).to(dtype)
    jt = jnp.asarray(t.float().numpy(), jnp.float32 if dtype == F32
                     else jnp.bfloat16)
    return t, torch.from_numpy(idx), jt, idx


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("depth,streams", PIPES)
def test_cpu_path_equals_the_reference_kernel_exactly(dtype, depth, streams):
    """The reference's ``gather_ff`` in interpret mode on ``idx`` padded to
    its bundle as ``_apply`` pads it, its first n rows; the port takes the
    ragged n as it is."""
    t, idx, jt, np_idx = _case(11, dtype)
    n = idx.shape[0]
    eff = G._plan(n, t.shape[1], dtype, depth, streams, SMS).rows // 8
    bundle = 8 * eff
    padded = np.pad(np_idx, (0, (-n) % bundle))
    ref = gather_ff(jt, jnp.asarray(padded), depth=depth, streams=eff,
                    interpret=True)[:n]
    out = gather(t, idx, depth=depth, streams=streams)
    assert out.dtype == dtype and out.shape == (n, t.shape[1])
    assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_an_empty_index_gives_an_empty_result():
    out = gather(torch.zeros(5, 7), torch.zeros(0, dtype=torch.int32),
                 depth=2, streams=2)
    assert out.shape == (0, 7)
