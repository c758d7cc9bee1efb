"""Row gather: wrapper, plain version, launch plan, launch count.

Replaces the TPU kernel ``repro/kernels/ff_gather/kernel.py``
(``build_program`` / ``gather_ff``, wrapper ``ops.py:_apply``). The CUDA
kernel is ``csrc/ff_gather.cu``, the reference's words on the port's ring
pipe (``csrc/ring_pipe.cuh``); its note says what bounds it on the H100
and what ``depth`` can hide.

A word is ``8 * streams`` output rows (the reference's ``_ROWS *
streams``) over a slab of the row; :func:`_plan` cuts a row into slabs
only where ``depth`` stages of whole rows do not fit in shared memory,
gives rows shorter than 2 KB a multiple of that a word (up to a 16 KB
stage), and runs one block an SM, each walking its words through a ring
of ``depth`` stages (``depth = 1``: the synchronous baseline). ``depth``
and ``streams`` never change a bit; :func:`gather` resolves them through
the pipe policy as the kernel ``ff_gather`` with the reference's
workload (:func:`gather_workload`: words of 8 rows, irregular), its
stream options clamped to the rows ``n`` fills as the reference's
``_apply`` clamps them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.pipe import itemsize
from repro_torch.core.pipeline_model import Workload
from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels import _build
from repro_torch.kernels.registry import KernelCost, register_kernel

_DTYPES = (torch.float32, torch.bfloat16)
_UNITS = (16, 8, 4, 2)          # copy units of the kernel, in bytes
_ROWS = 8                       # rows of a word a stream (kernel.py _ROWS)
_MAX_SMEM = 232448              # 227 KB of shared memory a block
_BARRIERS = 16                  # bytes a stage: its full and empty mbarriers
_MIN_SLAB = 2048                # bytes: a row is cut no finer (or whole)
_STAGE = 16384                  # bytes a stage of short rows grows to: 8
                                # rows of 2 KB, the reference's word there


class Plan(NamedTuple):
    rows: int                   # output rows a word: 8 * streams
    slab: int                   # bytes of a row a word carries (the last
    slabs: int                  # slab of a row may be shorter); slabs a row
    pitch: int                  # bytes a row takes in a stage
    stage: int                  # bytes of a stage: rows * pitch
    words: int                  # bundles of rows x slabs
    grid: int                   # blocks of the launch
    smem: int                   # shared bytes a block: the stages, barriers


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _streams(n: int, streams: int) -> int:
    """``streams`` as the reference's ``_apply`` clamps it (ops.py:68): a
    word no wider than the rows the index stream can fill."""
    return max(1, min(streams, n // _ROWS))


def _fits(depth: int, rows: int, pitch: int) -> bool:
    return depth * (rows * pitch + _BARRIERS) <= _MAX_SMEM


def max_depth(c: int, dtype: torch.dtype,
              streams: int = 1) -> int:
    """The deepest ring that fits one block's shared memory for rows of
    ``c`` elements at ``streams`` (as the launch uses it, after the
    clamp): ``depth`` stages of ``8 * streams`` rows of the smallest slab
    (the whole row, or 2 KB of it)."""
    pitch = min(_pad16(c * _item(dtype)), _MIN_SLAB)
    rows = _ROWS * streams
    return _MAX_SMEM // (rows * pitch + _BARRIERS)


def _item(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 2


def _plan(n: int, c: int, dtype: torch.dtype, depth: int, streams: int,
          sms: int) -> Plan:
    """The launch: words of ``8 * streams`` rows (``streams`` clamped as
    the reference clamps it) by a slab of the row. The slab is the whole
    row where ``depth`` stages fit in 227 KB, else the row is cut into
    the fewest equal slabs of 16-byte multiples that fit; raises
    ``ValueError`` naming :func:`max_depth` where not even a 2 KB slab
    (or the whole row, if shorter) fits. A stage of whole rows under
    ``_STAGE`` bytes takes a multiple of those rows: enough that the
    words spread over the ``sms`` blocks one each, at most a ``_STAGE``
    stage, and still ``depth`` stages that fit (a stage pays a ring round
    trip however few bytes it holds). One block an SM, never more than
    one a word."""
    rows = _ROWS * _streams(n, streams)
    row_bytes = c * _item(dtype)
    full = _pad16(row_bytes)
    least = min(full, _MIN_SLAB)
    if _fits(depth, rows, full):
        slab = row_bytes
        word = rows * full
        if word:
            rows *= max(1, min(-(-n // (sms * rows)), _STAGE // word,
                               (_MAX_SMEM // depth - _BARRIERS) // word))
    elif _fits(depth, rows, least):
        cap = (_MAX_SMEM // depth - _BARRIERS) // rows // 16 * 16
        slab = _pad16(-(-row_bytes // -(-row_bytes // cap)))
    else:
        raise ValueError(
            f"depth {depth} with words of {rows} rows of {c} {dtype} "
            f"elements needs {depth * (rows * least + _BARRIERS)} bytes of "
            f"shared memory; at most max_depth="
            f"{max_depth(c, dtype, rows // _ROWS)} stages fit in {_MAX_SMEM}")
    slabs = -(-row_bytes // slab) if row_bytes else 1
    pitch = _pad16(slab)
    words = -(-n // rows) * slabs
    blocks = min(words, sms)
    return Plan(rows, slab, slabs, pitch, rows * pitch, words, blocks,
                depth * (rows * pitch + _BARRIERS))


def _check_pipe(depth: int, streams: int) -> None:
    """``depth`` and ``streams`` checked as the reference's ``Pipe``
    checks them (core/pipe.py:54-57)."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")


def gather_ref(table, idx) -> torch.Tensor:
    """Plain version of the kernel: ``table[idx]`` through
    ``index_select``, which raises ``IndexError`` on an index outside
    ``[0, R)`` (negative ones included: they do not wrap)."""
    return torch.index_select(table, 0, idx.long())


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ff_gather", "ff_gather",
                       [p, p, p, i, ctypes.c_longlong, i, i, i, i, i, i, i,
                        i, p])


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SM count of card ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_gather_inputs(table, idx) -> None:
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather wants table [R, C] and idx [n]; got "
                         f"{tuple(table.shape)}, {tuple(idx.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"gather takes a float32 or bfloat16 table, not "
                        f"{table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather takes int32 or int64 indices, not "
                        f"{idx.dtype}")
    if table.device != idx.device:
        raise ValueError("table and idx must be on one device")


def gather_workload(n: int, cols: int, *, dtype=torch.float32
                    ) -> Tuple[Workload, Tuple[int, int]]:
    """The reference's workload, word for word: one word per 8-row bundle
    of irregular single-row loads (latency per word, hidden by (depth-1) x
    rows outstanding row copies), each row read and written once. The
    port's word is the same bundle (8 * streams rows); rows under 2 KB take
    a multiple of it (:func:`_plan`), which the planner does not see."""
    item = itemsize(dtype)
    w = Workload(
        n_words=max(-(-n // _ROWS), 1),
        word_bytes=float(_ROWS * cols * item),
        flops_per_word=0.0,
        regular=False,
        store_bytes_per_word=float(_ROWS * cols * item),
    )
    return w, (_ROWS, cols)


def gather_cost(n: int, cols: int, *, depth: int = 4,
                dtype=torch.float32) -> KernelCost:
    item = itemsize(dtype)
    return KernelCost(flops=0.0,
                      hbm_bytes=float(2 * n * cols * item + n * 4),
                      smem_bytes=depth * (_ROWS * _pad16(cols * item)
                                          + _BARRIERS))


def _apply(table, idx, *, policy: PipePolicy) -> torch.Tensor:
    """``table[idx]``: table [R, C] float32 or bfloat16, idx [n] int32 or
    int64, any n. Returns [n, C], an exact copy of the indexed rows.

    The ring (``depth`` stages of words of ``8 * streams`` rows,
    ``streams`` clamped to the rows ``n`` fills) is sized by ``policy``;
    explicit values must be at least 1 and fit (:func:`max_depth`).
    Neither changes a bit.

    Every index must lie in ``[0, R)``: the plain version raises
    ``IndexError`` outside it (a negative index too), the kernel does not
    check (that would cost a host sync per call) and reads whatever lies
    there. mode="ref" and CPU tensors run :func:`gather_ref`; CUDA tensors
    launch the kernel (none for n = 0 or C = 0)."""
    check_gather_inputs(table, idx)
    if policy.mode == "ref":
        return gather_ref(table, idx)
    n, c = idx.shape[0], table.shape[1]
    cuda = table.device.type == "cuda"
    if not cuda and table.device.type != "cpu":
        raise ValueError(f"gather runs on cpu or cuda, not {table.device}")

    def run(depth, streams):
        _check_pipe(depth, streams)
        plan = _plan(n, c, table.dtype, depth, streams,
                     _sms(table.device.index) if cuda else 1)
        if not cuda:
            return gather_ref(table, idx), False
        out = torch.empty((n, c), dtype=table.dtype, device=table.device)
        if n == 0 or c == 0:
            return out, False
        tab = table if table.stride(1) == 1 and table.stride(0) == c \
            else table.contiguous()
        _launch(tab, idx.to(torch.int32).contiguous(), out, plan, depth)
        return out, True

    # the tuner's streams: those the index stream can fill, as the
    # reference's _apply clamps them
    so = tuple(sorted({_streams(n, int(s)) for s in policy.stream_options}))
    pol = policy if so == tuple(policy.stream_options) \
        else policy.replace(stream_options=so)
    w, tile = gather_workload(n, c, dtype=table.dtype)
    choice = autotune.resolve_call(
        "ff_gather", pol, workload=w, tile=tile, dtype=table.dtype,
        workload_fn=lambda tk: (w, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(dep, st),
        site={"rows": table.shape[0], "cols": c, "n": n},
        site_dynamic=("rows", "n"),
        depth_cap=max(1, min(max_depth(c, table.dtype, s) for s in so)))
    out, launched = run(choice.depth, choice.streams)
    if launched:
        gather.launches += 1
    return out


gather = make_entrypoint("ff_gather", _apply, name="gather")


def _launch(table, idx, out, plan: Plan, depth: int) -> None:
    """Call the C entry: contiguous ``table``, int32 ``idx``, ``out`` [n,
    C], copied in the largest unit of 16, 8, 4 or 2 bytes that divides the
    row and both base pointers (16: cp.async)."""
    n = idx.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    unit = next(u for u in _UNITS if row_bytes % u == 0
                and table.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    rc = _entry()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                  row_bytes, plan.rows, plan.slab, plan.slabs, plan.pitch,
                  plan.words, depth, plan.grid, unit,
                  _build.stream_ptr(table.device))
    _build.check("ff_gather", "ff_gather", rc)


def _make_inputs(gen, device):
    tab = torch.randn((96, 128), generator=gen, device=device)
    idx = torch.randint(0, 96, (52,), generator=gen, device=device)
    return (tab, idx), {}


def _sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep)
    rows, cols, n = int(site["rows"]), int(site["cols"]), int(site["n"])
    dt = getattr(torch, site.get("dtype", "float32"))
    tab = torch.randn((rows, cols), generator=gen, device=device).to(dt)
    idx = torch.randint(0, rows, (n,), generator=gen, device=device)
    return (tab, idx), {}


register_kernel(
    name="ff_gather",
    alias="gather",
    op=gather,
    ref=gather_ref,
    cost=gather_cost,
    workload=gather_workload,
    make_inputs=_make_inputs,
    bench_kwargs={"n": 1 << 20, "cols": 512, "dtype": torch.float32},
    # no tile knob: the 8 * streams row bundle is the tile
    tile_options=(),
    regular=False,
    tol=0.0,
    doc="irregular row gather (embedding / MoE dispatch)",
    shard_dims=(None, 0),        # table replicated, index rows split
    shard_out_dim=0,
    sweep_inputs=_sweep_inputs,
)
