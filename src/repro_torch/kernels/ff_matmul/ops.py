"""Tiled matmul and the MoE dispatch->expert launch: wrappers, plain
versions, launch counts.

Replaces the TPU kernel ``repro/kernels/ff_matmul/kernel.py``
(``build_program`` / ``matmul_ff``, wrapper ``ops.py:_apply``) and, in
:func:`dispatch_matmul`, the dispatch->expert edge of the
``moe_dispatch_ffn`` StreamGraph (``repro/models/moe.py:build_moe_graph``:
``ff_gather`` fused into the expert matmul's A stream). Both are one
templated kernel in ``csrc/ff_matmul.cu``; its note says what bounds it
on the H100, which type pairs take the tensor cores, and why the
gathered launch equals ``gather`` then ``matmul`` bit for bit.

``depth`` and ``streams`` are the reference's ``matmul_ff`` keywords: the
stages of the shared-memory ring that feeds the product (the tensor cores
for bf16 x bf16, the CUDA cores for the other pairs, each with its own
tiles and so its own deepest ring and stream counts), and the sub-copies
each tile copy is split into (``depth=1`` is the synchronous
copy-then-compute baseline). :func:`_plan` picks the path, tile and k
split from the shapes and types alone. :func:`matmul` resolves
``depth``/``streams`` through the pipe policy as the kernel ``ff_matmul``
(:func:`matmul_workload`); :func:`dispatch_matmul` is the dispatch edge of
the ``moe_dispatch_ffn`` graph, which resolves its plan
(``repro_torch.models.moe``) and hands it down in ``policy``.
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
from repro_torch.kernels.ff_gather.ops import check_gather_inputs, gather_ref
from repro_torch.kernels.registry import KernelCost, register_kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID_Y = 65535
# both rings (csrc/ff_matmul.cu): 128 x 128 output tiles. bf16 x bf16 on
# the tensor cores takes 64-deep k slabs, a stage holding an A tile [128,
# 64] and a B tile [64, 128]; every other pair on the CUDA cores takes
# 32-deep slabs, a stage holding A [128, 32] and B [32, 128], each in its
# own type
_WG_TILE = (128, 128, 64)
_FMA_TILE = (128, 128, 32)
# the CUDA cores' tile where 128 x 128 tiles would leave SMs idle: 64 x 64
# outputs a block (4 x 4 a thread) on the same stages
_FMA_SMALL_TILE = (64, 64, 32)
_MAX_SMEM = 232448                  # 227 KB of shared memory a block
# the least rows of a sub-copy of A's tile and of B's: one 128-byte
# swizzle atom (8 rows) where the tile may be swizzled, one row where it
# lies row-major (the CUDA cores' B tiles)
_MIN_STREAM_ROWS = {"wgmma": (8, 8), "fma": (8, 1)}
# k up to the attention's largest head dim is never split, so the
# attention_proj launch (which does not split) equals its staged matmul
_NO_SPLIT_K = 256


class Plan(NamedTuple):
    path: str                       # "wgmma" (tensor cores) or "fma"
    tile: Tuple[int, int, int]      # (rows, columns, k slab) of a block
    split: int                      # k split over this many blocks


def _path(a_dtype, b_dtype=None) -> str:
    b_dtype = b_dtype or a_dtype
    return "wgmma" if a_dtype == b_dtype == torch.bfloat16 else "fma"


def _plan(m, n, k, a_dtype, b_dtype, sm_count) -> Plan:
    """The launch's path, tile and k split, from (m, n, k), the operand
    types and the SM count alone: a gathered and a plain launch at the
    same shape get the same plan, so they sum in the same order. bf16 x
    bf16 takes the tensor cores; when its output tiles are fewer than the
    SMs, k is split so the launch fills them (at least two slabs a split,
    and never for k <= 256). Every other pair takes the CUDA cores,
    unsplit (every output one fmaf chain over k), in 128 x 128 tiles, or
    64 x 64 where those are fewer than the SMs."""
    bm, bn, bk = _WG_TILE
    tiles = -(-m // bm) * -(-n // bn)
    if _path(a_dtype, b_dtype) == "fma":
        return Plan("fma", _FMA_TILE if tiles >= sm_count
                    else _FMA_SMALL_TILE, 1)
    split = 1
    if k > _NO_SPLIT_K and tiles < sm_count:
        split = max(1, min(-(-sm_count // tiles), -(-k // bk) // 2))
    return Plan("wgmma", _WG_TILE, split)


def _stage_bytes(a_dtype=torch.bfloat16, b_dtype=None) -> int:
    """One ring stage: the A tile and the B tile of a k slab, each in its
    own type."""
    b_dtype = b_dtype or a_dtype
    bm, bn, bk = _WG_TILE if _path(a_dtype, b_dtype) == "wgmma" \
        else _FMA_TILE
    return bm * bk * itemsize(a_dtype) + bk * bn * itemsize(b_dtype)


def _smem_bytes(depth: int, a_dtype=torch.bfloat16, b_dtype=None) -> int:
    """Shared memory of a ring of ``depth`` stages (csrc/ff_matmul.cu
    smem_bytes, fma_smem_bytes): 1024 bytes of alignment slack, the
    stages, two mbarriers a stage, the tile's 128 row offsets. The same
    for bf16 x bf16 and f32 x f32 (32 KB stages); 24 KB stages where one
    operand of an f32 product is bf16."""
    return 1024 + depth * _stage_bytes(a_dtype, b_dtype) + 16 * depth \
        + 8 * _WG_TILE[0]


def max_depth(a_dtype=torch.bfloat16, b_dtype=None) -> int:
    """The deepest ring of the path these operand types take that fits
    one block's shared memory."""
    return max(d for d in range(1, 64)
               if _smem_bytes(d, a_dtype, b_dtype) <= _MAX_SMEM)


MAX_DEPTH = max_depth()


def _tile_rows(path: str) -> Tuple[int, int]:
    """The leading dims ``streams`` splits: A's rows, B's k rows."""
    bm, _, bk = _WG_TILE if path == "wgmma" else _FMA_TILE
    return bm, bk


def stream_options(options, a_dtype=torch.bfloat16, b_dtype=None) -> tuple:
    """The stream counts of ``options`` the path these operand types take
    can run: those that split both tiles' leading dims (128 and 64 rows on
    the tensor cores, 128 and 32 on the CUDA cores) into sub-copies of at
    least their tile's least rows."""
    path = _path(a_dtype, b_dtype)
    return tuple(s for s in options
                 if all(r % s == 0 and r // s >= least for r, least in
                        zip(_tile_rows(path), _MIN_STREAM_ROWS[path])))


def _pipe(depth, streams, a_dtype=torch.bfloat16, b_dtype=None
          ) -> Tuple[int, int]:
    """``depth`` and ``streams`` checked as the reference's ``Pipe`` checks
    them against the tiles of the path these operand types take: each at
    least 1, ``streams`` dividing the leading dimension of both tiles (A's
    128 rows, B's 64 k rows on the tensor cores or 32 on the CUDA cores)
    into sub-copies of at least the tile's least rows (a swizzled tile's
    8, one swizzle atom), and ``depth`` stages fitting in shared
    memory."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    path = _path(a_dtype, b_dtype)
    for rows, least in zip(_tile_rows(path), _MIN_STREAM_ROWS[path]):
        if rows % streams or rows // streams < least:
            raise ValueError(f"streams={streams} must split the tile's "
                             f"{rows} rows into sub-copies of at least "
                             f"{least} rows")
    deepest = max_depth(a_dtype, b_dtype)
    if depth > deepest:
        raise ValueError(f"depth {depth} needs "
                         f"{_smem_bytes(depth, a_dtype, b_dtype)} bytes of "
                         f"shared memory; at most {deepest} stages fit in "
                         f"{_MAX_SMEM}")
    return depth, streams


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def matmul_workload(m: int, n: int, k: int, *, dtype=torch.bfloat16,
                    b_dtype=None, out_dtype=None
                    ) -> Tuple[Workload, Tuple[int, int]]:
    """The kernel's stream program in pipe words: one word per (mi, ni,
    ki) step of its own tile, an A tile and a B tile. The reference's
    words are (128, 128, 128) blocks; the port's are the tile its path
    runs: (128, 128, 64) on the tensor cores (bf16 x bf16), (128, 128, 32)
    on the CUDA cores. C is written once, spread over the k steps.
    Planning tile = the A tile."""
    b_dtype = b_dtype or dtype
    out_dtype = out_dtype or dtype
    bm, bn, bk = (_WG_TILE if _path(dtype, b_dtype) == "wgmma"
                  else _FMA_TILE)
    nm, nn, nk = -(-m // bm), -(-n // bn), max(-(-k // bk), 1)
    w = Workload(
        n_words=max(nm * nn * nk, 1),
        word_bytes=float(bm * bk * itemsize(dtype)
                         + bk * bn * itemsize(b_dtype)),
        flops_per_word=2.0 * bm * bn * bk,
        regular=True,
        store_bytes_per_word=float(bm * bn * itemsize(out_dtype)) / nk,
    )
    return w, (bm, bk)


def matmul_cost(m: int, n: int, k: int, *, dtype=torch.bfloat16,
                depth: int = 2) -> KernelCost:
    """Operations and bytes by the kernel's tiles: A re-read once per
    column tile, B once per row tile, C written once; shared memory the
    ring of ``depth`` stages of the path ``dtype`` takes."""
    w, (bm, bk) = matmul_workload(m, n, k, dtype=dtype)
    bn = _WG_TILE[1]                    # both paths' tiles are 128 wide
    item = itemsize(dtype)
    nm, nn = -(-m // bm), -(-n // bn)
    hbm = (m * k * nn + k * n * nm + m * n) * item
    return KernelCost(flops=2.0 * m * n * k, hbm_bytes=float(hbm),
                      smem_bytes=_smem_bytes(depth, dtype))


def resolve_pipe(op: str, policy, a, b, m: int, out_dtype, run, *,
                 site=None) -> Tuple[int, int]:
    """(depth, streams) of one product launch under ``policy``, within
    the ring of the path the operand types take."""
    n, k = b.shape[1], b.shape[0]
    so = stream_options(policy.stream_options, a.dtype, b.dtype)
    pol = policy if so == tuple(policy.stream_options) else \
        policy.replace(stream_options=so)
    w, tile = matmul_workload(m, n, k, dtype=a.dtype, b_dtype=b.dtype,
                              out_dtype=out_dtype)
    choice = autotune.resolve_call(
        op, pol, workload=w, tile=tile, dtype=a.dtype,
        workload_fn=lambda tk: (w, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(dep, st),
        extra_key="" if out_dtype == a.dtype else
        f"out={str(out_dtype).replace('torch.', '')}",
        site=site or {"m": m, "n": n, "k": k},
        site_dynamic=("m", "n", "k"),
        depth_cap=max_depth(a.dtype, b.dtype))
    return _pipe(choice.depth, choice.streams, a.dtype, b.dtype)


def matmul_ref(a, b, out_dtype=None) -> torch.Tensor:
    """Plain version of the kernel: the product in f32, rounded once to
    ``out_dtype`` (default: A's type)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def dispatch_matmul_ref(tokens, idx, b) -> torch.Tensor:
    """Plain version of the gathered launch: ``matmul_ref(tokens[idx], b)``."""
    return matmul_ref(gather_ref(tokens, idx), b)


@functools.lru_cache(maxsize=None)
def _entry(path: str, ta, tb, to):
    """ff_matmul_wgmma_<out> (bf16 x bf16) and ff_matmul_fma_<A>_<B>_<out>
    (the other pairs); both take a row index (null: plain), the ring's
    depth and streams, the wgmma entry also a k split and its workspace,
    the fma entry its tile."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if path == "wgmma":
        name = f"ff_matmul_wgmma_{_SUFFIX[to]}"
        args = [p, p, p, p, p, i, i, i, ll, ll, ll, i, i, i, p]
    else:
        name = f"ff_matmul_fma_{_SUFFIX[ta]}_{_SUFFIX[tb]}_{_SUFFIX[to]}"
        args = [p, p, p, p, i, i, i, ll, ll, ll, i, i, i, p]
    return _build.bind("ff_matmul", name, args)


def _check(a, b, out_dtype):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul wants a [m, k] and b [k, n]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    for t in (a.dtype, b.dtype, out_dtype):
        if t not in _SUFFIX:
            raise TypeError(f"matmul takes float32 or bfloat16 operands "
                            f"and output, not {t}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul runs on cpu or cuda, not {a.device}")


def _rows_contiguous(x):
    return x if x.stride(1) == 1 else x.contiguous()


def _launch(a, rows, b, m, out_dtype, depth, streams):
    a, b = _rows_contiguous(a), _rows_contiguous(b)
    n, k = b.shape[1], b.shape[0]
    plan = _plan(m, n, k, a.dtype, b.dtype, _sm_count(a.device.index))
    if -(-m // plan.tile[0]) > _MAX_GRID_Y:
        raise ValueError(f"matmul takes at most {_MAX_GRID_Y * plan.tile[0]}"
                         f" rows, got {m}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    entry = _entry(plan.path, a.dtype, b.dtype, out_dtype)
    stream = _build.stream_ptr(a.device)
    row_ptr = rows.data_ptr() if rows is not None else None
    if plan.path == "wgmma":
        ws = (torch.empty((plan.split, m, n), dtype=torch.float32,
                          device=a.device) if plan.split > 1 else None)
        rc = entry(a.data_ptr(), row_ptr, b.data_ptr(), out.data_ptr(),
                   ws.data_ptr() if ws is not None else None, m, n, k,
                   a.stride(0), b.stride(0), out.stride(0), depth, streams,
                   plan.split, stream)
    else:
        rc = entry(a.data_ptr(), row_ptr, b.data_ptr(), out.data_ptr(), m, n,
                   k, a.stride(0), b.stride(0), out.stride(0), depth,
                   streams, plan.tile[0], stream)
    _build.check("ff_matmul", "ff_matmul", rc)
    return out


def _apply(a, b, *, out_dtype=None, policy: PipePolicy) -> torch.Tensor:
    """C = A @ B with f32 accumulation: a [m, k] and b [k, n], each float32
    or bfloat16 (separately); the output is ``out_dtype`` (default: A's
    type), as the reference's. Any m, n, k. The ring that feeds the
    product is sized by ``policy`` within the ring of the path the types
    take; it does not change the result. mode="ref" and CPU tensors run :func:`matmul_ref`; CUDA
    tensors launch the kernel (f32 operands stay f32: no TF32)."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if policy.mode == "ref":
        return matmul_ref(a, b, out_dtype)

    def run(depth, streams):
        if a.device.type == "cpu":
            return matmul_ref(a, b, out_dtype)
        return _launch(a, None, b, a.shape[0], out_dtype, depth, streams)

    out = run(*resolve_pipe("ff_matmul", policy, a, b, a.shape[0],
                            out_dtype, run))
    if a.device.type == "cuda":
        matmul.launches += 1
    return out


matmul = make_entrypoint("ff_matmul", _apply, name="matmul")


def _apply_dispatch(tokens, idx, b, *, policy: PipePolicy) -> torch.Tensor:
    """``tokens[idx] @ b`` in one launch, the rows of A read through
    ``idx`` (the dispatched buffer is never written): tokens [T, k], idx
    [n] int32 or int64 with every index in ``[0, T)`` (unchecked on the
    card, as :func:`repro_torch.kernels.ff_gather.gather`), b [k, d_ff] of
    the tokens' type. Returns [n, d_ff] in the tokens' type, equal bit for
    bit to ``matmul(gather(tokens, idx), b)`` at any ``depth`` and
    ``streams`` (as :func:`matmul`'s), which ``policy`` sizes as the op
    ``ff_dispatch_matmul`` (the ``moe_dispatch_ffn`` graph passes its
    plan's ints). mode="ref" and CPU tensors run
    :func:`dispatch_matmul_ref`; CUDA tensors launch the kernel."""
    check_gather_inputs(tokens, idx)
    _check(tokens, b, tokens.dtype)
    if b.dtype != tokens.dtype:
        raise TypeError(f"dispatch_matmul wants b of the tokens' type "
                        f"{tokens.dtype}, not {b.dtype}")
    if policy.mode == "ref":
        return dispatch_matmul_ref(tokens, idx, b)

    def run(depth, streams):
        if tokens.device.type == "cpu":
            return dispatch_matmul_ref(tokens, idx, b)
        return _launch(tokens, idx.to(torch.int32).contiguous(), b,
                       idx.shape[0], tokens.dtype, depth, streams)

    n = idx.shape[0]
    site = {"t": tokens.shape[0], "n": n, "k": b.shape[0], "f": b.shape[1]}
    out = run(*resolve_pipe("ff_dispatch_matmul", policy, tokens, b, n,
                            tokens.dtype, run, site=site))
    if tokens.device.type == "cuda":
        dispatch_matmul.launches += 1
    return out


dispatch_matmul = make_entrypoint("ff_dispatch_matmul", _apply_dispatch,
                                  name="dispatch_matmul")


def _make_inputs(gen, device):
    a = torch.randn((192, 136), generator=gen, device=device)
    b = torch.randn((136, 160), generator=gen, device=device)
    return (a, b), {}


def _sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep)
    m, n, k = int(site["m"]), int(site["n"]), int(site["k"])
    dt = getattr(torch, site.get("dtype", "float32"))
    a = torch.randn((m, k), generator=gen, device=device).to(dt)
    b = torch.randn((k, n), generator=gen, device=device).to(dt)
    return (a, b), {}


# no tile knob: _plan fixes the path, tile and k split from the shapes and
# types, so the tuner searches (depth, streams) only
_TILE_OPTIONS = ()

register_kernel(
    name="ff_matmul",
    alias="matmul",
    op=matmul,
    ref=matmul_ref,
    cost=matmul_cost,
    workload=matmul_workload,
    make_inputs=_make_inputs,
    bench_kwargs={"m": 4096, "n": 4096, "k": 4096, "dtype": torch.bfloat16},
    tile_options=_TILE_OPTIONS,
    regular=True,
    tol=5e-4,
    doc="tiled product, fed by the shared-memory ring",
    shard_dims=(0, None),        # A rows data-parallel, B replicated
    shard_out_dim=0,
    sweep_inputs=_sweep_inputs,
)
