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
stages of the shared-memory ring that feeds the tensor cores, and the
sub-copies each tile copy is split into (``depth=1`` is the synchronous
copy-then-compute baseline). :func:`_plan` picks the path, tile and k
split from the shapes and types alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ff_gather.ops import check_gather_inputs, gather_ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID_Y = 65535
# the bf16 ring (csrc/ff_matmul.cu): 128 x 128 output tiles, 64-deep k
# slabs, a stage holding an A tile [128, 64] and a B tile [64, 128]
_WG_TILE = (128, 128, 64)
_FMA_TILE = (64, 64, 16)
_STAGE_BYTES = (128 * 64 + 64 * 128) * 2
_MAX_SMEM = 232448                  # 227 KB of shared memory a block
_MIN_STREAM_ROWS = 8                # one 128-byte swizzle atom of rows
# k up to the attention's largest head dim is never split, so the
# attention_proj launch (which does not split) equals its staged matmul
_NO_SPLIT_K = 256
# depth 3 leaves room for two blocks on an SM (PERF.md, depth sweep)
DEFAULT_DEPTH = 3
DEFAULT_STREAMS = 1


class Plan(NamedTuple):
    path: str                       # "wgmma" (tensor cores) or "fma"
    tile: Tuple[int, int, int]      # (rows, columns, k slab) of a block
    split: int                      # k split over this many blocks


def _plan(m, n, k, a_dtype, b_dtype, sm_count) -> Plan:
    """The launch's path, tile and k split, from (m, n, k), the operand
    types and the SM count alone: a gathered and a plain launch at the
    same shape get the same plan, so they sum in the same order. bf16 x
    bf16 takes the tensor cores; when its output tiles are fewer than the
    SMs, k is split so the launch fills them (at least two slabs a split,
    and never for k <= 256). Every other pair takes the CUDA cores,
    unsplit."""
    if a_dtype != torch.bfloat16 or b_dtype != torch.bfloat16:
        return Plan("fma", _FMA_TILE, 1)
    bm, bn, bk = _WG_TILE
    tiles = -(-m // bm) * -(-n // bn)
    split = 1
    if k > _NO_SPLIT_K and tiles < sm_count:
        split = max(1, min(-(-sm_count // tiles), -(-k // bk) // 2))
    return Plan("wgmma", _WG_TILE, split)


def _smem_bytes(depth: int) -> int:
    """Shared memory of a ring of ``depth`` stages (csrc/ff_matmul.cu
    smem_bytes): 1024 bytes of alignment slack, the stages, two mbarriers
    a stage, the tile's 128 row offsets."""
    return 1024 + depth * _STAGE_BYTES + 16 * depth + 8 * _WG_TILE[0]


MAX_DEPTH = max(d for d in range(1, 64) if _smem_bytes(d) <= _MAX_SMEM)


def _pipe(depth, streams) -> Tuple[int, int]:
    """``depth`` and ``streams`` (None: the defaults), checked as the
    reference's ``Pipe`` checks them against this kernel's tiles: each at
    least 1, ``streams`` dividing the leading dimension of both tiles (A's
    128 rows, B's 64 k rows) into sub-copies of at least 8 rows (one
    swizzle atom), and ``depth`` stages fitting in shared memory."""
    depth = DEFAULT_DEPTH if depth is None else depth
    streams = DEFAULT_STREAMS if streams is None else streams
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    for rows in (_WG_TILE[0], _WG_TILE[2]):
        if rows % streams or rows // streams < _MIN_STREAM_ROWS:
            raise ValueError(f"streams={streams} must split the tile's "
                             f"{rows} rows into sub-copies of at least "
                             f"{_MIN_STREAM_ROWS} rows")
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} needs {_smem_bytes(depth)} bytes "
                         f"of shared memory; at most {MAX_DEPTH} stages "
                         f"fit in {_MAX_SMEM}")
    return depth, streams


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def matmul_ref(a, b, out_dtype=None) -> torch.Tensor:
    """Plain version of the kernel: the product in f32, rounded once to
    ``out_dtype`` (default: A's type)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def dispatch_matmul_ref(tokens, idx, b) -> torch.Tensor:
    """Plain version of the gathered launch: ``matmul_ref(tokens[idx], b)``."""
    return matmul_ref(gather_ref(tokens, idx), b)


@functools.lru_cache(maxsize=None)
def _entry(path: str, gathered: bool, ta, tb, to):
    """ff_matmul_wgmma_<out> (bf16 x bf16, gathered or not);
    ff_matmul_<A>_<B>_<out> for the other pairs; ff_matmul_gather_f32."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if path == "wgmma":
        name = f"ff_matmul_wgmma_{_SUFFIX[to]}"
        args = [p, p, p, p, p, i, i, i, ll, ll, ll, i, i, i, p]
    elif gathered:
        name = f"ff_matmul_gather_{_SUFFIX[ta]}"
        args = [p, p, p, p, i, i, i, ll, ll, ll, p]
    else:
        name = f"ff_matmul_{_SUFFIX[ta]}_{_SUFFIX[tb]}_{_SUFFIX[to]}"
        args = [p, p, p, i, i, i, ll, ll, ll, p]
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
    entry = _entry(plan.path, rows is not None, a.dtype, b.dtype, out_dtype)
    stream = _build.stream_ptr(a.device)
    if plan.path == "wgmma":
        ws = (torch.empty((plan.split, m, n), dtype=torch.float32,
                          device=a.device) if plan.split > 1 else None)
        rc = entry(a.data_ptr(), rows.data_ptr() if rows is not None
                   else None, b.data_ptr(), out.data_ptr(),
                   ws.data_ptr() if ws is not None else None, m, n, k,
                   a.stride(0), b.stride(0), out.stride(0), depth, streams,
                   plan.split, stream)
    else:
        head = (a.data_ptr(),) + ((rows.data_ptr(),) if rows is not None
                                  else ())
        rc = entry(*head, b.data_ptr(), out.data_ptr(), m, n, k,
                   a.stride(0), b.stride(0), out.stride(0), stream)
    _build.check("ff_matmul", "ff_matmul", rc)
    return out


def matmul(a, b, *, out_dtype=None, depth=None, streams=None
           ) -> torch.Tensor:
    """C = A @ B with f32 accumulation: a [m, k] and b [k, n], each float32
    or bfloat16 (separately); the output is ``out_dtype`` (default: A's
    type), as the reference's. Any m, n, k. ``depth`` and ``streams``
    (default :data:`DEFAULT_DEPTH`, :data:`DEFAULT_STREAMS`) size the ring
    that feeds the tensor cores (bf16 x bf16); they are checked for every
    pair and do not change the result. CPU tensors run :func:`matmul_ref`;
    CUDA tensors launch the kernel (f32 operands stay f32: no TF32)."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    depth, streams = _pipe(depth, streams)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    out = _launch(a, None, b, a.shape[0], out_dtype, depth, streams)
    matmul.launches += 1
    return out


matmul.launches = 0


def dispatch_matmul(tokens, idx, b, *, depth=None, streams=None
                    ) -> torch.Tensor:
    """``tokens[idx] @ b`` in one launch, the rows of A read through
    ``idx`` (the dispatched buffer is never written): tokens [T, k], idx
    [n] int32 or int64 with every index in ``[0, T)`` (unchecked on the
    card, as :func:`repro_torch.kernels.ff_gather.gather`), b [k, d_ff] of
    the tokens' type. Returns [n, d_ff] in the tokens' type, equal bit for
    bit to ``matmul(gather(tokens, idx), b)`` at any ``depth`` and
    ``streams`` (as :func:`matmul`'s). CPU tensors run
    :func:`dispatch_matmul_ref`; CUDA tensors launch the kernel."""
    check_gather_inputs(tokens, idx)
    _check(tokens, b, tokens.dtype)
    if b.dtype != tokens.dtype:
        raise TypeError(f"dispatch_matmul wants b of the tokens' type "
                        f"{tokens.dtype}, not {b.dtype}")
    depth, streams = _pipe(depth, streams)
    if tokens.device.type == "cpu":
        return dispatch_matmul_ref(tokens, idx, b)
    out = _launch(tokens, idx.to(torch.int32).contiguous(), b, idx.shape[0],
                  tokens.dtype, depth, streams)
    dispatch_matmul.launches += 1
    return out


dispatch_matmul.launches = 0
