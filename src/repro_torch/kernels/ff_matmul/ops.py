"""Tiled matmul and the MoE dispatch->expert launch: wrappers, plain
versions, launch counts.

Replaces the TPU kernel ``repro/kernels/ff_matmul/kernel.py``
(``build_program`` / ``matmul_ff``, wrapper ``ops.py:_apply``) and, in
:func:`dispatch_matmul`, the dispatch->expert edge of the
``moe_dispatch_ffn`` StreamGraph (``repro/models/moe.py:build_moe_graph``:
``ff_gather`` fused into the expert matmul's A stream). Both are one
templated kernel in ``csrc/ff_matmul.cu``; its note says what bounds it
on the H100 and why the gathered launch equals ``gather`` then
``matmul`` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ff_gather.ops import check_gather_inputs, gather_ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BLOCK = 64                     # rows and columns per CUDA block
_MAX_GRID_Y = 65535


def matmul_ref(a, b, out_dtype=None) -> torch.Tensor:
    """Plain version of the kernel: the product in f32, rounded once to
    ``out_dtype`` (default: A's type)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def dispatch_matmul_ref(tokens, idx, b) -> torch.Tensor:
    """Plain version of the gathered launch: ``matmul_ref(tokens[idx], b)``."""
    return matmul_ref(gather_ref(tokens, idx), b)


@functools.lru_cache(maxsize=None)
def _entry(gathered: bool, ta, tb, to):
    """ff_matmul_<A>_<B>_<out> for every type triple; the gathered entry
    ff_matmul_gather_<T> only for one type throughout (the MoE dispatch's
    tokens, weight and output share it)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if gathered:
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


def _launch(a, rows, b, m, out_dtype):
    a, b = _rows_contiguous(a), _rows_contiguous(b)
    n, k = b.shape[1], b.shape[0]
    if -(-m // _BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"matmul takes at most {_MAX_GRID_Y * _BLOCK} "
                         f"rows, got {m}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    head = (a.data_ptr(),) + ((rows.data_ptr(),) if rows is not None
                              else ())
    rc = _entry(rows is not None, a.dtype, b.dtype, out_dtype)(
        *head, b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0),
        b.stride(0), out.stride(0), _build.stream_ptr(a.device))
    _build.check("ff_matmul", "ff_matmul", rc)
    return out


def matmul(a, b, *, out_dtype=None) -> torch.Tensor:
    """C = A @ B with f32 accumulation: a [m, k] and b [k, n], each float32
    or bfloat16 (separately); the output is ``out_dtype`` (default: A's
    type), as the reference's. Any m, n, k. CPU tensors run
    :func:`matmul_ref`; CUDA tensors launch the kernel (f32 operands stay
    f32: no TF32)."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    out = _launch(a, None, b, a.shape[0], out_dtype)
    matmul.launches += 1
    return out


matmul.launches = 0


def dispatch_matmul(tokens, idx, b) -> torch.Tensor:
    """``tokens[idx] @ b`` in one launch, the rows of A read through
    ``idx`` (the dispatched buffer is never written): tokens [T, k], idx
    [n] int32 or int64 with every index in ``[0, T)`` (unchecked on the
    card, as :func:`repro_torch.kernels.ff_gather.gather`), b [k, d_ff] of
    the tokens' type. Returns [n, d_ff] in the tokens' type, equal bit for
    bit to ``matmul(gather(tokens, idx), b)``. CPU tensors run
    :func:`dispatch_matmul_ref`; CUDA tensors launch the kernel."""
    check_gather_inputs(tokens, idx)
    _check(tokens, b, tokens.dtype)
    if b.dtype != tokens.dtype:
        raise TypeError(f"dispatch_matmul wants b of the tokens' type "
                        f"{tokens.dtype}, not {b.dtype}")
    if tokens.device.type == "cpu":
        return dispatch_matmul_ref(tokens, idx, b)
    out = _launch(tokens, idx.to(torch.int32).contiguous(), b, idx.shape[0],
                  tokens.dtype)
    dispatch_matmul.launches += 1
    return out


dispatch_matmul.launches = 0
