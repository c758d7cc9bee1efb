"""Row gather: wrapper, plain version, launch count.

Replaces the TPU kernel ``repro/kernels/ff_gather/kernel.py``
(``build_program`` / ``gather_ff``, wrapper ``ops.py:_apply``). The CUDA
kernel is ``csrc/ff_gather.cu``; its note says what bounds it on the H100.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
_UNITS = (16, 8, 4, 2)          # copy units of the kernel, in bytes


def gather_ref(table, idx) -> torch.Tensor:
    """Plain version of the kernel: ``table[idx]`` through
    ``index_select``, which raises ``IndexError`` on an index outside
    ``[0, R)`` (negative ones included: they do not wrap)."""
    return torch.index_select(table, 0, idx.long())


@functools.lru_cache(maxsize=None)
def _entry():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ff_gather", "ff_gather",
                       [p, p, p, i, ctypes.c_longlong, i, p])


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


def gather(table, idx) -> torch.Tensor:
    """``table[idx]``: table [R, C] float32 or bfloat16, idx [n] int32 or
    int64, any n. Returns [n, C], an exact copy of the indexed rows.

    Every index must lie in ``[0, R)``: the plain version raises
    ``IndexError`` outside it (a negative index too), the kernel does not
    check (that would cost a host sync per call) and reads whatever lies
    there. CPU tensors run :func:`gather_ref`;
    CUDA tensors launch the kernel."""
    check_gather_inputs(table, idx)
    if table.device.type == "cpu":
        return gather_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather runs on cpu or cuda, not {table.device}")
    n, c = idx.shape[0], table.shape[1]
    if table.stride(1) != 1 or table.stride(0) != c:
        table = table.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    row_bytes = c * table.element_size()
    unit = next(u for u in _UNITS if row_bytes % u == 0
                and table.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    rc = _entry()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                  row_bytes, unit, _build.stream_ptr(table.device))
    _build.check("ff_gather", "ff_gather", rc)
    gather.launches += 1
    return out


gather.launches = 0
