"""The port's library entry points, the counterpart of ``repro.ops``.

``repro.ops`` resolves its names against the reference's kernel registry;
the port has no registry, so each entry point is the kernel wrapper
itself, imported here by name::

    from repro_torch import ops
    c = ops.matmul(a, b)              # CUDA tensors launch the kernel,
    rows = ops.gather(table, idx)     # CPU tensors run its plain version
    y = ops.chunk_scan(q, k, v, log_w, u, inclusive=False)
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.kernels.ff_attention import attention
from repro_torch.kernels.ff_chunk_scan import chunk_scan
from repro_torch.kernels.ff_decode_attention import decode_attention
from repro_torch.kernels.ff_gather import gather
from repro_torch.kernels.ff_matmul import matmul

__all__ = ["attention", "chunk_scan", "decode_attention", "gather", "matmul",
           "names"]


def names() -> Tuple[str, ...]:
    """Short names of every entry point, sorted."""
    return ("attention", "chunk_scan", "decode_attention", "gather",
            "matmul")
