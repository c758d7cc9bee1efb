"""Pipe: the on-chip FIFO connecting a memory (producer) stage to a compute
(consumer) stage (the port of ``repro/core/pipe.py``).

On the H100 a pipe is a ring of ``depth`` shared-memory stages
(``kernels/csrc/ring_pipe.cuh``), each holding one *word* (a tile of rows),
filled by TMA or ``cp.async`` copies and handed over through mbarriers.
``streams`` is the number of concurrent sub-copies a word is split into
(the paper's multiple producers), along the tile's leading dim.

The pipe's "resource utilization" (the paper's BRAM; the reference's TPU
VMEM) is shared memory, exposed as :attr:`Pipe.smem_bytes` and checked
against one block's budget, the 227 KB (232448 bytes) every kernel of the
port may use. Shared memory has no sublane granule, so the reference's
(8, 128) alignment checks have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

# Shared memory one block may use on the H100 (227 KB): the budget the
# planner, the autotuner and each kernel's own checks (``_MAX_SMEM``) share.
DEFAULT_SMEM_BUDGET_BYTES = 232448


def itemsize(dtype: Any) -> int:
    """Bytes of one element of ``dtype``: a torch dtype or its name
    (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def dtype_name(dtype: Any) -> str:
    """The dtype's name as the reference writes it (``jnp.dtype(d).name``:
    ``"float32"``, ``"bfloat16"``), from a torch dtype or a name."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Pipe:
    """Configuration of one producer→consumer pipe.

    Attributes:
      tile: rows x columns of a pipe word (the leading dim is what
        ``streams`` splits).
      dtype: element type carried by the pipe (a torch dtype).
      depth: ring stages (paper: channel depth). depth=1 degenerates to the
        synchronous copy-then-compute baseline; depth>=2 overlaps copy and
        compute.
      streams: concurrent sub-copies a word (paper: #producers); the tile's
        leading dim is split ``streams`` ways.
    """

    tile: Tuple[int, ...]
    dtype: Any = torch.float32
    depth: int = 2
    streams: int = 1

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"pipe depth must be >= 1, got {self.depth}")
        if self.streams < 1:
            raise ValueError(f"pipe streams must be >= 1, got {self.streams}")
        if len(self.tile) < 2:
            raise ValueError(f"pipe tile must be >= 2-D, got {self.tile}")
        if self.tile[0] % self.streams != 0:
            raise ValueError(
                f"tile leading dim {self.tile[0]} not divisible by "
                f"streams={self.streams}")

    @property
    def word_bytes(self) -> int:
        return math.prod(self.tile) * itemsize(self.dtype)

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the ring (depth stages of one word)."""
        return self.depth * self.word_bytes

    def with_depth(self, depth: int) -> "Pipe":
        return dataclasses.replace(self, depth=depth)

    def with_streams(self, streams: int) -> "Pipe":
        return dataclasses.replace(self, streams=streams)


def smem_budget_ok(pipes,
                   budget_bytes: int = DEFAULT_SMEM_BUDGET_BYTES) -> bool:
    """Check a set of pipes against one block's shared-memory budget."""
    return sum(p.smem_bytes for p in pipes) <= budget_bytes


def required_depth(dma_latency_s: float, word_service_time_s: float,
                   cap: int = 8) -> int:
    """Min ring depth that hides copy latency behind word service time.

    Paper finding ("channel depth does not significantly affect
    performance") holds when service time >= latency, i.e. required depth
    saturates at 2.
    """
    if word_service_time_s <= 0:
        return cap
    need = 1 + math.ceil(dma_latency_s / word_service_time_s)
    return max(2, min(cap, need))
