"""The row gather's declaration as a StreamProgram (the port of
``repro/kernels/ff_gather/kernel.py`` ``build_program``) and its launch.

Its ``table`` stream is an irregular gather: the rows are data-dependent,
so it declares no block schedule and no graph edge into it fuses. Its
output words are the reference's ``8 * streams``-row bundles.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import ScalarIn, Stream, StreamProgram
from repro_torch.kernels.ff_gather.ops import _ROWS, gather


def build_program(n: int, cols: int, *, dtype=torch.float32,
                  depth: int = 4, streams: int = 1) -> StreamProgram:
    """Declare the gather stream program: ``n`` output rows (a multiple of
    the ``8 * streams`` row bundle) pulled from a [R, cols] table."""
    rows_per_word = _ROWS * streams
    assert n % rows_per_word == 0, (n, rows_per_word)
    return StreamProgram(
        name="ff_gather",
        n_words=n // rows_per_word,
        inputs=(
            ScalarIn("idx"),
            Stream("table",
                   Pipe(tile=(rows_per_word, cols), dtype=dtype, depth=depth),
                   gather=True),
        ),
        kernel="ff_gather",
        out_shape=(n, cols),
        out_dtype=dtype,
        out_block=(rows_per_word, cols),
        out_index_map=lambda g, idx: (g, 0),
    )


def launch(program: StreamProgram, ops, policy) -> torch.Tensor:
    """``table[idx]`` through :func:`~repro_torch.kernels.ff_gather.
    gather`."""
    del program
    return gather(ops["table"], ops["idx"], policy=policy)
