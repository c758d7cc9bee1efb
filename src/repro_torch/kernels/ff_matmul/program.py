"""The matmul's declaration as a StreamProgram (the port of
``repro/kernels/ff_matmul/kernel.py`` ``build_program``) and its launch.

The declaration keeps the reference's block schedule: (bm, bn, bk) blocks
walked k-innermost, A's word ``(w // (nk * nn), w % nk)`` and B's ``(w %
nk, (w // nk) % nn)``, so the graph fuser reads the reference's legality
from it. The hand-written kernel (``csrc/ff_matmul.cu``) tiles by its own
plan (:func:`~repro_torch.kernels.ff_matmul.ops._plan`); the declaration's
``block`` never reaches it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import ScratchSpec, Stream, StreamProgram
from repro_torch.kernels.ff_matmul.ops import matmul


def build_program(m: int, n: int, k: int, *,
                  block: Tuple[int, int, int] = (128, 128, 128),
                  dtype=torch.float32, b_dtype=None, out_dtype=None,
                  depth: int = 2, streams: int = 1) -> StreamProgram:
    """Declare the matmul stream program at one (block-aligned) shape.
    ``dtype`` sizes the A pipe, ``b_dtype`` (default ``dtype``) the B
    pipe."""
    bm, bn, bk = block
    assert m % bm == 0 and n % bn == 0 and k % bk == 0, ((m, n, k), block)
    nm, nn, nk = m // bm, n // bn, k // bk
    b_dtype = b_dtype or dtype
    out_dtype = out_dtype or dtype
    return StreamProgram(
        name="ff_matmul",
        n_words=nm * nn * nk,
        inputs=(
            Stream("a", Pipe(tile=(bm, bk), dtype=dtype, depth=depth,
                             streams=streams),
                   index=lambda w: (w // (nk * nn), w % nk)),
            Stream("b", Pipe(tile=(bk, bn), dtype=b_dtype, depth=depth,
                             streams=streams),
                   index=lambda w: (w % nk, (w // nk) % nn)),
        ),
        kernel="ff_matmul",
        out_shape=(m, n),
        out_dtype=out_dtype,
        out_block=(bm, bn),
        out_index_map=lambda g: (g // (nn * nk), (g // nk) % nn),
        scratch=(ScratchSpec("acc", (bm, bn), torch.float32),),
    )


def launch(program: StreamProgram, ops, policy) -> torch.Tensor:
    """``a @ b`` through :func:`~repro_torch.kernels.ff_matmul.matmul`."""
    return matmul(ops["a"], ops["b"], out_dtype=program.out_dtype,
                  policy=policy)
