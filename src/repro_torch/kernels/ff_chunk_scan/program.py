"""The chunked scan's declaration as a StreamProgram (the port of
``repro/kernels/ff_chunk_scan/kernel.py`` ``build_program``) and its
launch.

The declaration keeps the reference's schedule: one word per (bh, chunk),
q/k/w [chunk, N] and v [chunk, P] tiles of the row-flattened [BH * S, .]
views. The hand-written kernel (``csrc/ff_chunk_scan.cu``) streams a
chunk's rows 16 at a time on its ring body.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import BlockIn, ScratchSpec, Stream, \
    StreamProgram
from repro_torch.kernels.ff_chunk_scan.ops import chunk_scan


def build_program(bh: int, s: int, n: int, p: int, *,
                  chunk: int = 64, subtile: int = 16, inclusive: bool = True,
                  has_u: bool = False, dtype=torch.float32, k_dtype=None,
                  v_dtype=None, w_dtype=None, out_dtype=None,
                  depth: int = 2, streams: int = 1) -> StreamProgram:
    """Declare the chunked-scan stream program at one shape point.
    ``dtype`` is the q/out element type; ``k_dtype``/``v_dtype``/
    ``w_dtype`` (default ``dtype``) size their own pipe edges."""
    assert s % chunk == 0 and chunk % subtile == 0, (s, chunk, subtile)
    nc = s // chunk
    out_dtype = out_dtype or dtype

    def spec(cols, dt):
        return Pipe(tile=(chunk, cols), dtype=dt or dtype, depth=depth,
                    streams=streams)

    def row(w):
        return (w, 0)

    return StreamProgram(
        name="ff_chunk_scan",
        n_words=bh * nc,
        inputs=(
            Stream("q", spec(n, dtype), index=row),
            Stream("k", spec(n, k_dtype), index=row),
            Stream("v", spec(p, v_dtype), index=row),
            Stream("w", spec(n, w_dtype), index=row),
            BlockIn("u", (1, n), lambda g: (g // nc, 0), dtype=dtype),
        ),
        kernel="ff_chunk_scan",
        out_shape=(bh, s, p),
        out_dtype=out_dtype,
        out_block=(1, chunk, p),
        out_index_map=lambda g: (g // nc, g % nc, 0),
        scratch=(ScratchSpec("h", (n, p), torch.float32),),
        kernel_kwargs={"chunk": chunk, "subtile": subtile,
                       "inclusive": inclusive, "has_u": has_u},
    )


def launch(program: StreamProgram, ops, policy) -> torch.Tensor:
    """The scan through :func:`~repro_torch.kernels.ff_chunk_scan.
    chunk_scan` (``u`` [BH, N] taken only where ``has_u``)."""
    kw = program.kernel_kwargs
    return chunk_scan(ops["q"], ops["k"], ops["v"], ops["w"],
                      ops["u"] if kw["has_u"] else None, chunk=kw["chunk"],
                      subtile=kw["subtile"], inclusive=kw["inclusive"],
                      policy=policy)
