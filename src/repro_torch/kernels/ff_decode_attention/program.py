"""Decode attention's declarations as StreamPrograms (the port of
``repro/kernels/ff_decode_attention/kernel.py`` ``build_program`` and
``build_paged_program``) and their launches.

Both keep the reference's schedules: one word per (b, kv head, KV tile),
q a ``(1, 1, g_pad, d)`` block, the contiguous K/V streams indexed in the
row-flattened [B * KVH * S, d] view, the paged stream one merged ``(2 *
page, d)`` K+V word per page of the gathered rows. The hand-written
kernel (``csrc/ff_decode_attention.cu`` ``ring_decode_kernel``) reads
words of its own rows (:func:`~repro_torch.kernels.ff_decode_attention.
ops._word_rows`) and splits a row's words over blocks.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import BlockIn, ScalarIn, ScratchSpec, \
    Stream, StreamProgram
from repro_torch.kernels.ff_decode_attention.ops import decode_attention


def _scratch(g_pad: int, d: int):
    return (ScratchSpec("m", (g_pad, 128), torch.float32),
            ScratchSpec("l", (g_pad, 128), torch.float32),
            ScratchSpec("acc", (g_pad, d), torch.float32))


def build_program(b: int, kvh: int, g_pad: int, s: int, d: int, *,
                  block_kv: int = 128, dtype=torch.float32, k_dtype=None,
                  v_dtype=None, out_dtype=None,
                  depth: int = 2, streams: int = 1) -> StreamProgram:
    """Declare the decode-attention stream program at one shape point.
    ``dtype`` is the q/out element type; ``k_dtype``/``v_dtype`` (default
    ``dtype``) size their own cache pipe edges."""
    assert s % block_kv == 0, (s, block_kv)
    nkv = s // block_kv
    out_dtype = out_dtype or dtype
    k_spec = Pipe(tile=(block_kv, d), dtype=k_dtype or dtype, depth=depth,
                  streams=streams)
    v_spec = Pipe(tile=(block_kv, d), dtype=v_dtype or dtype, depth=depth,
                  streams=streams)

    def q_index_map(g, lens):
        return ((g // nkv) // kvh, (g // nkv) % kvh, 0, 0)

    return StreamProgram(
        name="ff_decode_attention",
        n_words=b * kvh * nkv,
        inputs=(
            ScalarIn("lengths"),
            BlockIn("q", (1, 1, g_pad, d), q_index_map, dtype=dtype),
            Stream("k", k_spec, index=lambda w: (w, 0)),
            Stream("v", v_spec, index=lambda w: (w, 0)),
        ),
        kernel="ff_decode_attention",
        out_shape=(b, kvh, g_pad, d),
        out_dtype=out_dtype,
        out_block=(1, 1, g_pad, d),
        out_index_map=q_index_map,
        scratch=_scratch(g_pad, d),
        kernel_kwargs={"block_kv": block_kv},
    )


def build_paged_program(b: int, kvh: int, g_pad: int, n_pages: int,
                        page: int, d: int, *, dtype=torch.float32,
                        kv_dtype=None, out_dtype=None,
                        depth: int = 2, streams: int = 1) -> StreamProgram:
    """Paged decode attention, the consumer half of the
    ``paged_decode_attention`` graph: its ``kv`` operand is the gathered
    row stream [B * KVH * n_pages * 2 * page, d], each word one page's K
    rows then its V rows."""
    out_dtype = out_dtype or dtype
    kv_spec = Pipe(tile=(2 * page, d), dtype=kv_dtype or dtype, depth=depth,
                   streams=streams)

    def q_index_map(g, lens):
        return ((g // n_pages) // kvh, (g // n_pages) % kvh, 0, 0)

    return StreamProgram(
        name="ff_paged_decode_attention",
        n_words=b * kvh * n_pages,
        inputs=(
            ScalarIn("lengths"),
            BlockIn("q", (1, 1, g_pad, d), q_index_map, dtype=dtype),
            Stream("kv", kv_spec, index=lambda w: (w, 0)),
        ),
        kernel="ff_paged_decode_attention",
        out_shape=(b, kvh, g_pad, d),
        out_dtype=out_dtype,
        out_block=(1, 1, g_pad, d),
        out_index_map=q_index_map,
        scratch=_scratch(g_pad, d),
        kernel_kwargs={"page": page, "n_pages": n_pages},
    )


def launch(program: StreamProgram, ops, policy) -> torch.Tensor:
    """q [B, KVH, G, D] over k/v [B, KVH, S, D] through
    :func:`~repro_torch.kernels.ff_decode_attention.decode_attention`;
    returns [B, KVH, G, D]."""
    q = ops["q"]
    b, kvh, g, d = q.shape
    out = decode_attention(q.reshape(b, kvh * g, d), ops["k"], ops["v"],
                           ops["lengths"],
                           block_kv=program.kernel_kwargs["block_kv"],
                           policy=policy)
    return out.view(b, kvh, g, d)


def launch_paged(program: StreamProgram, ops, policy) -> torch.Tensor:
    """The paged program on its own, over already-gathered rows: the
    rows taken apart into the contiguous caches, then the same kernel as
    :func:`launch` at ``block_kv == page`` (what the staged paged graph
    runs; the fused one reads the pool through the block table)."""
    q = ops["q"]
    b, kvh, g, d = q.shape
    page, n_pages = (program.kernel_kwargs[k] for k in ("page", "n_pages"))
    # each page's K rows, then its V rows -> contiguous K and V caches
    rows = ops["kv"].view(b, kvh, n_pages, 2, page, d)
    k, v = (rows[:, :, :, i].reshape(b, kvh, n_pages * page, d)
            for i in (0, 1))
    out = decode_attention(q.reshape(b, kvh * g, d), k, v, ops["lengths"],
                           block_kv=page, policy=policy)
    return out.view(b, kvh, g, d)
