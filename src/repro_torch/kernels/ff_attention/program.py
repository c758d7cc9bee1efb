"""Prefill attention's declaration as a StreamProgram (the port of
``repro/kernels/ff_attention/kernel.py`` ``build_program``) and its
launch.

The declaration keeps the reference's schedule: words (bh, q tile, kv
tile) with the KV tile innermost, q a ``(1, block_q, d)`` block, K and V
streams indexed in the row-flattened [BKVH * Skv, d] view. The
hand-written kernel (``csrc/ff_attention.cu``) runs its own tiles
(:data:`~repro_torch.kernels.ff_attention.BLOCK_Q`, ``BLOCK_KV``) and
skips the KV tiles past a q tile's diagonal.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import BlockIn, ScratchSpec, Stream, \
    StreamProgram
from repro_torch.kernels.ff_attention.ops import attention


def build_program(bh: int, s: int, skv: int, d: int, *,
                  kv_groups: int = 1, block_q: int = 128,
                  block_kv: int = 128, causal: bool = True,
                  dtype=torch.float32, k_dtype=None, v_dtype=None,
                  out_dtype=None, depth: int = 2,
                  streams: int = 1) -> StreamProgram:
    """Declare the prefill-attention stream program at one shape point.
    ``dtype`` is the q/out element type; ``k_dtype``/``v_dtype`` (default
    ``dtype``) size their own pipe edges."""
    assert s % block_q == 0 and skv % block_kv == 0, (s, skv, block_q,
                                                      block_kv)
    nq, nkv = s // block_q, skv // block_kv
    out_dtype = out_dtype or dtype
    k_spec = Pipe(tile=(block_kv, d), dtype=k_dtype or dtype, depth=depth,
                  streams=streams)
    v_spec = Pipe(tile=(block_kv, d), dtype=v_dtype or dtype, depth=depth,
                  streams=streams)

    def q_index_map(g):
        return (g // (nkv * nq), (g // nkv) % nq, 0)

    def kv_index(w):
        return (((w // (nkv * nq)) // kv_groups) * nkv + w % nkv, 0)

    return StreamProgram(
        name="ff_attention",
        n_words=bh * nq * nkv,
        inputs=(
            BlockIn("q", (1, block_q, d), q_index_map, dtype=dtype),
            Stream("k", k_spec, index=kv_index),
            Stream("v", v_spec, index=kv_index),
        ),
        kernel="ff_attention",
        out_shape=(bh, s, d),
        out_dtype=out_dtype,
        out_block=(1, block_q, d),
        out_index_map=q_index_map,
        scratch=(
            ScratchSpec("m", (block_q, 128), torch.float32),
            ScratchSpec("l", (block_q, 128), torch.float32),
            ScratchSpec("acc", (block_q, d), torch.float32),
        ),
        kernel_kwargs={"kv_groups": kv_groups, "causal": causal},
    )


def launch(program: StreamProgram, ops, policy) -> torch.Tensor:
    """Attention over q [BH, S, D], k/v [BKVH, Skv, D] through
    :func:`~repro_torch.kernels.ff_attention.attention`."""
    kw = program.kernel_kwargs
    return attention(ops["q"], ops["k"], ops["v"],
                     kv_groups=kw["kv_groups"], causal=kw["causal"],
                     policy=policy)
