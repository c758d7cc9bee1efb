"""The decode layer's building-block declarations as StreamPrograms (the
port of ``repro/kernels/ff_layer/kernel.py`` ``build_matmul_program`` and
``build_swiglu_program``) and their launches.

The declarations keep the reference's schedule: one word per
``block_m``-row block of the activation, k and n un-tiled, the weight
block revisited every word (``(0, 0)``), the RMSNorm weight a
``(block_m, k)`` BlockIn of broadcast rows. That makes adjacent
projections chain-fusable, as in the reference. The hand-written kernels
(``csrc/ff_layer.cu``) stream the weights instead, in 64-column tiles
split over k on every SM; they take the norm weight and the q bias as one
row, so the launches read row 0 of the broadcast blocks.

A node's epilogue (:class:`repro_torch.core.graph.Epilogue`) reaches the
launch through ``kernel_kwargs``: ``"residual"`` (one input, added in the
output type) and ``"rope_bias"`` (the q bias and the positions, with
``rope_theta`` and ``head_dim``) are what the kernel implements.
"""

from __future__ import annotations

import torch

from repro_torch.core.pipe import Pipe
from repro_torch.core.program import EPILOGUES, BlockIn, Stream, \
    StreamProgram
from repro_torch.kernels.ff_layer.ops import ff_layer_matmul, \
    ff_layer_swiglu


def _norm_input(block_m: int, k: int) -> BlockIn:
    return BlockIn("nw", (block_m, k), lambda w: (0, 0), dtype=torch.float32)


def build_matmul_program(m: int, n: int, k: int, *,
                         block_m: int = 8, norm: bool = False,
                         eps: float = 1e-6, dtype=torch.float32,
                         b_dtype=None, out_dtype=None,
                         depth: int = 2, streams: int = 1,
                         name: str = "ff_layer_matmul") -> StreamProgram:
    """``out = maybe_rmsnorm(a) @ b`` with one word per ``block_m``-row
    block of ``a`` (k and n un-tiled). With ``norm=True`` the RMSNorm
    weight is BlockIn ``nw`` of shape ``(block_m, k)``."""
    assert m % block_m == 0, (m, block_m)
    b_dtype = b_dtype or dtype
    out_dtype = out_dtype or dtype
    inputs = [
        Stream("a", Pipe(tile=(block_m, k), dtype=dtype, depth=depth,
                         streams=streams), index=lambda w: (w, 0)),
        Stream("b", Pipe(tile=(k, n), dtype=b_dtype, depth=depth),
               index=lambda w: (0, 0)),
    ]
    if norm:
        inputs.append(_norm_input(block_m, k))
    return StreamProgram(
        name=name,
        n_words=m // block_m,
        inputs=tuple(inputs),
        kernel="ff_layer_matmul",
        out_shape=(m, n),
        out_dtype=out_dtype,
        out_block=(block_m, n),
        out_index_map=lambda g: (g, 0),
        kernel_kwargs={"norm": norm, "eps": eps},
    )


def build_swiglu_program(m: int, f: int, k: int, *,
                         block_m: int = 8, norm: bool = True,
                         eps: float = 1e-6, dtype=torch.float32,
                         out_dtype=None, depth: int = 2,
                         streams: int = 1) -> StreamProgram:
    """``out = silu(maybe_rmsnorm(x) @ wg) * (maybe_rmsnorm(x) @ wu)`` with
    one word per row block."""
    assert m % block_m == 0, (m, block_m)
    out_dtype = out_dtype or dtype
    inputs = [
        Stream("x", Pipe(tile=(block_m, k), dtype=dtype, depth=depth,
                         streams=streams), index=lambda w: (w, 0)),
        Stream("wg", Pipe(tile=(k, f), dtype=dtype, depth=depth),
               index=lambda w: (0, 0)),
        Stream("wu", Pipe(tile=(k, f), dtype=dtype, depth=depth),
               index=lambda w: (0, 0)),
    ]
    if norm:
        inputs.append(_norm_input(block_m, k))
    return StreamProgram(
        name="ff_layer_swiglu",
        n_words=m // block_m,
        inputs=tuple(inputs),
        kernel="ff_layer_swiglu",
        out_shape=(m, f),
        out_dtype=out_dtype,
        out_block=(block_m, f),
        out_index_map=lambda g: (g, 0),
        kernel_kwargs={"norm": norm, "eps": eps},
    )


def row(t: torch.Tensor) -> torch.Tensor:
    """A per-column vector given as one row or as broadcast rows."""
    return t if t.dim() == 1 else t[0]


def epilogue_kwargs(program: StreamProgram, ops) -> dict:
    """The ff_layer_matmul keywords of the program's epilogue."""
    kw = program.kernel_kwargs
    epi, names = kw.get("epilogue"), kw.get("epilogue_inputs", ())
    if epi is None:
        return {}
    if epi == "residual":
        return {"residual": ops[names[0]]}
    if epi == "rope_bias":
        bias = ops[names[0]]
        return {"bias": None if bias is None else row(bias),
                "positions": ops[names[1]],
                "rope_theta": kw["rope_theta"], "head_dim": kw["head_dim"]}
    raise NotImplementedError(
        f"{program.name}: the ff_layer kernel has no epilogue {epi!r}; it "
        f"implements {EPILOGUES[program.kernel]}")


def launch_matmul(program: StreamProgram, ops, policy) -> torch.Tensor:
    """The projection through :func:`~repro_torch.kernels.ff_layer.
    ff_layer_matmul`, with its RMSNorm prologue and epilogue."""
    kw = program.kernel_kwargs
    nw = row(ops["nw"]) if kw["norm"] else None
    return ff_layer_matmul(ops["a"], ops["b"], norm_weight=nw, eps=kw["eps"],
                           **epilogue_kwargs(program, ops), policy=policy)


def launch_swiglu(program: StreamProgram, ops, policy) -> torch.Tensor:
    """The gate/up half through :func:`~repro_torch.kernels.ff_layer.
    ff_layer_swiglu`."""
    kw = program.kernel_kwargs
    if kw.get("epilogue") is not None:
        raise NotImplementedError(
            f"{program.name}: the SwiGLU kernel takes no epilogue")
    nw = row(ops["nw"]) if kw["norm"] else None
    return ff_layer_swiglu(ops["x"], ops["wg"], ops["wu"], norm_weight=nw,
                           eps=kw["eps"], policy=policy)
