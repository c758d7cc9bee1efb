"""Gradient compression: int8 quantization with error feedback (the port
of ``repro/optim/compression.py``).

:class:`QuantizedAccumulator` keeps the microbatch gradient sum in int8
with a per-tensor scale, carrying each quantization's residual forward in
f32, so the decoded sum tracks the true one. The reference's
``compressed_allreduce`` (int8 on the wire across data-parallel ranks)
comes with the distributed runtime.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import layers as L


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q int8, scale f32). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x = x.float()
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class QuantizedAccumulator:
    """Error-feedback int8 accumulator: acc += g, with the quantization
    residual carried forward so sum(decoded) -> sum(g) over steps."""

    @staticmethod
    def init(params):
        return {
            "q": L.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.int8, device=p.device), params),
            "scale": L.tree_map(lambda p: torch.ones(
                (), dtype=torch.float32, device=p.device), params),
            "err": L.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
        }

    @staticmethod
    def add(state, grads):
        out = {"q": {}, "scale": {}, "err": {}}
        g_leaves = dict(L.tree_leaves(grads))
        s_leaves = dict(L.tree_leaves(state["scale"]))
        e_leaves = dict(L.tree_leaves(state["err"]))
        for path, q in L.tree_leaves(state["q"]):
            total = (dequantize(q, s_leaves[path]) + g_leaves[path].float()
                     + e_leaves[path])
            nq, ns = quantize(total)
            L._put(out["q"], path, nq)
            L._put(out["scale"], path, ns)
            L._put(out["err"], path, total - dequantize(nq, ns))
        return out

    @staticmethod
    def read(state):
        s_leaves = dict(L.tree_leaves(state["scale"]))
        out = {}
        for path, q in L.tree_leaves(state["q"]):
            L._put(out, path, dequantize(q, s_leaves[path]))
        return out
