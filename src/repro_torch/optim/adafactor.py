"""Adafactor (factored second moment): the port of
``repro/optim/adafactor.py``, the memory-frugal option for the largest
configs.

A leaf of rank >= 2 keeps row and column statistics (``vr`` over its last
axis, ``vc`` over its second last) instead of a full second moment.
:func:`update` writes the parameters and the state in place under
``torch.no_grad()`` and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr_peak: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10000


def _factored(shape) -> bool:
    return len(shape) >= 2


def init(params) -> Dict[str, Any]:
    """Zero moments ({"vr", "vc"} for a matrix, {"v"} else) and a 0-d
    step. Sharded (DTensor) parameters are refused: the factored moments'
    placements are not derived yet; AdamW trains on a mesh."""
    from repro_torch.runtime.sharding import is_dtensor
    if any(is_dtensor(p) for _, p in L.tree_leaves(params)):
        raise NotImplementedError(
            "Adafactor on sharded (DTensor) parameters is not ported: "
            "train this config on one rank, or with AdamW on a mesh")

    def st(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}
    device = next(L.tree_leaves(params))[1].device
    return {"v": L.tree_map(st, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def update(cfg: AdafactorConfig, grads, state, params):
    """One Adafactor step on ``params`` and ``state``, both written in
    place: (params, state, {"lr"})."""
    state["step"].add_(1)
    sf = state["step"].float()
    lr = cfg.lr_peak * torch.clamp(sf / cfg.warmup_steps, max=1.0) * \
        torch.rsqrt(torch.clamp(sf, min=cfg.warmup_steps))
    beta = 1.0 - sf ** (-cfg.decay)
    g_leaves = dict(L.tree_leaves(grads))
    for path, p in L.tree_leaves(params):
        g = g_leaves[path].float()
        v = state["v"]
        for k in path:
            v = v[k]
        g2 = g * g + cfg.eps
        if _factored(p.shape):
            vr = v["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
            vc = v["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
            denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None]
                     ) * vc[..., None, :]
            u = g * torch.rsqrt(denom + cfg.eps)
        else:
            nv = v["v"].mul_(beta).add_((1 - beta) * g2)
            u = g * torch.rsqrt(nv + cfg.eps)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p.copy_(p.float() * (1 - cfg.weight_decay * lr) - lr * u)
    return params, state, {"lr": lr}
