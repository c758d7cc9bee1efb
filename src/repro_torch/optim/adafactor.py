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


def _zeros(p, shape, placements):
    """Zero f32 moments of ``shape`` beside ``p``: a plain tensor, or for a
    DTensor parameter a DTensor on its mesh with ``placements``."""
    from repro_torch.runtime.sharding import is_dtensor
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=placements)


def _dropped(placements, dim: int):
    """A parameter's placements for its moment with ``dim`` reduced away:
    a shard of that dim becomes a replica, a shard of a later dim moves
    one dim down. These are the placements ``launch/steps.py``
    ``opt_state_axes`` gives the moment (the parameter's logical axes
    with that axis dropped)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in placements:
        if isinstance(pl, Shard) and pl.dim == dim:
            out.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dim:
            out.append(Shard(pl.dim - 1))
        else:
            out.append(pl)
    return out


def init(params) -> Dict[str, Any]:
    """Zero moments ({"vr", "vc"} for a matrix, {"v"} else) and a 0-d
    step. A DTensor parameter's moments are DTensors on its mesh: ``v``
    placed as the parameter, ``vr`` and ``vc`` as it with their reduced
    dim dropped."""
    def st(p):
        pl = getattr(p, "placements", None)
        if _factored(p.shape):
            nd = len(p.shape)
            return {"vr": _zeros(p, p.shape[:-1], pl and _dropped(pl, nd - 1)),
                    "vc": _zeros(p, p.shape[:-2] + p.shape[-1:],
                                 pl and _dropped(pl, nd - 2))}
        return {"v": _zeros(p, p.shape, pl)}
    device = next(L.tree_leaves(params))[1].device
    return {"v": L.tree_map(st, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _like(x, ref):
    """``x`` placed as ``ref`` where both are DTensors (a mean over a
    sharded dim is a partial sum until it is reduced here)."""
    from repro_torch.runtime.sharding import is_dtensor
    if is_dtensor(x) and is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


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
            vr = v["vr"].mul_(beta).add_(
                _like((1 - beta) * g2.mean(dim=-1), v["vr"]))
            vc = v["vc"].mul_(beta).add_(
                _like((1 - beta) * g2.mean(dim=-2), v["vc"]))
            denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None]
                     ) * vc[..., None, :]
            u = g * torch.rsqrt(denom + cfg.eps)
        else:
            nv = v["v"].mul_(beta).add_(_like((1 - beta) * g2, v["v"]))
            u = g * torch.rsqrt(nv + cfg.eps)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p.copy_(_like(p.float() * (1 - cfg.weight_decay * lr) - lr * u, p))
    return params, state, {"lr": lr}
