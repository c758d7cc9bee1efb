"""AdamW (decoupled weight decay) with global-norm clipping: the port of
``repro/optim/adamw.py``.

The state is f32 and lives beside the parameters: ``{"m", "v"}`` trees of
the params' shapes and a 0-d int32 ``step``. :func:`update` writes the
parameters and the state in place under ``torch.no_grad()`` (the
counterpart of the reference's buffer donation) and returns them; on the
card it is one hand-written kernel (``kernels/adamw``, two launches).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10% of ``lr_peak`` (f32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    def zeros(p):     # a DTensor parameter's moments get its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    device = next(L.tree_leaves(params))[1].device
    return {"m": L.tree_map(zeros, params), "v": L.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in L.tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm`` in global norm, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return L.tree_map(lambda g: g * scale, grads), norm


def update(cfg: AdamWConfig, grads, state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` and ``state``, both written in place:
    (params, state, {"grad_norm", "lr"}). ``grads`` has the params' tree
    and is read in f32, clipped to ``cfg.clip_norm``.

    ``kernels.adamw.adamw_update`` chooses: the hand-written kernel on
    the card (on a mesh, on each rank's shards), its plain version on the
    CPU, for fake tensors and under a policy of mode "ref"."""
    from repro_torch.kernels.adamw import adamw_update
    return adamw_update(cfg, grads, state, params)
