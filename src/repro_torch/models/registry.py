"""Model registry (the port of ``repro/models/registry.py``): one class per
family with the serving entry points.

  prefill -> prefill(params, batch)            -> (last-token logits, cache)
  decode  -> decode_step(params, batch, cache) -> (logits, cache)

Only the dense family is ported; :func:`build_model` raises
``NotImplementedError`` for the others.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer


class BaseLM:
    """Decoder-only LM over the dense :class:`~transformer.DecoderStack`."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.stack = transformer.DecoderStack(cfg)

    # params ----------------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        s = {
            "embed": L.embed_specs(cfg.padded_vocab, cfg.d_model),
            "stack": self.stack.specs(),
            "final_norm": L.norm_specs(cfg.norm, cfg.d_model),
        }
        if not cfg.tie_embeddings:
            s["unembed"] = L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                       ("vocab", "embed"))
        return s

    def init(self, gen: torch.Generator, device="cpu") -> Dict[str, Any]:
        """Random parameters from a seeded generator living on ``device``
        (make it with ``torch.Generator(device=device).manual_seed(seed)``)."""
        return L.init_params(self.param_specs(), gen, device)

    # forward ---------------------------------------------------------------
    def _unembed(self, params):
        return (params["embed"] if self.cfg.tie_embeddings
                else params["unembed"])

    def prefill(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = L.embed_lookup(params["embed"], tokens, cfg.cdtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches = self.stack(params["stack"], x, positions=positions)
        x = L.norm_apply(cfg.norm, x, params["final_norm"])
        logits = L.unembed_logits(x[:, -1:], self._unembed(params))[:, 0]
        return logits, caches

    def decode_step(self, params, batch, caches):
        cfg = self.cfg
        lengths = batch["lengths"].to(torch.int32)
        x = L.embed_lookup(params["embed"], batch["token"][:, None],
                           cfg.cdtype)
        x, new_caches = self.stack(params["stack"], x,
                                   positions=lengths[:, None], caches=caches,
                                   lengths=lengths)
        x = L.norm_apply(cfg.norm, x, params["final_norm"])
        logits = L.unembed_logits(x, self._unembed(params))[:, 0]
        return logits, new_caches


class DenseLM(BaseLM):
    pass


_FAMILIES = {"dense": DenseLM}


def build_model(cfg: ArchConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch_id}) is not ported to "
            f"repro_torch yet; ported: {sorted(_FAMILIES)}")
    if cfg.attn_impl != "ff":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: repro_torch runs attention "
            f"through its kernels only (attn_impl='ff')")
    return _FAMILIES[cfg.family](cfg)

