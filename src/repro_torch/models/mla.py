"""Multi-head Latent Attention (deepseek-v2) mixer: the port of
``repro/models/mla.py``.

KV is compressed to a ``kv_lora_rank`` latent plus one shared RoPE key;
the decode cache holds only ``c`` [B, S, kv_lora] and ``k_rope`` [B, S,
rope]. Decode writes this token's latent into the cache (in place, the
clamped sync-free write of :func:`transformer._write_token`), decompresses
the whole cached latent into per-head k and v each step and attends with
``impl="xla"``, as the reference does (the weight-absorbed form would be a
feature the reference lacks).

Prefill attends with ``cfg.attn_impl``, which must be ``"xla"``: v's head
dim differs from q's, which the kernels' layout (and the reference's
``"ff"`` path) cannot take; :func:`~repro_torch.models.build_model`
refuses MLA under ``"ff"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _project, _write_token
from repro_torch.runtime.sharding import constrain


def mla_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    r, nope, rope_d, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                           cfg.qk_rope_dim, cfg.v_head_dim)
    return {
        "wq": L.ParamSpec((d, h, nope + rope_d), ("embed", "heads", None)),
        "wdkv": L.ParamSpec((d, r + rope_d), ("embed", None)),
        "kv_norm": L.norm_specs("rmsnorm", r),
        "wuk": L.ParamSpec((r, h, nope), (None, "heads", None)),
        "wuv": L.ParamSpec((r, h, vd), (None, "heads", None)),
        "wo": L.ParamSpec((h, vd, d), ("heads", None, "embed")),
    }


def _compress(cfg: ArchConfig, p, x):
    """x: [B,S,D] -> latent c [B,S,r], k_rope [B,S,rope]."""
    ckv = x @ p["wdkv"].to(x.dtype)
    c, k_rope = torch.split(ckv, [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    return L.rmsnorm(c, p["kv_norm"]["w"]), k_rope


def _decompress(cfg: ArchConfig, p, c, k_rope, positions):
    """latent -> per-head k [B,S,H,nope+rope], v [B,S,H,vd]."""
    k_nope = _project(c, p["wuk"])
    v = _project(c, p["wuv"])
    k_rope = L.rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    k_rope = k_rope.expand(*k_nope.shape[:3], cfg.qk_rope_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def mla_apply(cfg: ArchConfig, p, x, *, positions, cache=None,
              lengths=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,D]. cache (decode): {"c", "k_rope"} [B,Smax,·], updated in
    place; returns (out [B,S,D], new_cache)."""
    q = _project(x, p["wq"])
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    q = torch.cat([q_nope, L.rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    c, k_rope = _compress(cfg, p, x)
    if cache is None:
        k, v = _decompress(cfg, p, c, k_rope, positions)
        q = constrain(q, ("batch", "seq", "heads", None))
        out = L.attention_op(q, k, v, causal=True, impl=cfg.attn_impl)
        new_cache = {"c": c, "k_rope": k_rope}
    else:
        cc, cr = _write_token(cache, {"c": c, "k_rope": k_rope}, lengths)
        # decompress the whole cached latent stream (the explicit form)
        pos = torch.arange(cc.shape[1], device=x.device)[None, :]
        k, v = _decompress(cfg, p, cc, cr, pos)
        out = L.decode_attention_op(q[:, 0], k, v, lengths + 1,
                                    impl="xla")[:, None]
        new_cache = {"c": cc, "k_rope": cr}
    b, s, h, vd = out.shape
    wo = p["wo"].reshape(h * vd, -1).to(x.dtype)
    return out.reshape(b, s, h * vd) @ wo, new_cache


def mla_cache_spec(cfg: ArchConfig, batch: int, s_max: int):
    """The latent cache's leaves and their logical axes."""
    spec = {"c": L.CacheSpec((batch, s_max, cfg.kv_lora_rank), cfg.cdtype),
            "k_rope": L.CacheSpec((batch, s_max, cfg.qk_rope_dim),
                                  cfg.cdtype)}
    axes = {"c": ("batch", "kv", None), "k_rope": ("batch", "kv", None)}
    return spec, axes
