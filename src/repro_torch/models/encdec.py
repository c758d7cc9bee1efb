"""Whisper-style encoder-decoder backbone (the port of
``repro/models/encdec.py``).

The conv/audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings [B, n_frames, d_model] (what the two conv
layers would emit). The encoder is a non-causal transformer over frames
with sinusoidal positions; the decoder is a causal transformer with
learned positions and cross-attention, whose K/V are computed once from
the encoder output at prefill and read from the cache at every decode
step.

Every attention here is the reference's unfused formulation
(:func:`~repro_torch.models.layers.attention_xla`, and
``decode_attention_op(impl="xla")`` for the decode self-attention),
whatever ``cfg.attn_impl`` says: the reference's ``_mha`` calls them
directly, so this path launches no kernel of the port, on purpose. RoPE
is skipped (whisper uses absolute positions) and the attention weights'
biases, where a config has them, are not read (as in the reference).
The layers run in a plain loop (the reference's ``scan_layers`` is a JAX
trace device). Under autograd every encoder and decoder layer saves
nothing for the backward unless ``cfg.remat`` is "none", as in the
reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import device_table
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.runtime.sharding import constrain, product_output


def specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    enc_layer = {
        "norm1": L.norm_specs(cfg.norm, d),
        "attn": transformer.attn_specs(cfg),
        "norm2": L.norm_specs(cfg.norm, d),
        "ffn": L.mlp_specs(d, cfg.d_ff, cfg.act),
    }
    dec_layer = {
        "norm1": L.norm_specs(cfg.norm, d),
        "self_attn": transformer.attn_specs(cfg),
        "norm_x": L.norm_specs(cfg.norm, d),
        "cross_attn": transformer.attn_specs(cfg),
        "norm2": L.norm_specs(cfg.norm, d),
        "ffn": L.mlp_specs(d, cfg.d_ff, cfg.act),
    }

    def stack(one, n):
        return L.tree_map(
            lambda s: L.ParamSpec((n, *s.shape), ("layers", *s.axes),
                                  s.dtype, s.init, s.scale), one)

    return {
        "enc_layers": stack(enc_layer, cfg.n_enc_layers),
        "enc_norm": L.norm_specs(cfg.norm, d),
        "dec_layers": stack(dec_layer, cfg.n_layers),
        "dec_norm": L.norm_specs(cfg.norm, d),
        "dec_pos": L.ParamSpec((4096 * 9, d), (None, "embed"), init="small"),
    }


def _mha(p, xq, xkv, *, causal: bool, cache=None, lengths=None):
    """Self or cross attention on a layer's attention weights; returns
    (out [B,S,D], cache). ``cache`` with ``xkv=None`` is the cross K/V
    computed at prefill; a cache with ``xkv`` given is the decode
    self-attention cache [B,Smax,KVH,hd], this token written into it in
    place at ``lengths`` without a host sync."""
    q = transformer._project(xq, p["wq"])
    if cache is not None and xkv is None:
        k, v = cache["k"], cache["v"]
        out = L.attention_xla(q, k, v, causal=False)
    else:
        k = transformer._project(xkv, p["wk"])
        v = transformer._project(xkv, p["wv"])
        if cache is not None:
            k, v = transformer._write_token(cache, {"k": k, "v": v}, lengths)
            out = L.decode_attention_op(q[:, 0], k, v, lengths + 1,
                                        impl="xla")[:, None]
        else:
            out = L.attention_xla(q, k, v, causal=causal)
        cache = {"k": k, "v": v}
    b, s, h, hd = out.shape
    wo = p["wo"].reshape(h * hd, -1).to(xq.dtype)
    return product_output(out.reshape(b, s, h * hd) @ wo), cache


@device_table
def _positions(s: int, d: int, device: torch.device) -> torch.Tensor:
    """The sinusoidal table on ``device``, moved there once: the first
    (eager) call of a compiled step fills this, and its capture reads the
    same tensor (a copy from host memory cannot be captured). Under a fake
    mode (the dry run) it is made afresh and never cached
    (:func:`~repro_torch.kernels.device_table`)."""
    return L.sinusoidal_positions(s, d).to(device)


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B,F,D] stub embeddings -> encoder output [B,F,D]."""
    x = frames + _positions(frames.shape[1], cfg.d_model,
                            frames.device).to(frames.dtype)[None]
    x = constrain(x, ("batch", "frames", "embed"))

    def body(p, x):
        h = L.norm_apply(cfg.norm, x, p["norm1"])
        x = x + _mha(p["attn"], h, h, causal=False)[0]
        h = L.norm_apply(cfg.norm, x, p["norm2"])
        return constrain(x + L.mlp_apply(p["ffn"], h, cfg.act),
                         ("batch", "frames", "embed"))

    if cfg.remat != "none":
        body = L.remat(body, "full")
    for p in L.unstack(params["enc_layers"], cfg.n_enc_layers):
        x = body(p, x)
    return L.norm_apply(cfg.norm, x, params["enc_norm"])


def decode_stack(cfg: ArchConfig, params, x: torch.Tensor,
                 enc_out: Optional[torch.Tensor], *, caches=None,
                 lengths=None, want_cache: bool = True):
    """x: [B,S,D] token embeddings (positions added by the caller).
    Prefill (``caches=None``) attends across to ``enc_out`` and returns
    the per-layer caches stacked ``[L, ...]``: {"self": {"k","v"},
    "cross": {"k","v"}}; the loss path (``want_cache=False``) returns
    None instead. Decode takes those caches (the self cache padded to
    Smax), ``enc_out=None``, and ``lengths`` [B]; it updates the self
    cache in place and returns the caches it was given."""

    def layer(p, x, sc, cc):
        h = L.norm_apply(cfg.norm, x, p["norm1"])
        a, new_self = _mha(p["self_attn"], h, h, causal=True, cache=sc,
                           lengths=lengths)
        x = x + a
        h = L.norm_apply(cfg.norm, x, p["norm_x"])
        a, new_cross = _mha(p["cross_attn"], h,
                            enc_out if cc is None else None, causal=False,
                            cache=cc)
        x = x + a
        h = L.norm_apply(cfg.norm, x, p["norm2"])
        x = x + L.mlp_apply(p["ffn"], h, cfg.act)
        x = constrain(x, ("batch", "seq", "embed"))
        return x, new_self, new_cross

    if caches is None and cfg.remat != "none":
        layer = L.remat(layer, "full")
    per_layer = []
    for i, p in enumerate(L.unstack(params["dec_layers"], cfg.n_layers)):
        sc = cc = None
        if caches is not None:
            sc = L.tree_map(lambda a: a[i], caches["self"])
            cc = L.tree_map(lambda a: a[i], caches["cross"])
        x, new_self, new_cross = layer(p, x, sc, cc)
        per_layer.append((new_self, new_cross))
    x = L.norm_apply(cfg.norm, x, params["dec_norm"])
    if caches is not None:
        return x, caches
    if not want_cache:
        return x, None
    return x, {kind: {name: torch.stack([c[j][name] for c in per_layer])
                      for name in ("k", "v")}
               for j, kind in enumerate(("self", "cross"))}


def cache_spec(cfg: ArchConfig, batch: int, s_max: int):
    """The decode cache's leaves ({"self", "cross"}, each {"k","v"}
    stacked ``[L, ...]``) and their logical axes."""
    kv = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.hd)
    cross = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
    spec = {"self": {"k": L.CacheSpec(kv, cfg.cdtype),
                     "v": L.CacheSpec(kv, cfg.cdtype)},
            "cross": {"k": L.CacheSpec(cross, cfg.cdtype),
                      "v": L.CacheSpec(cross, cfg.cdtype)}}
    ax_kv = ("layers", "batch", "kv", "kv_heads", None)
    ax_cross = ("layers", "batch", "frames", "kv_heads", None)
    axes = {"self": {"k": ax_kv, "v": ax_kv},
            "cross": {"k": ax_cross, "v": ax_cross}}
    return spec, axes
