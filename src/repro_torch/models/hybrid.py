"""zamba2 hybrid stack: Mamba2 blocks and one shared attention block (the
port of ``repro/models/hybrid.py``).

Layer layout (attn_every_n = k): segments of k Mamba2 blocks, each
followed by one application of the *shared* transformer block (attention
and MLP, one weight set, one KV cache per application). 54 Mamba2 layers
/ k = 6 -> 9 shared-block applications. The Mamba2 params are stacked
``[L, ...]`` as in the reference; the layers run in a plain loop (the
reference's ``scan_layers`` is a JAX trace device). Under autograd every
Mamba2 layer and shared-block application saves nothing for the backward
unless ``cfg.remat`` is "none", as in the reference.

Decode writes each application's new K/V row at ``lengths`` in place
(``transformer.attn_apply``), so its cache must be longer than the prompt:
prefill returns caches exactly as long as the prompt, and the caller pads
each ``attn[i]`` leaf on its sequence axis (``launch/serve.py:
pad_cache_to``) before decoding.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2, transformer
from repro_torch.runtime.sharding import constrain


def _n_segments(cfg: ArchConfig) -> int:
    k = cfg.attn_every_n or cfg.n_layers
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                         f"attn_every_n={k}")
    return cfg.n_layers // k


def specs(cfg: ArchConfig) -> Dict[str, Any]:
    one = {
        "norm": L.norm_specs(cfg.norm, cfg.d_model),
        "mixer": mamba2.mamba_specs(cfg),
    }
    stacked = L.tree_map(
        lambda s: L.ParamSpec((cfg.n_layers, *s.shape), ("layers", *s.axes),
                              s.dtype, s.init, s.scale), one)
    shared = {
        "norm1": L.norm_specs(cfg.norm, cfg.d_model),
        "attn": transformer.attn_specs(cfg),
        "norm2": L.norm_specs(cfg.norm, cfg.d_model),
        "ffn": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }
    return {"mamba_layers": stacked, "shared": shared}


def _mamba_layer(cfg, p, x, cache):
    h = L.norm_apply(cfg.norm, x, p["norm"])
    out, new_cache = mamba2.mamba_apply(cfg, p["mixer"], h, cache=cache)
    return x + out, new_cache


def _shared_block(cfg, p, x, positions, cache, lengths):
    h = L.norm_apply(cfg.norm, x, p["norm1"])
    attn_out, new_cache = transformer.attn_apply(
        cfg, p["attn"], h, positions=positions, cache=cache, lengths=lengths)
    x = x + attn_out
    h = L.norm_apply(cfg.norm, x, p["norm2"])
    return constrain(x + L.mlp_apply(p["ffn"], h, cfg.act),
                     ("batch", "seq", "embed")), new_cache


def forward(cfg: ArchConfig, params, x, *, positions, caches=None,
            lengths=None, want_cache: bool = True):
    """x: [B,S,D]. caches: {"mamba": stacked [L, ...] leaves, "attn": one
    {"k", "v"} per segment}, or None (prefill, and the loss path with
    ``want_cache=False``). Returns (x, new_caches): the new Mamba2 states
    stacked afresh, the attention caches (prefill's as long as the prompt;
    decode's updated in place); None on the loss path."""
    nseg = _n_segments(cfg)
    k = cfg.attn_every_n or cfg.n_layers
    mamba_fn, shared_fn = _mamba_layer, _shared_block
    if caches is None and cfg.remat != "none":
        mamba_fn = L.remat(mamba_fn, "full")
        shared_fn = L.remat(shared_fn, "full")
    keep = want_cache or caches is not None
    layers = L.unstack(params["mamba_layers"], cfg.n_layers)
    mamba_new, attn_new = [], []
    for seg in range(nseg):
        for i in range(seg * k, (seg + 1) * k):
            c_i = (L.tree_map(lambda a: a[i], caches["mamba"])
                   if caches is not None else None)
            x, nc = mamba_fn(cfg, layers[i], x, c_i)
            mamba_new.append(nc)
        attn_cache = caches["attn"][seg] if caches is not None else None
        x, nac = shared_fn(cfg, params["shared"], x, positions, attn_cache,
                           lengths)
        attn_new.append(nac)
    if not keep:
        return x, None
    mamba = {name: torch.stack([c[name] for c in mamba_new])
             for name in mamba_new[0]}
    return x, {"mamba": mamba, "attn": attn_new}


def cache_spec(cfg: ArchConfig, batch: int, s_max: int):
    """The stacked Mamba2 states and one KV cache per segment, with their
    logical axes."""
    nseg = _n_segments(cfg)
    m_one, m_axes = mamba2.mamba_cache_spec(cfg, batch)
    m_spec = L.tree_map(
        lambda s: L.CacheSpec((cfg.n_layers, *s.shape), s.dtype), m_one)
    m_axes = {name: ("layers", *a) for name, a in m_axes.items()}
    a_one, a_axes = transformer.attn_cache_spec(cfg, batch, s_max)
    spec = {"mamba": m_spec, "attn": [a_one] * nseg}
    axes = {"mamba": m_axes, "attn": [a_axes] * nseg}
    return spec, axes
