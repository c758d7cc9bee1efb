"""Decoder-only transformer (GQA + RoPE), the backbone of the dense and
MoE families: the port of ``repro/models/transformer.py`` for the serving
path.

Layer math is injectable as in the reference (``mixer_specs`` /
``mixer_apply`` / ``mixer_cache_spec`` for attention or MLA,
``ffn_specs`` / ``ffn_apply`` for the dense or MoE FFN). Params keep the
reference's stacked ``[L, ...]`` layout; the stack is a plain loop over
layers (the reference's ``scan_layers`` is a JAX trace device). Under
autograd each layer is rematerialized as ``cfg.remat`` says
(:func:`remat`), and the loss path (``want_cache=False``) keeps no
per-layer cache.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime.paged_kv import scatter_token
from repro_torch.runtime.sharding import as_dtensor, constrain, follow, \
    is_dtensor, kept, product_operand, product_output


# ---------------------------------------------------------------------------
# GQA attention mixer
# ---------------------------------------------------------------------------


def attn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": L.ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": L.ParamSpec((d, kvh, hd), ("embed", "kv_heads", None)),
        "wv": L.ParamSpec((d, kvh, hd), ("embed", "kv_heads", None)),
        "wo": L.ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = L.ParamSpec((h, hd), ("heads", None), init="zeros")
        s["bk"] = L.ParamSpec((kvh, hd), ("kv_heads", None), init="zeros")
        s["bv"] = L.ParamSpec((kvh, hd), ("kv_heads", None), init="zeros")
    return s


def _project(x, w, b=None):
    """einsum("bsd,dhk->bshk") as one matmul, plus the optional bias."""
    x = product_operand(x)
    d, h, k = w.shape
    y = product_output(x @ w.reshape(d, h * k).to(x.dtype)).unflatten(
        -1, (h, k))
    return y if b is None else y + b.to(x.dtype)


def _write_token(cache, new, lengths):
    """Write this token's rows (``new``: name -> [B,1,...]) into the cache
    leaves of the same names ([B,Smax,...]) at ``lengths``, in place and
    without a host sync; returns those leaves in ``new``'s order."""
    leaves = [cache[name] for name in new]
    if any(is_dtensor(t) for t in (*leaves, *new.values())):
        return [_write_token_sharded(leaf, t, lengths)
                for leaf, t in zip(leaves, new.values())]
    # dynamic_update_slice clamps the start so the row fits
    idx = lengths.long().clamp(0, leaves[0].shape[1] - 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for leaf, t in zip(leaves, new.values()):
        leaf[rows, idx] = t[:, 0]
    return leaves


def _write_token_sharded(leaf, t, lengths):
    """:func:`_write_token` of one DTensor cache leaf, in place, as a local
    body: each rank writes the rows of its batch shard whose position
    falls in its slice of the sequence (``decode_32k`` shards the
    sequence over "model"), so no rank gathers the cache."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = leaf.device_mesh
    leaf_pl = list(leaf.placements)
    # this rank's slice of the sequence: DTensor's even split, mesh dims
    # outermost first
    s_max = leaf.shape[1]
    s_off, size = 0, s_max
    for i, p in enumerate(leaf_pl):
        if p == Shard(1):
            chunk = -(-size // mesh.size(i))
            start = min(mesh.get_coordinate()[i] * chunk, size)
            s_off, size = s_off + start, min(chunk, size - start)
    t_pl = kept(leaf_pl, (0, 2, 3))
    n_pl = follow(t_pl, 0, 1)

    def write(leaf_, t_, n_):
        idx = n_.long().clamp(0, s_max - 1) - s_off
        inside = (idx >= 0) & (idx < leaf_.shape[1])
        idx = idx.clamp(0, leaf_.shape[1] - 1)
        rows = torch.arange(idx.shape[0], device=idx.device)
        keep = inside.view(-1, *([1] * (t_.dim() - 2)))
        leaf_[rows, idx] = torch.where(keep, t_[:, 0].to(leaf_.dtype),
                                       leaf_[rows, idx])
        return leaf_

    body = local_map(write, out_placements=leaf_pl,
                     in_placements=(leaf_pl, t_pl, n_pl), device_mesh=mesh,
                     redistribute_inputs=True)
    return body(leaf, as_dtensor(t, leaf), as_dtensor(lengths, leaf))


def attn_apply(cfg: ArchConfig, p, x, *, positions, cache=None,
               lengths=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B,S,D]. cache (decode): dense {"k","v": [B,Smax,KVH,hd]} or
    paged {"kv_pool", "block_tables"}; returns (out [B,S,D], new_cache).
    Decode caches are updated in place (the reference returns new ones)."""
    q = _project(x, p["wq"], p.get("bq"))
    k = _project(x, p["wk"], p.get("bk"))
    v = _project(x, p["wv"], p.get("bv"))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cache is None:
        q = constrain(q, ("batch", "seq", "heads", None))
        out = L.attention_op(q, k, v, causal=True, impl=cfg.attn_impl)
        # cache layout: seq dim re-sharded per the "kv" rule
        new_cache = {"k": constrain(k, ("batch", "kv", "kv_heads", None)),
                     "v": constrain(v, ("batch", "kv", "kv_heads", None))}
    elif "kv_pool" in cache:
        # paged decode: append this token's K/V through the block table,
        # then attend through it (sentinel entries drop the write and mask
        # the read, so inactive continuous-batching slots are inert)
        pool = scatter_token(cache["kv_pool"], cache["block_tables"],
                             lengths, k[:, 0], v[:, 0],
                             n_blocks=cache["kv_pool"].shape[0])
        out = L.paged_decode_attention_op(
            q[:, 0], pool, cache["block_tables"], lengths + 1,
            impl=cfg.attn_impl)[:, None]
        new_cache = {"kv_pool": pool, "block_tables": cache["block_tables"]}
    else:
        ck, cv = _write_token(cache, {"k": k, "v": v}, lengths)
        out = L.decode_attention_op(q[:, 0], ck, cv, lengths + 1,
                                    impl=cfg.attn_impl,
                                    block_kv=cfg.decode_block_kv)[:, None]
        new_cache = {"k": ck, "v": cv}
    b, s, h, hd = out.shape
    wo = p["wo"].reshape(h * hd, -1).to(x.dtype)
    return product_output(out.reshape(b, s, h * hd) @ wo), new_cache


def attn_cache_spec(cfg: ArchConfig, batch: int, s_max: int):
    """The dense KV cache's leaves and their logical axes."""
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    spec = {"k": L.CacheSpec(shape, cfg.cdtype),
            "v": L.CacheSpec(shape, cfg.cdtype)}
    axes = {"k": ("batch", "kv", "kv_heads", None),
            "v": ("batch", "kv", "kv_heads", None)}
    return spec, axes


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def ffn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)


def ffn_apply(cfg: ArchConfig, p, x):
    """(out, aux loss): a dense FFN has none, a Python 0.0 (the reference's
    f32 zero) that adds no kernel to a step."""
    return L.mlp_apply(p, x, cfg.act), 0.0


# ---------------------------------------------------------------------------
# Decoder stack
# ---------------------------------------------------------------------------


class DecoderStack:
    """Stacked pre-norm decoder with an injectable mixer and FFN: params
    are stacked ``[L, ...]`` as in the reference, and the layers run in a
    plain loop."""

    def __init__(self, cfg: ArchConfig, mixer_specs=attn_specs,
                 mixer_apply=attn_apply, mixer_cache_spec=attn_cache_spec,
                 ffn_specs=ffn_specs, ffn_apply=ffn_apply):
        self.cfg = cfg
        self._mixer_specs = mixer_specs
        self._mixer_apply = mixer_apply
        self._mixer_cache_spec = mixer_cache_spec
        self._ffn_specs = ffn_specs
        self._ffn_apply = ffn_apply

    def layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "norm1": L.norm_specs(cfg.norm, cfg.d_model),
            "mixer": self._mixer_specs(cfg),
            "norm2": L.norm_specs(cfg.norm, cfg.d_model),
            "ffn": self._ffn_specs(cfg),
        }

    def specs(self) -> Dict[str, Any]:
        n = self.cfg.n_layers
        return {"layers": L.tree_map(
            lambda s: L.ParamSpec((n, *s.shape), ("layers", *s.axes),
                                  s.dtype, s.init, s.scale),
            self.layer_specs())}

    def cache_spec(self, batch: int, s_max: int):
        """The decode cache's leaves stacked ``[L, ...]`` and their logical
        axes."""
        n = self.cfg.n_layers
        one, one_axes = self._mixer_cache_spec(self.cfg, batch, s_max)
        spec = L.tree_map(lambda s: L.CacheSpec((n, *s.shape), s.dtype), one)
        axes = {name: ("layers", *a) for name, a in one_axes.items()}
        return spec, axes

    def _mixer_half(self, p, x, positions, cache, lengths):
        h = L.norm_apply(self.cfg.norm, x, p["norm1"])
        return self._mixer_apply(self.cfg, p["mixer"], h, positions=positions,
                                 cache=cache, lengths=lengths)

    def _ffn_half(self, p, x):
        h = L.norm_apply(self.cfg.norm, x, p["norm2"])
        return self._ffn_apply(self.cfg, p["ffn"], h)

    def _layer(self, p, x, positions, cache, lengths, want_cache=True,
               halves=None):
        """One pre-norm layer: (x, its cache or None, aux). ``halves``
        replaces the mixer and FFN halves (``remat="collectives"``
        checkpoints each on its own)."""
        cfg = self.cfg
        if (cfg.layer_graph and cache is not None and "kv_pool" not in cache
                and x.shape[1] == 1 and cfg.norm == "rmsnorm"
                and cfg.act == "swiglu"
                and self._mixer_apply is attn_apply
                and self._ffn_apply is ffn_apply):
            return self._decode_layer_graph(p, x, positions, cache, lengths)
        mixer_half, ffn_half = halves or (self._mixer_half, self._ffn_half)
        attn_out, new_cache = mixer_half(p, x, positions, cache, lengths)
        x = x + attn_out
        ffn_out, aux = ffn_half(p, x)
        x = x + ffn_out
        # residual saves use the SP axis (None by default; "model" enables
        # Megatron sequence parallelism for layer-boundary activations)
        x = constrain(x, ("batch", "seq_sp", "embed"))
        if cfg.bf16_grads:
            x = L.bf16_grad_cast(x)   # backward: the boundary cotangent
        if not want_cache and cache is None:
            new_cache = None          # train mode: never keep a layer's K/V
        return x, new_cache, aux

    def _decode_layer_graph(self, p, x, positions, cache, lengths):
        """One dense-cache decode step through :func:`L.decode_layer`
        (q-projection, attention and the MLP tail in three launches). The
        K/V projection and the cache write stay outside it, as in the
        reference, where they are XLA ops."""
        cfg = self.cfg
        dt = x.dtype
        mp, fp = p["mixer"], p["ffn"]
        h1 = L.norm_apply(cfg.norm, x, p["norm1"])
        k = L.rope(_project(h1, mp["wk"], mp.get("bk")), positions,
                   cfg.rope_theta)
        v = _project(h1, mp["wv"], mp.get("bv"))
        ck, cv = _write_token(cache, {"k": k, "v": v}, lengths)
        d, h_q, hd = cfg.d_model, cfg.n_heads, cfg.hd

        def layer(x_, nw1, wq, bq, pos, ck_, cv_, n_, wo, nw2, wi, wo2):
            wi = wi.to(dt)
            f = wi.shape[1] // 2
            return L.decode_layer(
                x_[:, 0], nw1, wq.to(dt).reshape(d, h_q * hd),
                None if bq is None else bq.to(dt).reshape(h_q * hd),
                pos[:, -1], ck_.transpose(1, 2), cv_.transpose(1, 2), n_ + 1,
                wo.to(dt).reshape(h_q * hd, d), nw2, wi[:, :f], wi[:, f:],
                wo2.to(dt), rope_theta=cfg.rope_theta,
                block_kv=cfg.decode_block_kv)[:, None]

        args = (x, p["norm1"]["w"], mp["wq"],
                mp["bq"] if cfg.qkv_bias else None, positions, ck, cv,
                lengths, mp["wo"], p["norm2"]["w"], fp["wi"], fp["wo"])
        if not is_dtensor(x):
            return layer(*args), {"k": ck, "v": cv}, 0.0
        # on a mesh every rank runs the three launches on whole operands
        # (the reference's graph under GSPMD runs on gathered ones), and
        # the output takes x's placements again
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map
        rep = [Replicate()] * x.device_mesh.ndim
        body = local_map(layer, out_placements=rep,
                         in_placements=tuple(None if a is None else rep
                                             for a in args),
                         device_mesh=x.device_mesh, redistribute_inputs=True)
        out = body(*(None if a is None else as_dtensor(a, x) for a in args))
        return (out.redistribute(x.device_mesh, x.placements),
                {"k": ck, "v": cv}, 0.0)

    def _remat_layer(self) -> Callable:
        """The layer rematerialized as ``cfg.remat`` says (the reference's
        ``_remat_layer``): "full" saves nothing inside a layer, "dots"
        the products' outputs, "collectives" the mixer's and the FFN's
        outputs (each half checkpointed on its own: what a backward keeps
        of a layer is its input and ``x + attn_out``)."""
        cfg = self.cfg
        if cfg.remat == "collectives":
            return functools.partial(self._layer, halves=(
                L.remat(self._mixer_half, "full"),
                L.remat(self._ffn_half, "full")))
        return L.remat(self._layer, cfg.remat)

    def __call__(self, params, x, *, positions, caches=None, lengths=None,
                 want_cache: bool = False):
        """x: [B,S,D]. caches: stacked ``[L, ...]`` leaves or None.
        Returns (x, caches, aux loss summed over the layers): prefill
        (``caches=None, want_cache=True``) stacks the per-layer caches,
        the loss path (``want_cache=False``) keeps none and returns None,
        decode returns the (in-place updated) caches. Under autograd,
        without caches, each layer is rematerialized as ``cfg.remat``
        says."""
        cfg = self.cfg
        layer = self._layer
        if caches is None and torch.is_grad_enabled() and cfg.remat != "none":
            layer = self._remat_layer()
        per_layer = []
        aux = 0.0
        for i, p in enumerate(L.unstack(params["layers"], cfg.n_layers)):
            cache = (L.tree_map(lambda a: a[i], caches)
                     if caches is not None else None)
            x, nc, a = layer(p, x, positions, cache, lengths, want_cache)
            per_layer.append(nc)
            aux = aux + a
        if caches is not None:
            return x, caches, aux
        if not want_cache:
            return x, None, aux
        return x, {name: torch.stack([c[name] for c in per_layer])
                   for name in per_layer[0]}, aux
