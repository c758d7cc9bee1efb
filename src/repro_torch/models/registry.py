"""Model registry (the port of ``repro/models/registry.py``): one class per
family with the training and serving entry points.

  train   -> loss(params, batch)               -> (loss, metrics)
  prefill -> prefill(params, batch)            -> (last-token logits, cache)
  decode  -> decode_step(params, batch, cache) -> (logits, cache)

Every family of the reference is ported: dense (``DenseLM``), the MoE
families (``MoELM``: attention and the MoE FFN; ``MLAMoELM``: MLA and the
MoE FFN), ssm (``RWKVLM``), hybrid (``ZambaLM``), vlm (``VLM``: stubbed
patch embeddings before the tokens) and encdec (``EncDecLM``: whisper's
stubbed frames through an encoder, a decoder with cross-attention), each
with ``param_specs``, ``loss``, ``prefill`` and ``decode_step``. The loss
takes f32 parameters and casts each use to ``cfg.cdtype``, as the
reference trains (``cast_params`` is for serving); it keeps no per-layer
cache and rematerializes as ``cfg.remat`` says. :func:`build_model` raises
``ValueError`` for a family or an implementation switch it does not know.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_config
from repro_torch.models import encdec, hybrid
from repro_torch.models import layers as L
from repro_torch.models import mla, moe, rwkv6, transformer
from repro_torch.runtime.sharding import constrain


_TOKEN_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}


class BaseLM:
    """Decoder-only LM over :class:`~transformer.DecoderStack`; the mixer
    and FFN hooks cover dense, MoE and MLA."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.stack = transformer.DecoderStack(
            cfg, mixer_specs=self._mixer_specs(),
            mixer_apply=self._mixer_apply(),
            mixer_cache_spec=self._mixer_cache_spec(),
            ffn_specs=self._ffn_specs(), ffn_apply=self._ffn_apply())

    # hooks -----------------------------------------------------------------
    def _mixer_specs(self):
        return transformer.attn_specs

    def _mixer_apply(self):
        return transformer.attn_apply

    def _mixer_cache_spec(self):
        return transformer.attn_cache_spec

    def _ffn_specs(self):
        return transformer.ffn_specs

    def _ffn_apply(self):
        return transformer.ffn_apply

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

    def abstract_params(self) -> Dict[str, Any]:
        return L.abstract_params(self.param_specs())

    def param_axes(self) -> Dict[str, Any]:
        return L.param_axes(self.param_specs())

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The logical axes of a batch of ``shape.kind``."""
        if shape.kind == "train":
            return dict(_TOKEN_AXES)
        if shape.kind == "prefill":
            return {"tokens": ("batch", "seq")}
        return {"token": ("batch",), "lengths": ("batch",)}

    def cache_spec(self, shape: ShapeConfig):
        """(the decode cache's leaves as CacheSpecs, their logical axes)."""
        return self.stack.cache_spec(shape.global_batch, shape.seq_len)

    def param_count(self) -> int:
        return L.param_count(self.param_specs())

    def active_param_count(self) -> int:
        """Parameters a token runs through: an MoE config's experts past
        its top-k are not counted."""
        cfg = self.cfg
        n = self.param_count()
        if cfg.n_experts and cfg.top_k:
            per_expert = cfg.d_model * 3 * cfg.moe_d_ff
            n -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
        return n

    def init_cast(self, gen: torch.Generator, device="cpu") -> Dict[str, Any]:
        """``cast_params(init(gen, device))``, bit for bit, drawn and cast
        one leaf at a time: at most one leaf is ever held in f32, so a
        model whose f32 tree does not fit the card (deepseek-v2-lite:
        64.8 GB) still draws there."""
        out: Dict[str, Any] = {}
        for path, spec in L.tree_leaves(self.param_specs()):
            L._put(out, path, self._cast(path, spec.initializer(gen, device)))
        return out

    # The leaves that the forward also reads in f32, by path prefix: the
    # norms' weights (and LayerNorm biases), which the norms take with
    # ``.float()``. Every other leaf is only ever used through
    # ``.to(cfg.cdtype)``.
    F32_LEAVES = (("final_norm",), ("stack", "layers", "norm1"),
                  ("stack", "layers", "norm2"))

    def _cast(self, path, leaf: torch.Tensor) -> torch.Tensor:
        keep = any(path[:len(p)] == p for p in self.F32_LEAVES)
        return leaf if keep else leaf.to(self.cfg.cdtype)

    def cast_params(self, params) -> Dict[str, Any]:
        """The same params tree with every leaf outside
        :attr:`F32_LEAVES` stored in ``cfg.cdtype``, cast once here: the
        forward's per-use ``.to(cfg.cdtype)`` is then a no-op and the
        logits are the same bits. Leaves in :attr:`F32_LEAVES` are the
        given tensors."""
        out: Dict[str, Any] = {}
        for path, leaf in L.tree_leaves(params):
            L._put(out, path, self._cast(path, leaf))
        return out

    # forward ---------------------------------------------------------------
    def _unembed(self, params):
        return (params["embed"] if self.cfg.tie_embeddings
                else params["unembed"])

    def _extra_embeds(self, params, batch):
        """Embeddings put before the tokens at prefill ([B, n, D]), or
        None."""
        return None

    def _trunk(self, params, batch, *, want_cache: bool):
        """Embeddings (after any extra ones), the stack, the final norm:
        (x, caches, aux, number of extra positions)."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg.cdtype)
        extra = self._extra_embeds(params, batch)
        n_extra = 0
        if extra is not None:
            x = torch.cat([extra.to(cfg.cdtype), x], dim=1)
            n_extra = extra.shape[1]
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches, aux = self.stack(params["stack"], x, positions=positions,
                                    want_cache=want_cache)
        x = L.norm_apply(cfg.norm, x, params["final_norm"])
        return x, caches, aux, n_extra

    def loss(self, params, batch):
        """Mean next-token CE (f32, with the z-loss) over ``labels`` [B, S],
        plus 0.01 x the MoE load-balance aux: (loss, {"loss", "aux"})."""
        cfg = self.cfg
        x, _, aux, n_extra = self._trunk(params, batch, want_cache=False)
        if n_extra:
            x = x[:, n_extra:]
        loss = _lm_loss(cfg, x, self._unembed(params), batch["labels"])
        # a dense stack's aux is a Python 0.0: filled on the device (a copy
        # from host memory could not be captured in a compiled step)
        aux = (aux.to(torch.float32) if isinstance(aux, torch.Tensor)
               else torch.full((), aux, dtype=torch.float32,
                               device=loss.device))
        loss = loss + 0.01 * aux
        return loss, {"loss": loss, "aux": aux}

    def prefill(self, params, batch):
        x, caches, _, _ = self._trunk(params, batch, want_cache=True)
        logits = L.unembed_logits(x[:, -1:], self._unembed(params))[:, 0]
        return logits, caches

    def decode_step(self, params, batch, caches):
        cfg = self.cfg
        lengths = batch["lengths"].to(torch.int32)
        x = L.embed_lookup(params["embed"], batch["token"][:, None],
                           cfg.cdtype)
        x, new_caches, _ = self.stack(params["stack"], x,
                                      positions=lengths[:, None],
                                      caches=caches, lengths=lengths)
        x = L.norm_apply(cfg.norm, x, params["final_norm"])
        logits = L.unembed_logits(x, self._unembed(params))[:, 0]
        return logits, new_caches


class DenseLM(BaseLM):
    pass


class MoELM(BaseLM):
    """grok-1: attention and the MoE FFN. The router is read in f32."""

    F32_LEAVES = BaseLM.F32_LEAVES + (("stack", "layers", "ffn", "router"),)

    def _ffn_specs(self):
        return moe.moe_ffn_specs

    def _ffn_apply(self):
        return moe.moe_ffn_apply


class MLAMoELM(MoELM):
    """deepseek-v2: MLA and the MoE FFN. The latent's RMSNorm weight is
    read in f32 too."""

    F32_LEAVES = MoELM.F32_LEAVES + (("stack", "layers", "mixer",
                                      "kv_norm"),)

    def _mixer_specs(self):
        return mla.mla_specs

    def _mixer_apply(self):
        return mla.mla_apply

    def _mixer_cache_spec(self):
        return mla.mla_cache_spec


class VLM(DenseLM):
    """internvl2: stubbed ViT patch embeddings ``image_embeds`` [B,
    n_patches, D], projected by ``vision_proj``, prepended to the tokens
    at prefill; positions and the cache run over patches then tokens. A
    prefill without ``image_embeds`` is the dense LM's."""

    def param_specs(self) -> Dict[str, Any]:
        s = super().param_specs()
        d = self.cfg.d_model
        s["vision_proj"] = L.ParamSpec((d, d), ("embed", None))
        return s

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        a = super().input_axes(shape)
        if shape.kind in ("train", "prefill"):
            a["image_embeds"] = ("batch", "patches", "embed")
        return a

    def cache_spec(self, shape: ShapeConfig):
        # the cache covers patches then tokens
        return self.stack.cache_spec(shape.global_batch,
                                     shape.seq_len + self.cfg.n_patches)

    def _extra_embeds(self, params, batch):
        if "image_embeds" not in batch:
            return None
        x = batch["image_embeds"].to(self.cfg.cdtype)
        return x @ params["vision_proj"].to(x.dtype)


class ZambaLM(BaseLM):
    """zamba2 hybrid (Mamba2 + shared attention). A decode cache's
    ``attn[i]`` leaves must be longer than the prompt (see
    :mod:`repro_torch.models.hybrid`)."""

    # the RMSNorm weights (the gated norm's norm_w too), the SSD's a_log
    # (``.float()``) and dt_bias (added to the f32 dt)
    F32_LEAVES = (("final_norm",), ("stack", "mamba_layers", "norm"),
                  ("stack", "mamba_layers", "mixer", "a_log"),
                  ("stack", "mamba_layers", "mixer", "dt_bias"),
                  ("stack", "mamba_layers", "mixer", "norm_w"),
                  ("stack", "shared", "norm1"), ("stack", "shared", "norm2"))

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_specs(cfg.padded_vocab, cfg.d_model),
            "stack": hybrid.specs(cfg),
            "final_norm": L.norm_specs(cfg.norm, cfg.d_model),
            "unembed": L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed")),
        }

    def _trunk(self, params, batch, *, caches=None, lengths=None,
               want_cache=True):
        cfg = self.cfg
        if "token" in batch:
            x = L.embed_lookup(params["embed"], batch["token"][:, None],
                               cfg.cdtype)
            positions = lengths[:, None]
        else:
            x = L.embed_lookup(params["embed"], batch["tokens"], cfg.cdtype)
            positions = torch.arange(x.shape[1], device=x.device)
        x, new_caches = hybrid.forward(cfg, params["stack"], x,
                                       positions=positions, caches=caches,
                                       lengths=lengths, want_cache=want_cache)
        return L.norm_apply(cfg.norm, x, params["final_norm"]), new_caches

    def loss(self, params, batch):
        x, _ = self._trunk(params, batch, want_cache=False)
        loss = _lm_loss(self.cfg, x, params["unembed"], batch["labels"])
        return loss, {"loss": loss,
                      "aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}

    def prefill(self, params, batch):
        x, caches = self._trunk(params, batch)
        logits = L.unembed_logits(x[:, -1:], params["unembed"])[:, 0]
        return logits, caches

    def decode_step(self, params, batch, caches):
        lengths = batch["lengths"].to(torch.int32)
        x, new_caches = self._trunk(params, batch, caches=caches,
                                    lengths=lengths)
        logits = L.unembed_logits(x, params["unembed"])[:, 0]
        return logits, new_caches

    def cache_spec(self, shape: ShapeConfig):
        return hybrid.cache_spec(self.cfg, shape.global_batch, shape.seq_len)


class RWKVLM(BaseLM):
    """rwkv6: token-shift time and channel mixing, attention-free. Its
    cache is the per-layer recurrent state, stacked ``[L, ...]``."""

    # the LayerNorm weights and biases (``.float()``), the decay base w0
    # (``.float()``) and the bonus u (the scan's f32 operand)
    F32_LEAVES = (("ln0",), ("final_norm",), ("layers", "ln1"),
                  ("layers", "ln2"), ("layers", "tm", "w0"),
                  ("layers", "tm", "u"))

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        one = {
            "ln1": L.norm_specs("layernorm", cfg.d_model),
            "tm": rwkv6.time_mix_specs(cfg),
            "ln2": L.norm_specs("layernorm", cfg.d_model),
            "cm": rwkv6.channel_mix_specs(cfg),
        }
        stacked = L.tree_map(
            lambda s: L.ParamSpec((cfg.n_layers, *s.shape),
                                  ("layers", *s.axes), s.dtype, s.init,
                                  s.scale), one)
        return {
            "embed": L.embed_specs(cfg.padded_vocab, cfg.d_model),
            "ln0": L.norm_specs("layernorm", cfg.d_model),
            "layers": stacked,
            "final_norm": L.norm_specs("layernorm", cfg.d_model),
            "unembed": L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed")),
        }

    def _layer(self, p, x, cache):
        cfg = self.cfg
        h = L.norm_apply("layernorm", x, p["ln1"])
        tm_out, tm_cache = rwkv6.time_mix_apply(cfg, p["tm"], h, cache=cache)
        x = x + tm_out
        h = L.norm_apply("layernorm", x, p["ln2"])
        cm_out, cm_cache = rwkv6.channel_mix_apply(cfg, p["cm"], h,
                                                   cache=cache)
        x = constrain(x + cm_out, ("batch", "seq_sp", "embed"))
        return x, {**tm_cache, **cm_cache}

    def _trunk(self, params, x, caches, want_cache=True):
        """The layers and the final norm: (x, the new states stacked, or
        None on the loss path). Under autograd, without caches, each layer
        saves nothing for the backward unless ``cfg.remat`` is "none"."""
        cfg = self.cfg
        layer = self._layer
        if caches is None and cfg.remat != "none":
            layer = L.remat(layer, "full")
        per_layer = []
        for i, p in enumerate(L.unstack(params["layers"], cfg.n_layers)):
            c = (L.tree_map(lambda a: a[i], caches)
                 if caches is not None else None)
            x, nc = layer(p, x, c)
            per_layer.append(nc)
        new_caches = None
        if want_cache or caches is not None:
            new_caches = {name: torch.stack([c[name] for c in per_layer])
                          for name in per_layer[0]}
        return L.norm_apply("layernorm", x, params["final_norm"]), new_caches

    def _embed(self, params, tokens):
        x = L.embed_lookup(params["embed"], tokens, self.cfg.cdtype)
        return L.norm_apply("layernorm", x, params["ln0"])

    def loss(self, params, batch):
        x, _ = self._trunk(params, self._embed(params, batch["tokens"]),
                           None, want_cache=False)
        loss = _lm_loss(self.cfg, x, params["unembed"], batch["labels"])
        return loss, {"loss": loss}

    def prefill(self, params, batch):
        x, caches = self._trunk(params, self._embed(params, batch["tokens"]),
                                None)
        logits = L.unembed_logits(x[:, -1:], params["unembed"])[:, 0]
        return logits, caches

    def decode_step(self, params, batch, caches):
        x = self._embed(params, batch["token"][:, None])
        x, new_caches = self._trunk(params, x, caches)
        logits = L.unembed_logits(x, params["unembed"])[:, 0]
        return logits, new_caches

    def cache_spec(self, shape: ShapeConfig):
        cfg = self.cfg
        one, one_axes = rwkv6.rwkv_cache_spec(cfg, shape.global_batch)
        spec = L.tree_map(
            lambda s: L.CacheSpec((cfg.n_layers, *s.shape), s.dtype), one)
        axes = {name: ("layers", *a) for name, a in one_axes.items()}
        return spec, axes


class EncDecLM(BaseLM):
    """whisper-tiny: stubbed conv frontend (``frames`` [B, n_frames, D])
    and the encoder-decoder of :mod:`repro_torch.models.encdec`. Prefill
    takes {"tokens", "frames"}; its cache is {"self", "cross"} (pad the
    self cache's axis 2 before decode steps; the cross K/V stay as they
    are). Its attention is the reference's unfused path whatever
    ``attn_impl`` says (see :mod:`~repro_torch.models.encdec`)."""

    # every LayerNorm's weight and bias (``.float()``)
    F32_LEAVES = tuple(("encdec", *p) for p in (
        ("enc_layers", "norm1"), ("enc_layers", "norm2"), ("enc_norm",),
        ("dec_layers", "norm1"), ("dec_layers", "norm_x"),
        ("dec_layers", "norm2"), ("dec_norm",)))

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": L.embed_specs(cfg.padded_vocab, cfg.d_model),
            "encdec": encdec.specs(cfg),
            "unembed": L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed")),
        }

    def _decoder_in(self, params, batch):
        """The frames through the encoder, and the tokens' embeddings with
        their learned positions."""
        cfg = self.cfg
        enc_out = encdec.encode(cfg, params["encdec"], batch["frames"])
        x = L.embed_lookup(params["embed"], batch["tokens"], cfg.cdtype)
        x = x + params["encdec"]["dec_pos"][:x.shape[1]].to(x.dtype)[None]
        return x, enc_out

    def loss(self, params, batch):
        """Full-vocab CE (the reference's encdec loss takes no
        ``loss_chunk``)."""
        x, enc_out = self._decoder_in(params, batch)
        x, _ = encdec.decode_stack(self.cfg, params["encdec"], x, enc_out,
                                   want_cache=False)
        logits = L.unembed_logits(x, params["unembed"])
        loss = L.cross_entropy(logits, batch["labels"])
        return loss, {"loss": loss}

    def prefill(self, params, batch):
        cfg = self.cfg
        x, enc_out = self._decoder_in(params, batch)
        x, caches = encdec.decode_stack(cfg, params["encdec"], x, enc_out)
        logits = L.unembed_logits(x[:, -1:], params["unembed"])[:, 0]
        return logits, caches

    def decode_step(self, params, batch, caches):
        cfg = self.cfg
        lengths = batch["lengths"].to(torch.int32)
        x = L.embed_lookup(params["embed"], batch["token"][:, None],
                           cfg.cdtype)
        pos = params["encdec"]["dec_pos"][lengths.long()]
        x = x + pos[:, None, :].to(x.dtype)
        x, new_caches = encdec.decode_stack(cfg, params["encdec"], x, None,
                                            caches=caches, lengths=lengths)
        logits = L.unembed_logits(x, params["unembed"])[:, 0]
        return logits, new_caches

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Any]:
        a = super().input_axes(shape)
        if shape.kind in ("train", "prefill"):
            a["frames"] = ("batch", "frames", "embed")
        return a

    def cache_spec(self, shape: ShapeConfig):
        return encdec.cache_spec(self.cfg, shape.global_batch, shape.seq_len)


def _lm_loss(cfg: ArchConfig, x, table, labels):
    """The CE of hidden states ``x`` [B,S,D] against ``labels`` [B,S]
    through the unembedding ``table``: chunked over the sequence where
    ``cfg.loss_chunk > 1``."""
    if cfg.loss_chunk > 1:
        return L.chunked_unembed_loss(x, table, labels, cfg.loss_chunk)
    return L.cross_entropy(L.unembed_logits(x, table), labels)


_FAMILIES = {"dense": DenseLM, "moe": MoELM, "moe_mla": MLAMoELM,
             "ssm": RWKVLM, "hybrid": ZambaLM, "encdec": EncDecLM,
             "vlm": VLM}


def build_model(cfg: ArchConfig):
    """The model class of ``cfg.family`` ("moe" with ``kv_lora_rank`` set is
    "moe_mla", as in the reference)."""
    family = cfg.family
    if family == "moe" and cfg.kv_lora_rank:
        family = "moe_mla"
    if family not in _FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    if cfg.attn_impl not in L.ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} is not one of "
                         f"{L.ATTN_IMPLS}")
    if cfg.scan_impl not in L.SCAN_IMPLS:
        raise ValueError(f"scan_impl={cfg.scan_impl!r} is not one of "
                         f"{L.SCAN_IMPLS}")
    if family == "moe_mla" and cfg.attn_impl != "xla":
        raise ValueError(
            f"MLA ({cfg.arch_id}) runs only under attn_impl='xla': its v "
            f"head dim ({cfg.v_head_dim}) differs from q's "
            f"({cfg.qk_nope_dim + cfg.qk_rope_dim}), which the attention "
            f"kernels, and the reference's 'ff' path, cannot take")
    return _FAMILIES[family](cfg)


def build_model_by_id(arch_id: str):
    return build_model(get_config(arch_id))
