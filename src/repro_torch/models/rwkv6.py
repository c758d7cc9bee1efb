"""RWKV6 ("Finch"), attention-free with a data-dependent decay: the port of
``repro/models/rwkv6.py``.

Per layer: a time-mixing block whose wkv operator is the *exclusive* gated
linear-attention scan with a per-channel decay w_t and a current-token
bonus u (``L.chunk_scan_op(..., inclusive=False)``: the CUDA kernel under
``scan_impl="ff"``, the reference's chunked form under ``"xla"`` /
``"xla_tiled"``), plus a squared-ReLU channel-mixing FFN. Token shift is the static
per-channel lerp, with a low-rank data-dependent term for the decay only,
as in the reference.

A multi-token call on a carried state (prefill on top of a cache) keeps
the reference's behaviour: the scan's ``y`` leaves the carried state out,
while ``h_new`` decays it in (reference ``rwkv6.py:261-276``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime.sharding import batch_local, constrain

_DECAY_LORA = 64


def _dims(cfg: ArchConfig):
    hd = cfg.ssm_head_dim or 64
    return cfg.d_model // hd, hd     # (n_heads, head_dim)


def time_mix_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    nh, hd = _dims(cfg)
    return {
        "mu_r": L.ParamSpec((d,), ("embed",), init="small"),
        "mu_k": L.ParamSpec((d,), ("embed",), init="small"),
        "mu_v": L.ParamSpec((d,), ("embed",), init="small"),
        "mu_w": L.ParamSpec((d,), ("embed",), init="small"),
        "mu_g": L.ParamSpec((d,), ("embed",), init="small"),
        "wr": L.ParamSpec((d, d), ("embed", "heads")),
        "wk": L.ParamSpec((d, d), ("embed", "heads")),
        "wv": L.ParamSpec((d, d), ("embed", "heads")),
        "wg": L.ParamSpec((d, d), ("embed", "heads")),
        "w0": L.ParamSpec((d,), ("heads",), init="small"),
        "w_lora_a": L.ParamSpec((d, _DECAY_LORA), ("embed", None),
                                init="small"),
        "w_lora_b": L.ParamSpec((_DECAY_LORA, d), (None, "heads"),
                                init="small"),
        "u": L.ParamSpec((nh, hd), ("ssm_heads", None), init="small"),
        "ln_w": L.ParamSpec((d,), ("heads",), init="ones"),
        "ln_b": L.ParamSpec((d,), ("heads",), init="zeros"),
        "wo": L.ParamSpec((d, d), ("heads", "embed")),
    }


def channel_mix_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": L.ParamSpec((d,), ("embed",), init="small"),
        "mu_r": L.ParamSpec((d,), ("embed",), init="small"),
        "wk": L.ParamSpec((d, f), ("embed", "mlp")),
        "wv": L.ParamSpec((f, d), ("mlp", "embed")),
        "wr": L.ParamSpec((d, d), ("embed", None)),
    }


def _shift(x, prev: Optional[torch.Tensor]):
    """Token shift: x_{t-1} (zeros, or the carried state, at t = 0).
    x: [B,S,D]; prev: [B,D] or None. Returns (shifted, new_prev)."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :], x[:, -1, :]
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1), x[:, -1, :]


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu[None, None, :].to(x.dtype)


def _wkv(cfg: ArchConfig, r, k, v, log_w, h, u_p, *, step: bool):
    """The wkv scan of [B,S,D] operands by head: (y [B,S,NH,HD], the new
    state [B*NH,N,P]). ``h``: the carried state, or None from an empty
    one; a single token on a carried state (``step``) takes the
    recurrence."""
    b, s, _ = r.shape
    nh, hd = _dims(cfg)
    dt = r.dtype

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2).reshape(b * nh, s, hd)

    u = u_p[None].expand(b, nh, hd).reshape(b * nh, hd)

    if not step or s > 1:
        y = L.chunk_scan_op(heads(r), heads(k), heads(v), heads(log_w), u,
                            impl=cfg.scan_impl, inclusive=False,
                            chunk=cfg.scan_chunk)
        # final state for the prefill -> decode handoff (operands in the
        # compute type, f32 accumulation)
        lw = heads(log_w).float()
        cw = torch.cumsum(lw, dim=1)
        k2 = heads(k) * torch.exp(cw[:, -1:, :] - cw).to(dt)
        h_new = torch.einsum("bsn,bsp->bnp", k2.float(), heads(v).float())
        if step:
            # a window on top of a carried state: decay the state through it
            h_new = h_new + torch.exp(cw[:, -1, :])[:, :, None] * h
    else:
        rr, kk, vv = heads(r)[:, 0], heads(k)[:, 0], heads(v)[:, 0]
        lw = heads(log_w)[:, 0].float()
        kv = kk[:, :, None].float() * vv[:, None, :].float()
        y = torch.einsum("bn,bnp->bp", rr.float(),
                         h + u[:, :, None] * kv)[:, None, :].to(dt)
        h_new = torch.exp(lw)[:, :, None] * h + kv
    return y.reshape(b, nh, s, hd).transpose(1, 2), h_new


def time_mix_apply(cfg: ArchConfig, p, x, *, cache=None
                   ) -> Tuple[torch.Tensor, Dict]:
    b, s, d = x.shape
    nh, hd = _dims(cfg)
    dt = x.dtype
    prev = cache["shift_tm"] if cache is not None else None
    x_prev, new_prev = _shift(x, prev)

    r = _lerp(x, x_prev, p["mu_r"]) @ p["wr"].to(dt)
    k = _lerp(x, x_prev, p["mu_k"]) @ p["wk"].to(dt)
    v = _lerp(x, x_prev, p["mu_v"]) @ p["wv"].to(dt)
    g = _lerp(x, x_prev, p["mu_g"]) @ p["wg"].to(dt)
    xw = _lerp(x, x_prev, p["mu_w"])
    w_dd = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
    # log decay, < 0: w = exp(-exp(w0 + lora)), carried in the compute type
    # (the scan clamps and upcasts it for its f32 cumsum)
    log_w = -torch.exp(torch.clamp(
        p["w0"][None, None, :].float() + w_dd.float(), -8.0, 8.0))
    log_w = log_w.to(dt)                                          # [B,S,D]

    # the heads fold into the batch: a local body on each rank's batch rows
    # where the operands are DTensors
    y, h_new = batch_local(
        lambda r_, k_, v_, lw_, h_, u_: _wkv(cfg, r_, k_, v_, lw_, h_, u_,
                                             step=cache is not None),
        (r, k, v, log_w, None if cache is None else cache["h"]), (p["u"],),
        n_out=2)
    # per-head group norm
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(b, s, d) * p["ln_w"].to(dt) + p["ln_b"].to(dt)
    y = y * F.silu(g)
    y = constrain(y, ("batch", "seq", "heads"))
    out = y @ p["wo"].to(dt)
    return out, {"shift_tm": new_prev, "h": h_new}


def channel_mix_apply(cfg: ArchConfig, p, x, *, cache=None
                      ) -> Tuple[torch.Tensor, Dict]:
    dt = x.dtype
    prev = cache["shift_cm"] if cache is not None else None
    x_prev, new_prev = _shift(x, prev)
    xk = _lerp(x, x_prev, p["mu_k"])
    xr = _lerp(x, x_prev, p["mu_r"])
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    k = constrain(k, ("batch", "seq", "mlp"))
    kv = k @ p["wv"].to(dt)
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * kv
    return out, {"shift_cm": new_prev}


def rwkv_cache_spec(cfg: ArchConfig, batch: int):
    """One layer's recurrent state: the two token-shift rows and the wkv
    state [B*NH, HD, HD] in f32; with their logical axes."""
    nh, hd = _dims(cfg)
    spec = {
        "shift_tm": L.CacheSpec((batch, cfg.d_model), cfg.cdtype),
        "shift_cm": L.CacheSpec((batch, cfg.d_model), cfg.cdtype),
        "h": L.CacheSpec((batch * nh, hd, hd), torch.float32),
    }
    axes = {"shift_tm": ("batch", "embed"), "shift_cm": ("batch", "embed"),
            "h": ("ssm_heads", "state", None)}
    return spec, axes
