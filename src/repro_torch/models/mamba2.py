"""Mamba2 (SSD) mixer: the port of ``repro/models/mamba2.py``.

The SSD recurrence h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) x_t runs, at
prefill, through the *inclusive* gated linear-attention scan
(``L.chunk_scan_op``: the CUDA kernel under ``scan_impl="ff"``, the
reference's chunked form under ``"xla"`` / ``"xla_tiled"``): C is the scan's q, B its
k, dt * x its v and A dt its log-decay, the last three broadcast across
heads as in the reference. The final state for decode and the
single-token decode recurrence are plain tensor code, as in the reference.

Prefill takes no ``lengths`` (the reference's argument is unused): a
right-padded prompt puts its pad tokens into the state (reference
``mamba2.py:75-120``); callers prefill prompts of one length.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime.sharding import batch_local, constrain


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def mamba_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, nh, n, hd = _dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "in_proj": L.ParamSpec((d, 2 * d_in + 2 * n + nh), ("embed", "mlp")),
        "conv_w": L.ParamSpec((cfg.conv_width, conv_dim), (None, "mlp"),
                              init="small"),
        "conv_b": L.ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "a_log": L.ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "dt_bias": L.ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": L.ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "norm_w": L.ParamSpec((d_in,), ("mlp",), init="ones"),
        "out_proj": L.ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    d_in, nh, n, hd = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * n]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. xbc: [B,S,C]; w: [W,C].
    prev: [B,W-1,C] carried state (decode). Returns (y, new_prev)."""
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros(xbc.shape[0], width - 1, xbc.shape[2],
                           dtype=xbc.dtype, device=xbc.device)
    xx = torch.cat([prev, xbc], dim=1)
    s = xbc.shape[1]
    y = xx[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        y = y + xx[:, i:i + s, :] * w[i][None, None, :]
    y = F.silu(y + b[None, None, :])
    new_prev = xx[:, -(width - 1):, :]
    return y, new_prev


def _ssd(cfg: ArchConfig, c_ssm, b_ssm, xs, log_w, dt, h):
    """The SSD scan by head: c/b [B,S,N], xs [B,S,NH,HD], log_w and dt
    [B,S,NH] (f32) -> (y [B,S,NH,HD], the final state [B*NH,N,HD] in
    f32). ``h``: the carried state for the single-token recurrence, or
    None for the chunked scan from an empty one."""
    b, s, nh, hd = xs.shape
    n = c_ssm.shape[-1]
    dtype = xs.dtype

    def to_bh(t):                                   # [B,S,*] -> [B*NH,S,*]
        return t[:, :, None, :].expand(b, s, nh, t.shape[-1]) \
            .transpose(1, 2).reshape(b * nh, s, t.shape[-1])

    q_bh = to_bh(c_ssm)
    k_bh = to_bh(b_ssm)
    v_bh = xs.transpose(1, 2).reshape(b * nh, s, hd)
    v_bh = (v_bh.float() * dt.transpose(1, 2).reshape(b * nh, s, 1)
            ).to(dtype)
    lw_bh = log_w.transpose(1, 2).reshape(b * nh, s, 1).expand(b * nh, s, n)

    if h is None:
        y = L.chunk_scan_op(q_bh, k_bh, v_bh, lw_bh, impl=cfg.scan_impl,
                            inclusive=True, chunk=cfg.scan_chunk)
        # final state for the prefill -> decode handoff, in f32:
        #   h_S = sum_s exp(cw_S - cw_s) k_s (x) v_s   (exponents <= 0)
        cw = torch.cumsum(lw_bh.float(), dim=1)                   # [BH,S,N]
        k2 = k_bh.float() * torch.exp(cw[:, -1:, :] - cw)
        h = torch.einsum("bsn,bsp->bnp", k2, v_bh.float())
    else:
        # the single-token recurrence
        w1 = torch.exp(lw_bh[:, 0, :])                            # [B*NH,N]
        kv = k_bh[:, 0, :, None] * v_bh[:, 0, None, :]            # [B*NH,N,HD]
        h = w1[:, :, None] * h + kv.float()
        y = torch.einsum("bn,bnp->bp", q_bh[:, 0].float(), h)
        y = y[:, None, :].to(dtype)                               # [B*NH,1,HD]
    return y.reshape(b, nh, s, hd).transpose(1, 2), h


def mamba_apply(cfg: ArchConfig, p, x, *, cache=None
                ) -> Tuple[torch.Tensor, Dict]:
    """x: [B,S,D]. cache (decode): {"conv": [B,W-1,C], "h": [B*NH,N,HD]}."""
    b, s, d = x.shape
    d_in, nh, n, hd = _dims(cfg)
    dtype = x.dtype
    zxbcdt = x @ p["in_proj"].to(dtype)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_prev = cache["conv"] if cache is not None else None
    xbc, conv_new = _causal_conv(xbc, p["conv_w"].to(dtype),
                                 p["conv_b"].to(dtype), conv_prev)
    x_ssm = xbc[..., :d_in]
    b_ssm = xbc[..., d_in:d_in + n]
    c_ssm = xbc[..., d_in + n:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])  # [B,S,NH]
    a = -torch.exp(p["a_log"].float())                            # [NH]
    log_w = dt * a[None, None, :]                                 # <= 0, f32

    xs = x_ssm.reshape(b, s, nh, hd)
    # the heads fold into the batch: a local body on each rank's batch rows
    # where the operands are DTensors
    y, h = batch_local(
        lambda c_, b_, x_, lw_, dt_, h_: _ssd(cfg, c_, b_, x_, lw_, dt_, h_),
        (c_ssm, b_ssm, xs, log_w, dt, None if cache is None else cache["h"]),
        n_out=2)
    new_cache = {"conv": conv_new, "h": h}
    y = y + xs * p["d_skip"].to(dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = L.rmsnorm(y * F.silu(z), p["norm_w"])
    y = constrain(y, ("batch", "seq", "mlp"))
    out = y @ p["out_proj"].to(dtype)
    return out, new_cache


def mamba_cache_spec(cfg: ArchConfig, batch: int):
    """One layer's state: the conv window [B, W-1, C] and the SSD state
    [B*NH, N, HD] in f32; with their logical axes."""
    d_in, nh, n, hd = _dims(cfg)
    conv_dim = d_in + 2 * n
    spec = {
        "conv": L.CacheSpec((batch, cfg.conv_width - 1, conv_dim),
                            cfg.cdtype),
        "h": L.CacheSpec((batch * nh, n, hd), torch.float32),
    }
    axes = {"conv": ("batch", None, "mlp"),
            "h": ("ssm_heads", "state", None)}
    return spec, axes
