"""The plain reference: a decoder-only transformer's full forward pass in
float32, in plain PyTorch, from a configuration file's keys and the
harness's weights. It imports nothing of the program.

What it computes, as the configuration file states it: the embedding;
per layer a pre-norm (LayerNorm with a bias, or RMSNorm), q/k/v
projections (with biases where ``use_bias``), rotary embeddings on the
first and second half of each head (``rope_theta``), causal grouped-query
attention at a scale of one over the square root of the head size, the
output projection and the residual; a second pre-norm and either a biased
tanh-GELU MLP, or sparse experts: a float32 softmax router, the top
``num_experts_per_tok`` experts renormalised to sum to one, each a SwiGLU,
no token dropped; the final norm and the untied head.

It runs a layer at a time over every sequence given, each layer's
weights cast to float32 once (an expert at a time), with TF32 off, so it
fits beside the served weights on the card.

``low="fp8"`` is the control: the step below bfloat16 that a faster
program would take, the operands of every product with a weight (the
projections, the MLP or the experts, the head) rounded to float8 e4m3,
each tensor under one scale (its largest magnitude at the type's
largest), accumulated and kept in float32; every other value as in the
reference.

Where the configuration states a ``sliding_window``, a position attends
to that many positions up to itself.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

_Q_BLOCK = 512
_E4M3_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale, its largest magnitude at
    the type's largest."""
    s = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Low:
    """A product with a weight (:meth:`mm`) in ``low`` (None: float32)."""

    def __init__(self, low):
        if low not in (None, "fp8"):
            raise ValueError(f"unknown precision {low!r}")
        self.fp8 = low == "fp8"

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _round_fp8(a) @ _round_fp8(w)
        return a @ w


def _norm(c: Dict, x, w, b=None):
    eps = float(c["norm_eps"])
    if c["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [S, H, hd] at positions 0 .. S-1 (angles in float64)."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window=None):
    """Causal GQA, each position over the ``window`` positions up to
    itself (None: all). q: [S, H, hd]; k, v: [S, KVH, hd] ->
    [S, H * hd]."""
    s, h, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    kt = k.permute(1, 2, 0)                          # [KVH, hd, S]
    vt = v.permute(1, 0, 2)                          # [KVH, S, hd]
    out = torch.empty(s, h * hd, dtype=q.dtype, device=q.device)
    for lo_ in range(0, s, _Q_BLOCK):
        hi = min(s, lo_ + _Q_BLOCK)
        qb = q[lo_:hi].reshape(hi - lo_, kvh, g, hd).permute(1, 2, 0, 3)
        sc = (qb @ kt[:, None, :, :hi]) / math.sqrt(hd)   # [KVH,G,B,hi]
        rows = torch.arange(lo_, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        mask = cols > rows
        if window:
            mask |= cols <= rows - int(window)
        sc = sc.masked_fill(mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        ob = p @ vt[:, None, :hi]                    # [KVH, G, B, hd]
        out[lo_:hi] = ob.permute(2, 0, 1, 3).reshape(hi - lo_, h * hd)
    return out


def _experts(c: Dict, lo: _Low, h: List[torch.Tensor], router, w1, w2):
    """Sparse experts over each sequence's rows ``h``; ``w1``/``w2`` the
    layer's stacked served weights, cast an expert at a time."""
    k = int(c["num_experts_per_tok"])
    picks = []
    for x in h:
        gates = torch.softmax(x @ router, dim=-1)
        p, idx = torch.topk(gates, k, dim=-1)
        picks.append((idx, p / (p.sum(-1, keepdim=True) + 1e-9)))
    outs = [torch.zeros_like(x) for x in h]
    for e in range(w1.shape[0]):
        a_w, b_w = w1[e].float(), w2[e].float()
        for x, (idx, p), out in zip(h, picks, outs):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            gate, up = lo.mm(x[tok], a_w).chunk(2, dim=-1)
            y = lo.mm(F.silu(gate) * up, b_w)
            out.index_add_(0, tok, y * p[tok, slot][:, None])
    return outs


def _layer(c: Dict, lo: _Low, lw: Dict, xs: List[torch.Tensor]):
    d = int(c["hidden_size"])
    mix, ffn = lw["mixer"], lw["ffn"]
    f32 = {k: t.float() for k, t in mix.items()}
    heads, kvh = f32["wq"].shape[1], f32["wk"].shape[1]
    hd = f32["wq"].shape[2]
    theta = float(c["rope_theta"])

    def proj(h, name, n):
        y = lo.mm(h, f32["w" + name].reshape(d, -1)).view(-1, n, hd)
        return y + f32["b" + name] if "b" + name in f32 else y

    hs = []
    for i, x in enumerate(xs):
        h = _norm(c, x, lw["norm1"]["w"], lw["norm1"].get("b"))
        q = _rope(proj(h, "q", heads), theta)
        k = _rope(proj(h, "k", kvh), theta)
        a = _attention(q, k, proj(h, "v", kvh),
                       c.get("sliding_window"))
        x = x + lo.mm(a, f32["wo"].reshape(heads * hd, d))
        xs[i] = x
        hs.append(_norm(c, x, lw["norm2"]["w"], lw["norm2"].get("b")))
    del f32
    if c.get("num_local_experts"):
        ys = _experts(c, lo, hs, ffn["router"].float(), ffn["w1"],
                      ffn["w2"])
    else:
        wi, wo = ffn["wi"].float(), ffn["wo"].float()
        bi, bo = ffn["bi"].float(), ffn["bo"].float()
        ys = [lo.mm(F.gelu(lo.mm(h, wi) + bi, approximate="tanh"), wo) + bo
              for h in hs]
    for i, y in enumerate(ys):
        xs[i] = xs[i] + y


def _pick(tree, i):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def logits(c: Dict, weights: Dict, seqs: Sequence[torch.Tensor],
           positions: Sequence[torch.Tensor], *, low=None
           ) -> List[torch.Tensor]:
    """Float32 logits [len(positions[i]), vocab] of sequence ``i`` (token
    ids) at ``positions[i]``, from the full causal forward pass (``low``:
    see the module's docstring)."""
    lo = _Low(low)
    with torch.no_grad(), _no_tf32():
        xs = [weights["embed"][s.long()].float() for s in seqs]
        layers = weights["stack"]["layers"]
        for li in range(int(c["num_hidden_layers"])):
            _layer(c, lo, _pick(layers, li), xs)
        fn = weights["final_norm"]
        head = weights["unembed"].float().t()
        out = []
        for x, pos in zip(xs, positions):
            h = _norm(c, x[pos.long()], fn["w"], fn.get("b"))
            out.append(lo.mm(h, head))
        return out
