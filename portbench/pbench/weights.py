"""The weights, drawn by the harness from ``--seed`` on the device, in
the parameter tree the port's model takes and the types it serves: norms
(and the router) in float32, every other leaf in the config's type.

One ``torch.Generator`` on the device draws the stacked ``[L, ...]``
leaves in a fixed order, one call a leaf, scaled in place: projections by
one over the square root of the width they contract, and the two that
write into the residual stream (attention's output, the MLP's or the
experts' down projection) by 1 / sqrt(2 L) more (GPT-2's scaled
initialisation), so a deep stack keeps each token's identity instead of
collapsing every position onto one output; biases at 0.1 and norm
weights at 1 + 0.1 x N(0, 1), so every bias and norm weight matters to
the output the reference checks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from pbench.model import Model

_BIAS = 0.1


def _leaves(m: Model) -> Dict[Tuple[str, ...], Tuple[tuple, str, float]]:
    """path -> (shape, kind, scale); kind "w" (served type), "f32", or
    "norm_w" (f32, around 1)."""
    L, d, h, kvh, hd, f = m.layers, m.d, m.heads, m.kv_heads, m.hd, m.ff
    res = 1 / math.sqrt(2 * L)          # projections into the residual
    out = {
        ("embed",): ((m.vocab, d), "w", 1.0),
        ("unembed",): ((m.vocab, d), "w", 1 / math.sqrt(d)),
        ("final_norm", "w"): ((d,), "norm_w", _BIAS),
    }
    lay = ("stack", "layers")
    for n in ("norm1", "norm2"):
        out[lay + (n, "w")] = ((L, d), "norm_w", _BIAS)
    if m.norm == "layernorm":
        out[("final_norm", "b")] = ((d,), "f32", _BIAS)
        for n in ("norm1", "norm2"):
            out[lay + (n, "b")] = ((L, d), "f32", _BIAS)
    mix = lay + ("mixer",)
    out[mix + ("wq",)] = ((L, d, h, hd), "w", 1 / math.sqrt(d))
    out[mix + ("wk",)] = ((L, d, kvh, hd), "w", 1 / math.sqrt(d))
    out[mix + ("wv",)] = ((L, d, kvh, hd), "w", 1 / math.sqrt(d))
    out[mix + ("wo",)] = ((L, h, hd, d), "w", res / math.sqrt(h * hd))
    if m.bias:
        out[mix + ("bq",)] = ((L, h, hd), "w", _BIAS)
        out[mix + ("bk",)] = ((L, kvh, hd), "w", _BIAS)
        out[mix + ("bv",)] = ((L, kvh, hd), "w", _BIAS)
    ffn = lay + ("ffn",)
    if m.experts:
        e = m.experts
        out[ffn + ("router",)] = ((L, d, e), "f32", 1 / math.sqrt(d))
        out[ffn + ("w1",)] = ((L, e, d, 2 * f), "w", 1 / math.sqrt(d))
        out[ffn + ("w2",)] = ((L, e, f, d), "w", res / math.sqrt(f))
    elif m.gelu:
        out[ffn + ("wi",)] = ((L, d, f), "w", 1 / math.sqrt(d))
        out[ffn + ("bi",)] = ((L, f), "w", _BIAS)
        out[ffn + ("wo",)] = ((L, f, d), "w", res / math.sqrt(f))
        out[ffn + ("bo",)] = ((L, d), "w", _BIAS)
    else:
        out[ffn + ("wi",)] = ((L, d, 2 * f), "w", 1 / math.sqrt(d))
        out[ffn + ("wo",)] = ((L, f, d), "w", res / math.sqrt(f))
    return out


def draw(m: Model, seed: int, device, into: Optional[Dict] = None) -> Dict:
    """The parameter tree from ``seed``, on ``device``; with ``into`` (a
    tree :func:`draw` made), the same values written into its tensors, so
    whatever holds them by address (a captured graph) reads the new
    ones."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    served = getattr(torch, m.dtype)
    tree: Dict = {} if into is None else into
    leaves = _leaves(m)
    for path in sorted(leaves):
        shape, kind, scale = leaves[path]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        x = node.get(path[-1]) if into is not None else None
        if x is None:
            dt = served if kind == "w" else torch.float32
            x = torch.empty(shape, dtype=dt, device=device)
        x.normal_(generator=gen)
        x.mul_(scale)
        if kind == "norm_w":
            x.add_(1.0)
        node[path[-1]] = x
    return tree


def flat(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree
