"""MoE dispatch -> expert matmul -> combine: the port of the
``moe_dispatch_ffn`` StreamGraph of ``repro/models/moe.py``.

``dispatch`` gathers the routed token rows, ``expert`` multiplies them by
the expert weight, ``combine`` gathers the expert outputs back into token
order. The dispatch->expert edge is one launch
(:func:`repro_torch.kernels.ff_matmul.dispatch_matmul`: the A rows are
read through the index, so the dispatched buffer never exists in HBM); the
combine is an irregular gather of the expert output and is staged through
HBM, as in the reference. The MoE layer (``moe_ffn_apply``, ``MoELM``) is
not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch import ops
from repro_torch.kernels.ff_gather import gather, gather_ref
from repro_torch.kernels.ff_matmul import dispatch_matmul, dispatch_matmul_ref

_ROWS = 8        # the reference's gather row bundle (ff_gather _ROWS)


def moe_dispatch_ffn_ref(idx, tokens, w1, comb) -> torch.Tensor:
    """Plain version (the port of the reference's ``_moe_graph_ref``): the
    expert product in f32, rounded to the tokens' type before the combine,
    as the graph rounds."""
    return gather_ref(dispatch_matmul_ref(tokens, idx, w1), comb)


def _moe_graph_unfused(idx, tokens, w1, comb) -> torch.Tensor:
    """The same computation as three separate ``repro_torch.ops`` calls:
    every intermediate round-trips HBM. The reference pins the expert
    matmul to the graph's 8-row tile (``block=``) so that only the
    lowering differs; the port's kernels pick their own tiles, so nothing
    is pinned."""
    h = ops.gather(tokens, idx)
    y = ops.matmul(h, w1)
    return ops.gather(y, comb)


def moe_dispatch_ffn(idx, tokens, w1, comb) -> torch.Tensor:
    """Dispatch -> expert matmul -> combine at the caller's shapes.

    idx: [n_dispatch] int rows into ``tokens``; tokens: [T, d_model]; w1:
    [d_model, d_ff]; comb: [t_out] int rows into the expert output; every
    index in range (unchecked on the card). ``n_dispatch`` and ``t_out``
    must be multiples of 8, the reference's gather row bundle. Returns
    [t_out, d_ff] = ``(tokens[idx] @ w1)[comb]`` in the tokens' type,
    equal bit for bit to :func:`_moe_graph_unfused` on the card."""
    n, t_out = idx.shape[0], comb.shape[0]
    if n % _ROWS or t_out % _ROWS:
        raise ValueError(f"n_dispatch={n} / t_out={t_out} must be "
                         f"multiples of the {_ROWS}-row gather bundle")
    return gather(dispatch_matmul(tokens, idx, w1), comb)
