"""Mixture-of-experts FFN (grok-1, deepseek-v2-lite) and the MoE
dispatch -> expert matmul -> combine graph: the port of
``repro/models/moe.py``.

The layer (:func:`moe_ffn_apply`) routes by capacity-based top-k: tokens
are scattered into an ``[E, C, d]`` dispatch buffer, the experts run as two
batched products over the whole buffer (the reference's XLA einsums: every
expert's weights are read whatever the routing), and the results gather
back weighted by the router's probabilities. A token past its expert's
capacity ``C`` is dropped (standard token-dropping MoE). Every shape is
static and no step reads a value back to the host, so a compiled step
captures the layer.

``moe_dispatch_ffn`` is the port of the ``moe_dispatch_ffn`` StreamGraph:
``dispatch`` gathers the routed token rows, ``expert`` multiplies them by
the expert weight, ``combine`` gathers the expert outputs back into token
order. The dispatch->expert edge is one launch
(:func:`repro_torch.kernels.ff_matmul.dispatch_matmul`: the A rows are
read through the index, so the dispatched buffer never exists in HBM); the
combine is an irregular gather of the expert output and is staged through
HBM, as in the reference. It is a library entry point: the layer does not
run through it, as the reference's layer does not.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ArchConfig
from repro_torch.core import autotune
from repro_torch.core.program import current_policy
from repro_torch.kernels.ff_gather import gather, gather_ref
from repro_torch.kernels.ff_gather.ops import gather_workload
from repro_torch.kernels.ff_gather.ops import max_depth as gather_max_depth
from repro_torch.kernels.ff_matmul import dispatch_matmul, dispatch_matmul_ref
from repro_torch.kernels.ff_matmul.ops import MAX_DEPTH as MM_MAX_DEPTH
from repro_torch.kernels.ff_matmul.ops import matmul_workload
from repro_torch.kernels.ff_matmul.ops import \
    stream_options as mm_stream_options
from repro_torch.models import layers as L
from repro_torch.runtime.sharding import as_dtensor, constrain, is_dtensor


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------


def moe_ffn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "router": L.ParamSpec((d, e), ("embed", None), scale=0.02),
        "w1": L.ParamSpec((e, d, 2 * f), ("expert", "embed", "mlp")),
        "w2": L.ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_specs(d, cfg.n_shared_experts * cfg.moe_d_ff,
                                  "swiglu")
    return s


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """[..., E] int64 one-hot rows, without the host check that
    ``F.one_hot`` makes on some devices."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def router_gates(p, xf: torch.Tensor) -> torch.Tensor:
    """The router's probabilities [T, E] over tokens ``xf`` [T, D], in f32
    on the f32 router, as the reference computes them."""
    return torch.softmax(xf.float() @ p["router"].float(), dim=-1)


def _dispatch_indices(gates: torch.Tensor, top_k: int, capacity: int):
    """gates: [T, E] router probs. Returns (expert idx [T,k], probs [T,k],
    slot [T,k], keep [T,k]) with capacity-ranked slots per expert: the
    k-th choices of all tokens are ranked after the (k-1)-th."""
    e = gates.shape[1]
    probs, idx = torch.topk(gates, top_k, dim=-1)
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-9)
    count = torch.zeros(e, dtype=torch.long, device=gates.device)
    slots = []
    for k in range(top_k):
        oh = _one_hot(idx[:, k], e)                              # [T,E]
        rank = torch.cumsum(oh, dim=0) - 1
        r = rank.gather(1, idx[:, k:k + 1])[:, 0]
        slots.append(r + count[idx[:, k]])
        count = count + oh.sum(dim=0)
    slot = torch.stack(slots, dim=1)                             # [T,k]
    return idx, probs, slot, slot < capacity


def _capacity(t: int, cfg: ArchConfig, gran: int) -> int:
    """Slots per expert: the reference's ``int(t // e * k * cf) + 1``
    (integer division first), rounded up to ``gran``."""
    c = int(t // cfg.n_experts * cfg.top_k * cfg.capacity_factor) + 1
    return -(-c // gran) * gran


def _whole(fn, *tensors, n_out: int = 1):
    """``fn(*tensors)``; with DTensor operands, a local body on every
    rank over their whole values (the routing ranks every token, the
    scatter into and the gather out of the dispatch buffer index across
    every shard), its ``n_out`` results replicated."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    like = next(t for t in tensors if is_dtensor(t))
    rep = [Replicate()] * like.device_mesh.ndim
    body = local_map(fn, out_placements=rep if n_out == 1
                     else (rep,) * n_out,
                     in_placements=tuple(rep for _ in tensors),
                     device_mesh=like.device_mesh, redistribute_inputs=True)
    return body(*(as_dtensor(t, like) for t in tensors))


def _apply(cfg: ArchConfig, p, x, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer at ``capacity`` slots per expert. The reference's scatter
    drops an index past the buffer (``mode="drop"``) and its gather clamps
    one: here a dropped slot's zero contribution goes to a dump row past
    the buffer, and the gather clamps, so every kept row gets the
    reference's bits."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    gates = router_gates(p, xf)
    idx, probs, slot, keep = _whole(
        lambda g: _dispatch_indices(g, k, capacity), gates, n_out=4)

    # load-balance aux loss (Switch-style)
    me = gates.mean(dim=0)                                       # [E]
    ce = _one_hot(idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce)

    # scatter the tokens into the dispatch buffer
    n = e * capacity
    flat_idx = (idx * capacity + slot).reshape(-1)               # [T*k]
    contrib = xf[:, None, :] * keep[:, :, None].to(x.dtype)      # [T,k,D]

    def scatter(fi, c):
        buf = torch.zeros(n + 1, d, dtype=c.dtype, device=c.device)
        buf.index_add_(0, fi.clamp(max=n), c.reshape(t * k, d))
        return buf[:n].view(e, capacity, d)

    def combine(y_, fi):
        return y_.reshape(n, d)[fi.clamp(max=n - 1)].view(t, k, d)

    # "exp_cap" shards the capacity dim when experts themselves cannot be
    # sharded (grok: 8 experts vs 16-way model axis)
    buf = constrain(_whole(scatter, flat_idx, contrib),
                    ("expert", "exp_cap", "embed"))

    # the experts (SwiGLU) as two batched products
    dt = x.dtype
    h = torch.bmm(buf, p["w1"].to(dt))
    gate, up = torch.chunk(h, 2, dim=-1)
    y = torch.bmm(F.silu(gate) * up, p["w2"].to(dt))
    y = constrain(y, ("expert", "exp_cap", "embed"))

    # gather and combine
    picked = _whole(combine, y, flat_idx)
    w = (probs * keep.float()).to(dt)                            # [T,k]
    out = torch.einsum("tkd,tk->td", picked, w).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(p["shared"], x, "swiglu")
    return out, aux


def _local_dispatch_apply(cfg: ArchConfig, p, x
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's shard-local dispatch at one data shard, which is
    what it runs without a mesh: the same routing, slots and products as
    the global path, its capacity rounded to 8 whatever the token
    count."""
    return _apply(cfg, p, x, _capacity(x.shape[0] * x.shape[1], cfg, 8))


def moe_ffn_apply(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (out [B,S,D], aux load-balance loss, f32)."""
    if cfg.moe_local_dispatch:
        return _local_dispatch_apply(cfg, p, x)
    t = x.shape[0] * x.shape[1]
    # the reference rounds so the capacity dim stays mesh-divisible
    return _apply(cfg, p, x, _capacity(t, cfg, 2048 if t >= 1 << 17 else 8))


# ---------------------------------------------------------------------------
# The dispatch -> expert matmul -> combine graph
# ---------------------------------------------------------------------------


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


def moe_graph_nodes(t: int, d: int, n: int, f: int, t_out: int, *,
                    dtype=torch.bfloat16):
    """The graph's nodes as ``(name, Workload, tile)``, as the reference
    declares them: the dispatch gather, the expert product (the port's
    product words), the combine gather."""
    return (("dispatch",) + gather_workload(n, d, dtype=dtype),
            ("expert",) + matmul_workload(n, f, d, dtype=dtype),
            ("combine",) + gather_workload(t_out, f, dtype=dtype))


def moe_dispatch_ffn(idx, tokens, w1, comb, *, policy=None) -> torch.Tensor:
    """Dispatch -> expert matmul -> combine at the caller's shapes.

    idx: [n_dispatch] int rows into ``tokens``; tokens: [T, d_model]; w1:
    [d_model, d_ff]; comb: [t_out] int rows into the expert output; every
    index in range (unchecked on the card). ``n_dispatch`` and ``t_out``
    must be multiples of 8, the reference's gather row bundle. Returns
    [t_out, d_ff] = ``(tokens[idx] @ w1)[comb]`` in the tokens' type,
    equal bit for bit to :func:`_moe_graph_unfused` on the card.

    ``policy`` (default: the session's) is resolved once for the graph
    ``moe_dispatch_ffn`` (its three nodes' workloads summed) and its
    (depth, streams) handed to both launches: the dispatched product and
    the combine gather. mode="ref" runs :func:`moe_dispatch_ffn_ref`."""
    n, t_out = idx.shape[0], comb.shape[0]
    if n % _ROWS or t_out % _ROWS:
        raise ValueError(f"n_dispatch={n} / t_out={t_out} must be "
                         f"multiples of the {_ROWS}-row gather bundle")
    pol = current_policy() if policy is None else policy
    if pol.mode == "ref":
        return moe_dispatch_ffn_ref(idx, tokens, w1, comb)

    def run(p):
        return gather(dispatch_matmul(tokens, idx, w1, policy=p), comb,
                      policy=p)

    t, d = tokens.shape
    f = w1.shape[1]
    # streams both launches can run: the product's, and the combine
    # gather's (clamped to the rows it fills)
    so = tuple(s for s in mm_stream_options(pol.stream_options)
               if s <= max(1, t_out // _ROWS))
    pol = pol if so == tuple(pol.stream_options) \
        else pol.replace(stream_options=so)
    nodes = moe_graph_nodes(t, d, n, f, t_out, dtype=tokens.dtype)
    wl, tile = autotune.graph_workload(nodes)
    choice = autotune.resolve_graph(
        "moe_dispatch_ffn", pol, workload=wl, tile=tile, dtype=tokens.dtype,
        signature=autotune.graph_signature(nodes),
        workload_fn=lambda tk: (wl, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(pol.replace(
            mode="ff", depth=dep, streams=st)),
        site={"t": t, "d": d, "n": n, "f": f, "t_out": t_out},
        site_dynamic=("t", "n", "t_out"),
        depth_cap=min(MM_MAX_DEPTH, gather_max_depth(f, tokens.dtype,
                                                     max(so))))
    mode = "ff" if pol.mode == "autotune" else pol.mode
    return run(pol.replace(mode=mode, depth=choice.depth,
                           streams=choice.streams))


def build_moe_graph(*, t_tokens: int = 96, n_dispatch: int = 64,
                    d_model: int = 128, d_ff: int = 256, t_out: int = 64,
                    dtype=torch.float32, depth: int = 2, streams: int = 1,
                    bn: int = 128):
    """Declare the MoE dispatch -> expert-matmul -> combine StreamGraph, as
    the reference does: the expert matmul's M tile pinned to the gather's
    ``8 * streams``-row bundle so dispatch -> expert fuses (it runs
    ``ff_matmul``'s dispatch path, one launch), while expert -> combine
    ends at an irregular gather and stages."""
    from repro_torch.core.graph import GraphEdge, GraphNode, StreamGraph
    from repro_torch.kernels.ff_gather.program import \
        build_program as gather_prog
    from repro_torch.kernels.ff_matmul.program import \
        build_program as matmul_prog

    rpw = _ROWS * streams
    if n_dispatch % rpw or t_out % rpw:
        raise ValueError(f"n_dispatch={n_dispatch} / t_out={t_out} must be "
                         f"multiples of the {rpw}-row gather bundle")
    block = (rpw, min(bn, d_ff), d_model)
    dispatch = gather_prog(n_dispatch, d_model, dtype=dtype, depth=depth,
                           streams=streams)
    expert = matmul_prog(n_dispatch, d_ff, d_model, block=block, dtype=dtype,
                         depth=depth, streams=streams)
    combine = gather_prog(t_out, d_ff, dtype=dtype, depth=depth,
                          streams=streams)
    nodes = moe_graph_nodes(t_tokens, d_model, n_dispatch, d_ff, t_out,
                            dtype=dtype)
    progs = {"dispatch": dispatch, "expert": expert, "combine": combine}
    return StreamGraph(
        name="moe_dispatch_ffn",
        nodes=tuple(GraphNode(name, progs[name], workload=w, plan_tile=t)
                    for name, w, t in nodes),
        edges=(
            GraphEdge("dispatch", "expert", "a"),
            GraphEdge("expert", "combine", "table"),
        ),
    )


def _moe_graph_args(idx, tokens, w1, comb):
    """:func:`moe_dispatch_ffn`'s operands as the graph's."""
    t, d = tokens.shape
    f = w1.shape[1]
    return (dict(t_tokens=t, n_dispatch=idx.shape[0], d_model=d, d_ff=f,
                 t_out=comb.shape[0], dtype=tokens.dtype, bn=min(128, f)),
            (idx, tokens, w1, comb), lambda out: out)


def _moe_graph_inputs(gen, device, *, t=64, d=64, n=32, f=96, t_out=16,
                      dtype=torch.float32):
    tokens = torch.randn((t, d), generator=gen, device=device).to(dtype)
    w1 = (torch.randn((d, f), generator=gen, device=device)
          / d ** 0.5).to(dtype)
    idx = torch.randint(0, t, (n,), generator=gen, device=device).int()
    comb = torch.randint(0, n, (t_out,), generator=gen, device=device).int()
    return idx, tokens, w1, comb


def _moe_graph_sweep_inputs(gen, site, device):
    return _moe_graph_inputs(
        gen, device, t=int(site["t"]), d=int(site["d"]), n=int(site["n"]),
        f=int(site["f"]), t_out=int(site["t_out"]),
        dtype=getattr(torch, site.get("dtype", "float32"))), {}


def _register_graph():
    from repro_torch.kernels.registry import register_graph

    register_graph(
        name="moe_dispatch_ffn",
        op=moe_dispatch_ffn,
        make_inputs=_moe_graph_inputs,
        ref=moe_dispatch_ffn_ref,
        unfused=_moe_graph_unfused,
        tol=5e-4,
        doc="MoE dispatch (irregular gather) -> expert matmul -> combine",
        sweep_inputs=_moe_graph_sweep_inputs,
        build=build_moe_graph,
        graph_args=_moe_graph_args,
    )


_register_graph()
