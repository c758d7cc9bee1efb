"""Shared building blocks of the models (the port of the parts of
``repro/models/layers.py`` that serving and training run): parameter
specs, norms, RoPE, the attention and scan dispatchers, the MLP, the loss
(:func:`cross_entropy`, :func:`chunked_unembed_loss`), the gradient casts
and :func:`remat`.

Params are plain nested dicts of tensors, declared as :class:`ParamSpec`
trees and laid out exactly as the reference's pytrees, so converted JAX
parameters drop in unchanged (:mod:`repro_torch.models.convert`).

The three attention dispatchers take the reference's ``impl`` switch:
``"ff"`` (the port's default, as its configs') routes to the CUDA kernel
wrappers, which run their plain PyTorch versions for CPU tensors;
``"xla"`` runs the reference's unfused HLO-path formulation
(:func:`attention_xla`) in plain PyTorch on any device. :func:`decode_layer`
and :func:`attention_proj` route to their kernels. :func:`chunk_scan_op`
picks the gated linear-attention scan by the same kind of switch. Every
kernel call sizes its pipes by the session pipe policy
(``repro_torch.policy``); :func:`decode_layer` resolves one plan for its
three launches, as the reference's ``decode_layer`` graph.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import ops
from repro_torch.core import autotune
from repro_torch.core.program import current_policy
from repro_torch.kernels.ff_attention import attention as ff_attention
from repro_torch.kernels.ff_attention import \
    attention_proj as ff_attention_proj
from repro_torch.kernels.ff_chunk_scan.ref import chunk_scan_xla
from repro_torch.kernels.ff_decode_attention import \
    decode_attention as ff_decode_attention
from repro_torch.kernels.ff_decode_attention import ops as dec_ops
from repro_torch.kernels.ff_layer import ff_layer_matmul, ff_layer_mlp_tail
from repro_torch.kernels.ff_layer import ops as layer_ops
from repro_torch.kernels.ff_layer.ops import rope_freqs
from repro_torch.runtime.paged_kv import paged_decode_attention
from repro_torch.runtime.sharding import as_dtensor, constrain, \
    follow, is_dtensor, kept, product_operand, product_output

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # "normal" | "zeros" | "ones" | "small"
    scale: Optional[float] = None  # override fan-in scale

    def initializer(self, gen: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        # scaled in place: a full-width leaf is drawn once, not twice
        x = torch.randn(self.shape, generator=gen, dtype=self.dtype,
                        device=device)
        if self.init == "small":
            return x.mul_(0.01)
        # fan-in = product of all non-output dims, skipping the stacked
        # layer dim (a [d, heads, hd] projection scales by 1/sqrt(d))
        dims = self.shape
        if self.axes and self.axes[0] == "layers":
            dims = dims[1:]
        fan_in = max(math.prod(dims[:-1]), 1) if len(dims) >= 2 else dims[-1]
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(
            fan_in)
        return x.mul_(scale)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape and type of one cache leaf (the port's stand-in for the
    reference's ``jax.ShapeDtypeStruct`` in its ``*_cache_spec``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order, the order JAX flattens a
    dict pytree in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack(tree, n: int):
    """The ``n`` per-layer trees of a tree of stacked ``[n, ...]`` leaves,
    one ``torch.unbind`` a leaf: under autograd the backward of the whole
    unbind is one stack, where indexing ``a[i]`` layer by layer would
    zero-fill a stack-sized gradient for each layer."""
    paths = list(tree_leaves(tree))
    per_leaf = [torch.unbind(leaf, 0) for _, leaf in paths]
    out = []
    for i in range(n):
        node: Dict[str, Any] = {}
        for (path, _), parts in zip(paths, per_leaf):
            _put(node, path, parts[i])
        out.append(node)
    return out


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy: str):
    """``fn`` rematerialized in the backward (``torch.utils.checkpoint``,
    non-reentrant): ``"none"`` returns ``fn``; ``"dots"`` saves the
    products' outputs (the reference's ``checkpoint_dots``) and recomputes
    the rest; any other policy saves nothing inside ``fn`` (its
    ``nothing_saveable``). Where no gradient is recorded, ``fn`` runs as
    it is. The RNG state is not saved for the recomputation: no model
    draws random numbers, and a compiled train step's capture cannot read
    the card's generator."""
    if policy == "none":
        return fn
    context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
                  if policy == "dots" else ckpt.noop_context_fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn,
                               preserve_rng_state=False, **kwargs)
    return wrapped


def _put(tree: Dict[str, Any], path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def init_params(specs, gen: torch.Generator, device) -> Dict[str, Any]:
    """Materialize a spec tree from one seeded generator (leaves drawn in
    the reference's flatten order; the bits differ from JAX's)."""
    out: Dict[str, Any] = {}
    for path, spec in tree_leaves(specs):
        _put(out, path, spec.initializer(gen, device))
    return out


def param_axes(specs) -> Dict[str, Any]:
    """The spec tree's logical sharding axes, one tuple a leaf."""
    return tree_map(lambda s: s.axes, specs)


def abstract_params(specs) -> Dict[str, Any]:
    """The spec tree as ``device="meta"`` tensors: shapes and types, no
    memory (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(specs))


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_apply(kind: str, x, p):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def norm_specs(kind: str, d: int) -> Dict[str, ParamSpec]:
    s = {"w": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        s["b"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding in f32, cast back. x: [..., S, H, D];
    positions: [..., S]. A DTensor ``x`` rotates each rank's shard in a
    local body (a sharded head dim is gathered first), with the positions
    placed as ``x``'s leading dims are."""
    if is_dtensor(x) or is_dtensor(positions):
        from torch.distributed.tensor.experimental import local_map
        x = as_dtensor(x, positions) if is_dtensor(positions) else x
        x_pl = kept(x.placements, range(x.dim() - 1))
        p_pl = follow(x_pl, x.dim() - 2 - positions.dim(), positions.dim())
        body = local_map(lambda x_, p_: rope(x_, p_, theta),
                         out_placements=x_pl, in_placements=(x_pl, p_pl),
                         device_mesh=x.device_mesh, redistribute_inputs=True)
        return body(x, as_dtensor(positions, x))
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def sinusoidal_positions(s: int, d: int) -> torch.Tensor:
    """[s, d] absolute positions (sin then cos) on the CPU, computed in
    numpy float64 as the reference computes them and cast once to
    float32: the same bits at every shape (torch's float64 sin rounds
    differently at a few large angles)."""
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return torch.from_numpy(np.concatenate(
        [np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32))


# ---------------------------------------------------------------------------
# Attention: the reference's XLA path and the kernel path
# ---------------------------------------------------------------------------


_Q_CHUNK = 1024
ATTN_IMPLS = ("ff", "xla")


def _attention_xla_block(q, k, v, *, causal: bool, q_offset: int,
                         positions_q=None, lengths=None) -> torch.Tensor:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(d)
    skv = k.shape[1]
    cols = torch.arange(skv, device=q.device)
    if causal:
        qpos = (positions_q if positions_q is not None
                else q_offset + torch.arange(s, device=q.device))
        scores = torch.where(qpos[:, None] >= cols[None, :], scores, -1e30)
    if lengths is not None:
        mask = cols[None, :] < lengths[:, None]                  # [B, Skv]
        scores = torch.where(mask[:, None, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def attention_xla(q, k, v, *, causal: bool, positions_q=None,
                  lengths=None) -> torch.Tensor:
    """q: [B,S,H,D]; k: [B,Skv,KVH,D]; v: [B,Skv,KVH,Dv] -> [B,S,H,Dv]:
    the reference's unfused baseline (``attention_xla``), in plain PyTorch
    on any device. The scores are q·k in f32 over sqrt(D), masked to
    -1e30 (causal, and past ``lengths``), an f32 softmax, then P·V in f32
    cast to q's type. The output takes v's head dim (MLA's differs from
    q's). A long S that is a multiple of 1024 runs in statically unrolled
    q-chunks of 1024."""
    b, s, h, d = q.shape
    if s <= _Q_CHUNK or s % _Q_CHUNK != 0 or positions_q is not None:
        return _attention_xla_block(q, k, v, causal=causal, q_offset=0,
                                    positions_q=positions_q, lengths=lengths)
    return torch.cat([
        _attention_xla_block(q[:, i:i + _Q_CHUNK], k, v, causal=causal,
                             q_offset=i, lengths=lengths)
        for i in range(0, s, _Q_CHUNK)], dim=1)


def _check_impl(impl: str) -> None:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl {impl!r} is not one of "
                         f"{ATTN_IMPLS}")


def attention_op(q, k, v, *, causal: bool, impl: str = "ff",
                 lengths=None) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,Skv,KVH,D] -> [B,S,H,D]. ``impl="ff"`` runs
    the prefill kernel (which masks the ragged S edge itself: no padding;
    ``lengths`` is for ``"xla"`` only, as in the reference). DTensor
    operands run on each rank's shards (:func:`_sharded_attention`)."""
    _check_impl(impl)
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, impl=impl,
                                  lengths=lengths)
    if impl == "xla":
        return attention_xla(q, k, v, causal=causal, lengths=lengths)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qh = q.transpose(1, 2).reshape(b * h, s, d)
    kh = k.transpose(1, 2).reshape(b * kvh, k.shape[1], d)
    vh = v.transpose(1, 2).reshape(b * kvh, v.shape[1], d)
    out = ff_attention(qh, kh, vh, kv_groups=h // kvh, causal=causal)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _sharded_attention(q, k, v, **kw) -> torch.Tensor:
    """:func:`attention_op` of DTensor operands as the body of a shard_map:
    each rank attends its own batch rows and, where the query and K/V
    head counts both divide over the mesh axes ``q``'s heads are sharded
    on, its own heads and their K/V group (the GQA groups stay whole);
    any other sharded dim of ``q`` (the sequence, the head dim) is
    gathered first. The output keeps ``q``'s placements. DTensor's own
    ops would flatten a sharded head dim into the batch inside the
    products, which it refuses."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    head_split = 1
    for i, p in enumerate(q.placements):
        if p == Shard(2):
            head_split *= mesh.size(i)
    heads_ok = q.shape[2] % head_split == 0 and k.shape[2] % head_split == 0
    q_pl, kv_pl = [], []
    for p in q.placements:
        keep = p == Shard(0) or (p == Shard(2) and heads_ok)
        q_pl.append(p if keep else Replicate())
        kv_pl.append(p if keep else Replicate())
    lengths = kw.pop("lengths")
    if lengths is None:
        # placements as lists: local_map reads a tuple as one per output
        body = local_map(lambda q_, k_, v_: attention_op(q_, k_, v_, **kw),
                         out_placements=q_pl,
                         in_placements=(q_pl, kv_pl, kv_pl),
                         device_mesh=mesh, redistribute_inputs=True)
        return body(q, k, v)
    # the lengths follow the batch rows
    body = local_map(
        lambda q_, k_, v_, n_: attention_op(q_, k_, v_, lengths=n_, **kw),
        out_placements=q_pl,
        in_placements=(q_pl, kv_pl, kv_pl, follow(q_pl, 0, 1)),
        device_mesh=mesh, redistribute_inputs=True)
    return body(q, k, v, as_dtensor(lengths, q))


def _sharded_decode_attention(q, k, v, lengths, **kw) -> torch.Tensor:
    """:func:`decode_attention_op` of DTensor operands as the body of a
    shard_map: each rank attends its own batch rows and, where the query
    and K/V head counts both divide over the mesh axes ``q``'s heads are
    sharded on, its own heads with their K/V group. Any other sharded dim
    is gathered first: a cache whose sequence is sharded (``decode_32k``
    puts it on "model") is gathered whole, as :func:`_sharded_attention`
    gathers any dim it cannot keep. The output keeps ``q``'s batch and
    head placements."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    q = as_dtensor(q, k)
    mesh = q.device_mesh
    head_split = 1
    for i, p in enumerate(q.placements):
        if p == Shard(1):
            head_split *= mesh.size(i)
    heads_ok = q.shape[1] % head_split == 0 and k.shape[2] % head_split == 0
    q_pl = kept(q.placements, (0, 1) if heads_ok else (0,))
    # q [B, H, D] -> k/v [B, Skv, KVH, D]: the heads move to dim 2
    kv_pl = [Shard(2) if p == Shard(1) else p for p in q_pl]
    body = local_map(
        lambda q_, k_, v_, n_: decode_attention_op(q_, k_, v_, n_, **kw),
        out_placements=q_pl,
        in_placements=(q_pl, kv_pl, kv_pl, follow(q_pl, 0, 1)),
        device_mesh=mesh, redistribute_inputs=True)
    return body(q, as_dtensor(k, q), as_dtensor(v, q),
                as_dtensor(lengths, q))


def decode_attention_op(q, k, v, lengths, *, impl: str = "ff",
                        block_kv: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,D] one token; k,v: [B,Skv,KVH,D] cache; lengths: [B].
    ``block_kv`` pins the ff KV tile (serving pins it to the paged cache's
    page size for bitwise parity); None picks the reference's heuristic.
    Under ``"ff"`` the cache is padded up to a tile multiple (rows past
    ``lengths`` are masked, so the padding is free of numerics)."""
    _check_impl(impl)
    if any(is_dtensor(t) for t in (q, k, v)):
        return _sharded_decode_attention(q, k, v, lengths, impl=impl,
                                         block_kv=block_kv)
    if impl == "xla":
        return attention_xla(q[:, None], k, v, causal=False,
                             lengths=lengths)[:, 0]
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    skv = k.shape[1]
    if block_kv is None:
        if skv <= 128:
            block_kv = -(-skv // 8) * 8
        else:
            block_kv = min((128, 64, 32),
                           key=lambda blk: (-(-skv // blk) * blk, -blk))
    pad = -skv % block_kv
    if pad:
        kh = F.pad(kh, (0, 0, 0, pad))
        vh = F.pad(vh, (0, 0, 0, pad))
    return ff_decode_attention(q, kh, vh, lengths, block_kv=block_kv)


def _sharded_paged_attention(q, kv_pool, block_tables, lengths,
                             **kw) -> torch.Tensor:
    """:func:`paged_decode_attention_op` of a DTensor pool as the body of a
    shard_map: each rank attends its own KV heads (the pool's shards) with
    their query group, where the query heads divide as the pool's, and
    its own batch rows where ``q`` keeps them on a mesh dim the pool does
    not shard (the tables and lengths follow the rows). Anything else is
    gathered. ``q``'s split is then the dense path's
    (:func:`_sharded_decode_attention`), so each rank's kernel sees the
    rows and heads it sees there: paged == dense bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    q = as_dtensor(q, kv_pool)
    mesh = q.device_mesh
    split = 1
    for i, p in enumerate(kv_pool.placements):
        if p == Shard(3):
            split *= mesh.size(i)
    heads_ok = q.shape[1] % split == 0 and kv_pool.shape[3] % split == 0
    q_pl, pool_pl = [], []
    for p_pool, p_q in zip(kv_pool.placements, q.placements):
        if p_pool == Shard(3) and heads_ok:
            q_pl.append(Shard(1))
            pool_pl.append(Shard(3))
        else:
            q_pl.append(p_q if p_q == Shard(0) and p_pool != Shard(3)
                        else Replicate())
            pool_pl.append(Replicate())
    rows = kept(q_pl, (0,))
    body = local_map(
        lambda q_, p_, t_, n_: paged_decode_attention_op(q_, p_, t_, n_,
                                                         **kw),
        out_placements=q_pl, in_placements=(q_pl, pool_pl, rows, rows),
        device_mesh=mesh, redistribute_inputs=True)
    return body(q, kv_pool, as_dtensor(block_tables, q),
                as_dtensor(lengths, q))


def paged_decode_attention_op(q, kv_pool, block_tables, lengths, *,
                              impl: str = "ff") -> torch.Tensor:
    """Decode attention through a paged KV pool (continuous batching).
    q: [B,H,D]; kv_pool: [nb, 2, page, KVH, D]; block_tables: [B, n_pages]
    (entries >= nb are sentinels); lengths: [B] (0 = inactive slot).
    ``"ff"`` runs the fused paged kernel; ``"xla"`` clips the table into
    the pool and reads it densely, as the reference does. A DTensor pool
    runs on each rank's shards (:func:`_sharded_paged_attention`)."""
    _check_impl(impl)
    if is_dtensor(kv_pool):
        return _sharded_paged_attention(q, kv_pool, block_tables, lengths,
                                        impl=impl)
    if impl == "ff":
        return paged_decode_attention(q, kv_pool, block_tables, lengths)
    nb, _, page, kvh, d = kv_pool.shape
    b, npg = q.shape[0], block_tables.shape[-1]
    kv = kv_pool[block_tables.long().clamp(0, nb - 1)]  # [B,npg,2,page,..]
    k = kv[:, :, 0].reshape(b, npg * page, kvh, d)
    v = kv[:, :, 1].reshape(b, npg * page, kvh, d)
    return attention_xla(q[:, None], k, v, causal=False,
                         lengths=lengths)[:, 0]


# ---------------------------------------------------------------------------
# The gated linear-attention scan: the kernel or the reference's XLA form
# ---------------------------------------------------------------------------


SCAN_IMPLS = ("ff", "xla", "xla_tiled")


def chunk_scan_op(q, k, v, log_w, u=None, *, impl: str, chunk: int,
                  inclusive: bool) -> torch.Tensor:
    """The scan of ``cfg.scan_impl``: ``"ff"`` the chunk-scan kernel;
    ``"xla"`` / ``"xla_tiled"`` the reference's chunked formulation
    (:func:`~repro_torch.kernels.ff_chunk_scan.ref.chunk_scan_xla`) with S
    padded to a chunk multiple (decay 1, zero k and v), as the reference's
    dispatch pads it. q,k,log_w: [BH,S,N]; v: [BH,S,P]; u: [BH,N]."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"scan impl {impl!r} is not one of {SCAN_IMPLS}")
    if impl == "ff":
        return ops.chunk_scan(q, k, v, log_w, u, inclusive=inclusive,
                              chunk=chunk)
    s = q.shape[1]
    pad = -s % chunk
    q, k, v, log_w = (F.pad(x, (0, 0, 0, pad)) if pad else x
                      for x in (q, k, v, log_w))
    return chunk_scan_xla(q, k, v, log_w, u, chunk=chunk,
                          inclusive=inclusive,
                          tiled=impl == "xla_tiled")[:, :s]


# ---------------------------------------------------------------------------
# Attention -> out-projection (the port of the attention_proj StreamGraph)
# ---------------------------------------------------------------------------


def _attention_proj_ref(q, k, v, w) -> torch.Tensor:
    """The reference's f32 oracle: causal attention and the projection in
    f32, cast once to q's type. In bf16 it rounds elsewhere than the graph
    (which writes the attention output in q's type before the product);
    :func:`repro_torch.kernels.ff_attention.attention_proj_ref` rounds as
    the graph does."""
    bh, s, d = q.shape
    scores = torch.einsum("bsd,btd->bst", q.float(),
                          k.float()) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, -1e30)
    attn = torch.einsum("bst,btd->bsd", torch.softmax(scores, dim=-1),
                        v.float())
    return (attn.reshape(bh * s, d) @ w.float()).to(q.dtype)


def _attention_proj_unfused(q, k, v, w) -> torch.Tensor:
    """Attention then projection as two separate ``repro_torch.ops`` calls:
    the [BH, S, D] intermediate round-trips HBM. The reference pins the
    projection to the graph's tile (``block=``) so that only the lowering
    differs; the port's kernels pick their own tiles, so nothing is
    pinned."""
    bh, s, d = q.shape
    a = ops.attention(q, k, v, causal=True)
    return ops.matmul(a.reshape(bh * s, d), w)


# The entry point is the fused launch, which resolves the graph's plan
# (``attention_proj``) itself. On the card it equals
# _attention_proj_unfused bit for bit.
attention_proj = ff_attention_proj


def _attention_proj_inputs(gen, device, *, bh=2, s=128, d=64, d_out=96,
                           dtype=torch.float32):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k = 0.3 * rn(bh, s, d), 0.3 * rn(bh, s, d)
    v, w = rn(bh, s, d), rn(d, d_out) / math.sqrt(d)
    return tuple(x.to(dtype) for x in (q, k, v, w))


def _attention_proj_sweep_inputs(gen, site, device):
    return _attention_proj_inputs(
        gen, device, bh=int(site["bh"]), s=int(site["s"]),
        d=int(site["d"]), d_out=int(site["d_out"]),
        dtype=getattr(torch, site.get("dtype", "float32"))), \
        {"causal": bool(site.get("causal", True))}


# ---------------------------------------------------------------------------
# MLP / embedding
# ---------------------------------------------------------------------------


def mlp_specs(d: int, f: int, act: str) -> Dict[str, ParamSpec]:
    """SwiGLU: ``wi [d, 2f]`` (gate then up), ``wo [f, d]``; GELU:
    ``wi [d, f]``, ``bi [f]``, ``wo [f, d]``, ``bo [d]`` (biases zero)."""
    s = {"wo": ParamSpec((f, d), ("mlp", "embed"))}
    if act == "swiglu":
        s["wi"] = ParamSpec((d, 2 * f), ("embed", "mlp"))
    else:
        s["wi"] = ParamSpec((d, f), ("embed", "mlp"))
        s["bi"] = ParamSpec((f,), ("mlp",), init="zeros")
        s["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def mlp_apply(p, x, act: str) -> torch.Tensor:
    """SwiGLU, or ``gelu(x @ wi + bi) @ wo + bo`` with the tanh-approximate
    GELU (``jax.nn.gelu``'s default, which the reference calls)."""
    x = product_operand(x)
    dt = x.dtype
    if act == "swiglu":
        gate, up = torch.chunk(product_output(x @ p["wi"].to(dt)), 2, dim=-1)
        return product_output((F.silu(gate) * up) @ p["wo"].to(dt))
    h = F.gelu(product_output(x @ p["wi"].to(dt)) + p["bi"].to(dt),
               approximate="tanh")
    return product_output(h @ p["wo"].to(dt)) + p["bo"].to(dt)


def embed_specs(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), scale=0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """``table[tokens]`` in ``compute_dtype``. A DTensor table (vocab
    sharded) takes the vocab-parallel lookup of :func:`_sharded_embed`:
    DTensor cannot place the backward of its own (an ``index_put`` into a
    sharded table, a masked partial sum)."""
    rows = (_sharded_embed(table, tokens) if is_dtensor(table)
            else table[tokens.long()])
    return constrain(rows.to(compute_dtype), ("batch", "seq", "embed"))


def _sharded_embed(table, tokens):
    """``table[tokens]`` of a DTensor table as the body of a shard_map
    (the vocab-parallel lookup): each rank looks every token up in its own
    vocab rows, zero where a token lies in another rank's, and the output
    is the partial sum over the vocab's mesh axis (the caller's
    ``constrain`` all-reduces it and keeps its batch rows). Each rank
    takes the whole batch, so its shard's gradient is whole too (a
    batch-sharded lookup would leave it a partial sum over "data"). A
    table sharded otherwise (or over several axes) is gathered first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    vocab = vocab if len(vocab) == 1 else []
    tok_pl = [Replicate()] * mesh.ndim
    table_pl = [Shard(0) if i in vocab else Replicate()
                for i in range(mesh.ndim)]
    out_pl = [Partial() if i in vocab else Replicate()
              for i in range(mesh.ndim)]

    def body(t, tok):
        n = t.shape[0]
        lo = mesh.get_local_rank(vocab[0]) * n if vocab else 0
        idx = tok.long() - lo
        mine = (idx >= 0) & (idx < n)
        return t[idx.clamp(0, n - 1)] * mine[..., None].to(t.dtype)

    return local_map(body, out_placements=out_pl,
                     in_placements=(table_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: [B,S,D] -> logits [B,S,V] over the padded vocab (sharded batch x
    vocab under a mesh)."""
    x = product_operand(x)
    return constrain(x @ table.t().to(x.dtype), ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# Loss and the gradient casts
# ---------------------------------------------------------------------------


class _BF16GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        if ct.dtype == torch.float32:
            return ct.to(torch.bfloat16).to(torch.float32)
        return ct


class _BF16GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity; its backward rounds an f32 cotangent through bf16 (the
    mantissa quantized, the type kept), as the reference's
    ``custom_vjp``."""
    return _BF16GradBarrier.apply(x)


def bf16_grad_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity; its backward casts the cotangent to the primal's type
    (the layer-boundary cotangent in bf16 where the activations are)."""
    return _BF16GradCast.apply(x)


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float) -> torch.Tensor:
    """Per-token CE in f32 (logsumexp minus the label's logit), plus
    ``z_loss * lse**2``. DTensor logits (vocab-sharded) run as the body
    of a shard_map (:func:`_sharded_token_ce`)."""
    if is_dtensor(logits):
        return _sharded_token_ce(logits, labels, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss


def _sharded_token_ce(logits, labels, z_loss: float):
    """:func:`_token_ce` of DTensor logits [B, S, V]: the vocab shards are
    gathered (one all-gather of this rank's batch rows' logits), then each
    rank takes its batch rows' CE on its own; the per-token losses keep
    the batch sharding. DTensor's gather cannot take the label's logit
    from a vocab-sharded dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = [p if p == Shard(0) else Replicate() for p in logits.placements]
    return local_map(lambda lg, lb: _token_ce(lg, lb, z_loss),
                     out_placements=pl, in_placements=(pl, pl),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token CE in f32, with a z-loss regularizer (stabilizes bf16)."""
    return torch.mean(_token_ce(logits, labels, z_loss))


def chunked_unembed_loss(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, n_chunks: int,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """CE without the full [B,S,V] logits: the unembed product and the
    softmax run per sequence chunk (unrolled), so the largest logits
    tensor is ``n_chunks`` times smaller."""
    b, s, _ = x.shape
    assert s % n_chunks == 0, (s, n_chunks)
    cs = s // n_chunks
    wt = table.t().to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        logits = constrain(x[:, sl] @ wt, ("batch", "seq", "vocab"))
        total = total + torch.sum(_token_ce(logits, labels[:, sl], z_loss))
    return total / (b * s)


# ---------------------------------------------------------------------------
# The whole decode layer (the port of the decode_layer StreamGraph)
# ---------------------------------------------------------------------------


def _pad_cache(c: torch.Tensor, block_kv: int) -> torch.Tensor:
    """[B, KVH, S, hd] right-padded to a multiple of ``block_kv`` rows
    (rows past ``lengths`` are masked: the padding is free of numerics)."""
    pad = -c.shape[2] % block_kv
    return F.pad(c, (0, 0, 0, pad)) if pad else c


def decode_layer(x, nw1, wq, bq, positions, k_cache, v_cache, lengths, wo,
                 nw2, wg, wu, wo2, *, rope_theta: float = 10000.0,
                 eps: float = 1e-6, block_kv: Optional[int] = None,
                 policy=None) -> torch.Tensor:
    """One transformer decode step (post cache-update) as the reference's
    whole-layer ``decode_layer`` graph computes it, in three launches:
    q-projection (RMSNorm prologue, q-bias + RoPE epilogue), decode
    attention at ``block_kv`` (default 128, as the reference), and the MLP
    tail (out-projection + residual -> RMSNorm + SwiGLU -> down-projection
    + residual) as one kernel.

    x: [B, D] current-token hidden states; nw1/nw2: [D] f32 RMSNorm
    weights; wq: [D, H*hd] (bq: [H*hd] or None); positions: [B] rope
    positions of the current token; k_cache/v_cache: [B, KVH, S, hd]
    post-update (views are taken as they are); lengths: [B] live prefix
    *including* the current token; wo: [H*hd, D]; wg/wu: [D, F]; wo2:
    [F, D]. Returns [B, D]. The query group is taken as it is and ragged
    edges are masked: no padded heads, rows or projections.

    The three launches share one plan: the session policy resolved for
    the graph ``decode_layer`` (``autotune.resolve_graph``, the five
    nodes' workloads summed, the depth capped at the shallowest of the
    kernels' deepest rings, the streams those all three can run), handed
    to each launch as explicit ints, as the reference compiles its graph
    under one (depth, streams)."""
    bkv = int(block_kv or 128)
    kc, vc = _pad_cache(k_cache, bkv), _pad_cache(v_cache, bkv)
    pol = current_policy() if policy is None else policy

    def run(pol):
        return _layer_launches(x, nw1, wq, bq, positions, kc, vc, lengths,
                               wo, nw2, wg, wu, wo2, rope_theta=rope_theta,
                               eps=eps, block_kv=bkv,
                               tail=ff_layer_mlp_tail, policy=pol)

    if pol.mode == "ref":
        return run(pol)
    choice = _decode_layer_choice(pol, x, wq, kc, wo, wg, bkv, run)
    mode = "ff" if pol.mode == "autotune" else pol.mode
    return run(pol.replace(mode=mode, depth=choice.depth,
                           streams=choice.streams))


def _layer_launches(x, nw1, wq, bq, positions, kc, vc, lengths, wo, nw2,
                    wg, wu, wo2, *, rope_theta, eps, block_kv, tail,
                    policy=None) -> torch.Tensor:
    """The decode layer's launches on a cache padded to ``block_kv``: the
    q-projection, decode attention, then ``tail`` (the one-launch MLP tail,
    or its three staged launches)."""
    b, hd = x.shape[0], kc.shape[3]
    h = wq.shape[1] // hd
    q = ff_layer_matmul(x, wq, norm_weight=nw1.float(), eps=eps, bias=bq,
                        positions=positions, rope_theta=rope_theta,
                        head_dim=hd, policy=policy)
    a = ff_decode_attention(q.view(b, h, hd), kc, vc, lengths,
                            block_kv=block_kv, policy=policy)
    return tail(a.view(b, h * hd), wo, x, nw2.float(), wg, wu, wo2, eps=eps,
                policy=policy)


def _decode_layer_unfused(x, nw1, wq, bq, positions, k_cache, v_cache,
                          lengths, wo, nw2, wg, wu, wo2, *,
                          rope_theta: float = 10000.0, eps: float = 1e-6,
                          block_kv: Optional[int] = None) -> torch.Tensor:
    """The decode layer as five launches (the port of the reference's
    ``_decode_layer_unfused``): the MLP tail's three stages staged
    (:func:`~repro_torch.kernels.ff_layer.mlp_tail_staged`), every
    intermediate through device memory. On the card it equals
    :func:`decode_layer` bit for bit."""
    bkv = int(block_kv or 128)
    return _layer_launches(x, nw1, wq, bq, positions,
                           _pad_cache(k_cache, bkv), _pad_cache(v_cache, bkv),
                           lengths, wo, nw2, wg, wu, wo2,
                           rope_theta=rope_theta, eps=eps, block_kv=bkv,
                           tail=layer_ops.mlp_tail_staged)


def decode_layer_nodes(b: int, d: int, h: int, kvh: int, hd: int, f: int,
                       s: int, *, dtype=torch.bfloat16):
    """The decode layer's nodes as ``(name, Workload, tile)``: the
    q-projection, decode attention over the (padded) cache, and the MLP
    tail's three stages."""
    return ((("qproj",) + layer_ops.ff_layer_workload(b, d, h * hd,
                                                      dtype=dtype),
             ("attention",) + dec_ops.decode_attention_workload(
                 b, h, kvh, s, hd, dtype=dtype))
            + layer_ops.mlp_tail_nodes(b, h * hd, d, f, dtype=dtype))


def _decode_layer_choice(pol, x, wq, k_cache, wo, wg, block_kv, run):
    """The graph's one (depth, streams) under ``pol``."""
    b, d = x.shape
    _, kvh, s, hd = k_cache.shape
    h, f = wq.shape[1] // hd, wg.shape[1]
    so = tuple(st for st in layer_ops.stream_options(pol.stream_options)
               if st in dec_ops.stream_options(pol.stream_options, block_kv,
                                               hd, x.dtype))
    pol = pol if so == tuple(pol.stream_options) \
        else pol.replace(stream_options=so)
    nodes = decode_layer_nodes(b, d, h, kvh, hd, f, s, dtype=x.dtype)
    wl, tile = autotune.graph_workload(nodes)
    return autotune.resolve_graph(
        "decode_layer", pol, workload=wl, tile=tile, dtype=x.dtype,
        signature=autotune.graph_signature(nodes),
        workload_fn=lambda tk: (wl, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(pol.replace(
            mode="ff", depth=dep, streams=st)),
        site={"b": b, "d_model": d, "h": h, "kvh": kvh, "hd": hd,
              "d_ff": f, "s": s},
        site_dynamic=("b", "s"),
        depth_cap=min(layer_ops.MAX_DEPTH,
                      dec_ops.max_depth(hd, x.dtype, h // kvh)))


def decode_layer_ref(x, nw1, wq, bq, positions, k_cache, v_cache, lengths,
                     wo, nw2, wg, wu, wo2, *, rope_theta: float = 10000.0,
                     eps: float = 1e-6,
                     block_kv: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`decode_layer` (the port of the reference's
    ``_decode_layer_ref``), at the same arguments: one softmax over the
    whole cache instead of tiles (``block_kv`` is unused), the graph's
    rounding points elsewhere. A row with ``lengths == 0`` attends to
    nothing."""
    del block_kv
    b, _ = x.shape
    _, kvh, s, hd = k_cache.shape
    n, half, dt = wq.shape[1], hd // 2, x.dtype
    xn = rmsnorm(x, nw1, eps)
    q = torch.matmul(xn.float(), wq.float()).to(dt).float()
    if bq is not None:
        q = q + bq.float()
    ang = positions.float()[:, None] * rope_freqs(float(rope_theta), half,
                                                  x.device)
    c = torch.cos(ang)[:, None, :]
    s_ = torch.sin(ang)[:, None, :]
    qh = q.view(b, n // hd, hd)
    x1, x2 = qh[..., :half], qh[..., half:]
    qh = torch.cat([x1 * c - x2 * s_, x1 * s_ + x2 * c], dim=-1)
    q4 = qh.view(b, kvh, n // (kvh * hd), hd).to(dt)
    scores = torch.einsum("bkgd,bksd->bkgs", q4.float(),
                          k_cache.float()) / math.sqrt(hd)
    lens = lengths.to(torch.int64).view(b, 1, 1, 1)
    valid = torch.arange(s, device=x.device).view(1, 1, 1, s) < lens
    scores = torch.where(valid, scores, -1e30)
    attn = torch.einsum("bkgs,bksd->bkgd", torch.softmax(scores, dim=-1),
                        v_cache.float())
    attn = torch.where(lens > 0, attn, 0.0)
    a = attn.to(dt).reshape(b, n)
    hh = torch.matmul(a.float(), wo.float()).to(dt) + x
    hn = rmsnorm(hh, nw2, eps).float()
    g32 = torch.matmul(hn, wg.float())
    u32 = torch.matmul(hn, wu.float())
    m = (g32 * torch.sigmoid(g32) * u32).to(dt)
    return torch.matmul(m.float(), wo2.float()).to(dt) + hh


def _decode_layer_inputs(gen, device, *, b=2, d=64, h=4, kvh=2, hd=16,
                         f=96, s=32, dtype=torch.float32):
    """Operands of :func:`decode_layer` at one shape point (positional,
    then keyword arguments)."""
    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device=device)).to(dtype)
    x = rn(b, d, scale=0.3)
    nw1 = 1.0 + 0.1 * torch.randn(d, generator=gen, device=device)
    nw2 = 1.0 + 0.1 * torch.randn(d, generator=gen, device=device)
    lengths = torch.randint(1, s + 1, (b,), generator=gen,
                            device=device).int()
    args = (x, nw1, rn(d, h * hd, scale=d ** -0.5), rn(h * hd, scale=0.1),
            lengths - 1, rn(b, kvh, s, hd), rn(b, kvh, s, hd), lengths,
            rn(h * hd, d, scale=(h * hd) ** -0.5), nw2,
            rn(d, f, scale=d ** -0.5), rn(d, f, scale=d ** -0.5),
            rn(f, d, scale=f ** -0.5))
    return args, {"block_kv": 16}


def _decode_layer_sweep_inputs(gen, site, device):
    return _decode_layer_inputs(
        gen, device, b=int(site["b"]), d=int(site["d_model"]),
        h=int(site["h"]), kvh=int(site["kvh"]), hd=int(site["hd"]),
        f=int(site["d_ff"]), s=int(site["s"]),
        dtype=getattr(torch, site.get("dtype", "float32")))


# ---------------------------------------------------------------------------
# The graphs' StreamGraph declarations (the reference's builders)
# ---------------------------------------------------------------------------


def build_attention_proj_graph(*, bh: int = 2, s: int = 256, d: int = 64,
                               d_out: int = 256, causal: bool = True,
                               dtype=torch.float32, depth: int = 2,
                               streams: int = 1, block_q: int = 128):
    """Declare the attention -> out-projection StreamGraph at one shape
    point, as the reference does: the projection's M tile pinned to
    ``block_q`` so the edge is fusable when the attention output schedule
    lines up. Fused, it runs ``ff_attention_proj`` (one launch)."""
    from repro_torch.core.graph import GraphEdge, GraphNode, StreamGraph
    from repro_torch.kernels.ff_attention.ops import attention_workload
    from repro_torch.kernels.ff_attention.program import \
        build_program as attn_prog
    from repro_torch.kernels.ff_matmul.ops import matmul_workload
    from repro_torch.kernels.ff_matmul.program import \
        build_program as matmul_prog

    block = (block_q, min(128, d_out), d)
    attn = attn_prog(bh, s, s, d, block_q=block_q, block_kv=128,
                     causal=causal, dtype=dtype, depth=depth, streams=streams)
    proj = matmul_prog(bh * s, d_out, d, block=block, dtype=dtype,
                       depth=depth, streams=streams)
    w_a, t_a = attention_workload(bh, s, d, causal=causal, dtype=dtype)
    w_p, t_p = matmul_workload(bh * s, d_out, d, dtype=dtype)
    return StreamGraph(
        name="attention_proj",
        nodes=(
            GraphNode("attn", attn, workload=w_a, plan_tile=t_a),
            GraphNode("proj", proj, workload=w_p, plan_tile=t_p),
        ),
        edges=(
            GraphEdge("attn", "proj", "a", reshape=(bh * s, d)),
        ),
    )


def _attention_proj_graph_args(q, k, v, w, *, causal: bool = True):
    """:func:`attention_proj`'s operands as the graph's: (build kwargs,
    operands in ``arg_names`` order, output view)."""
    bh, s, d = q.shape
    block_q = min(128, s)
    return (dict(bh=bh, s=s, d=d, d_out=w.shape[1], causal=causal,
                 dtype=q.dtype, block_q=block_q), (q, k, v, w),
            lambda out: out)


def build_decode_layer_graph(*, b: int = 16, d_model: int = 64,
                             kvh: int = 1, g_pad: int = 8, hd: int = 16,
                             d_ff: int = 128, s: int = 128,
                             eps: float = 1e-6, dtype=torch.float32,
                             depth: int = 2, streams: int = 1,
                             block_m: int = 8, block_kv: int = 128,
                             rope_theta: float = 10000.0):
    """Declare the whole-decode-layer StreamGraph at one shape point, as
    the reference does: q-projection (RMSNorm prologue, q bias + RoPE
    epilogue) -> decode attention -> out-projection (+ residual) ->
    SwiGLU gate/up (RMSNorm prologue) -> down-projection (+ residual, the
    out-projection's output served in-chain). Fused, the last three run
    ``ff_layer_mlp_tail`` (one launch); the two attention-adjacent edges
    stage.

    Where the reference's RoPE epilogue reads cos/sin tables, the port's
    kernel computes the rotation from the positions and ``rope_theta``:
    the ``rope_bias`` epilogue takes ``bq`` and ``positions``."""
    from repro_torch.core.graph import Epilogue, GraphEdge, GraphNode, \
        StreamGraph
    from repro_torch.core.program import BlockIn
    from repro_torch.kernels.ff_decode_attention.program import \
        build_program as attn_prog
    from repro_torch.kernels.ff_layer.program import build_matmul_program, \
        build_swiglu_program

    hpad = kvh * g_pad * hd
    mm = functools.partial(build_matmul_program, block_m=block_m, eps=eps,
                           dtype=dtype, depth=depth, streams=streams)
    qprog = mm(b, hpad, d_model, norm=True, name="ff_layer_qproj")
    attn = attn_prog(b, kvh, g_pad, s, hd, block_kv=block_kv, dtype=dtype,
                     depth=depth, streams=streams)
    oprog = mm(b, d_model, hpad, name="ff_layer_oproj")
    gprog = build_swiglu_program(b, d_ff, d_model, block_m=block_m,
                                 norm=True, eps=eps, dtype=dtype,
                                 depth=depth, streams=streams)
    dprog = mm(b, d_model, d_ff, name="ff_layer_down")

    def residual(name):
        return Epilogue("residual", inputs=(
            BlockIn(name, (block_m, d_model), lambda g: (g, 0),
                    dtype=dtype),))

    def node(name, prog, w_t, **kw):
        return GraphNode(name, prog, workload=w_t[0], plan_tile=w_t[1], **kw)

    lw = layer_ops.ff_layer_workload
    return StreamGraph(
        name="decode_layer",
        nodes=(
            node("qproj", qprog, lw(b, d_model, hpad, dtype=dtype),
                 epilogue=Epilogue("rope_bias", inputs=(
                     BlockIn("bq", (block_m, hpad), lambda g: (0, 0)),
                     BlockIn("positions", (block_m,), lambda g: (g,),
                             dtype=torch.int32),
                 ), params={"rope_theta": rope_theta, "head_dim": hd})),
            node("attn", attn, dec_ops.decode_attention_workload(
                b, kvh * g_pad, kvh, s, hd, dtype=dtype)),
            node("oproj", oprog, lw(b, hpad, d_model, dtype=dtype),
                 epilogue=residual("res1")),
            node("gateup", gprog, lw(b, d_model, d_ff, dtype=dtype,
                                     gated=True)),
            node("down", dprog, lw(b, d_ff, d_model, dtype=dtype),
                 epilogue=residual("res")),
        ),
        edges=(
            # staged: attn's q is a block-delivered BlockIn operand
            GraphEdge("qproj", "attn", "q", reshape=(b, kvh, g_pad, hd)),
            # staged: (1, 1, g_pad, hd) attention blocks against the
            # (block_m, hpad) row tiles
            GraphEdge("attn", "oproj", "a", reshape=(b, hpad)),
            # the fused chain oproj -> gateup -> down
            GraphEdge("oproj", "gateup", "x"),
            # oproj's output also feeds the final residual, in-chain
            GraphEdge("oproj", "down", "res"),
            GraphEdge("gateup", "down", "a"),
        ),
    )


def _decode_layer_graph_args(x, nw1, wq, bq, positions, k_cache, v_cache,
                             lengths, wo, nw2, wg, wu, wo2, *,
                             rope_theta: float = 10000.0, eps: float = 1e-6,
                             block_kv: Optional[int] = None):
    """:func:`decode_layer`'s operands as the graph's: the query group
    taken as it is (``g_pad`` = the group) and one row block of all ``b``
    rows, as the port's kernels take them (the reference pads both to 8),
    the cache padded to ``block_kv`` as :func:`decode_layer` pads it."""
    b, d = x.shape
    _, kvh, _, hd = k_cache.shape
    h = wq.shape[1] // hd
    bkv = int(block_kv or 128)
    kc, vc = _pad_cache(k_cache, bkv), _pad_cache(v_cache, bkv)
    kw = dict(b=b, d_model=d, kvh=kvh, g_pad=h // kvh, hd=hd,
              d_ff=wg.shape[1], s=kc.shape[2], eps=eps, dtype=x.dtype,
              block_m=b, block_kv=bkv, rope_theta=rope_theta)
    return kw, (x, wq, nw1, bq, positions, lengths, kc, vc, wo, x, wg, wu,
                nw2, wo2), lambda out: out


def _register_graphs():
    from repro_torch.kernels.registry import register_graph

    register_graph(
        name="attention_proj",
        op=attention_proj,
        make_inputs=_attention_proj_inputs,
        ref=_attention_proj_ref,
        unfused=_attention_proj_unfused,
        tol=5e-4,
        doc="causal attention -> out-projection, one launch",
        sweep_inputs=_attention_proj_sweep_inputs,
        build=build_attention_proj_graph,
        graph_args=_attention_proj_graph_args,
    )
    register_graph(
        name="decode_layer",
        op=decode_layer,
        make_inputs=lambda gen, device: _decode_layer_inputs(gen, device)[0],
        ref=decode_layer_ref,
        unfused=_decode_layer_unfused,
        tol=5e-4,
        doc="q-projection -> decode attention -> MLP tail, one plan",
        sweep_inputs=_decode_layer_sweep_inputs,
        build=build_decode_layer_graph,
        graph_args=_decode_layer_graph_args,
    )


_register_graphs()
