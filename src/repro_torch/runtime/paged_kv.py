"""Paged KV cache + block-table decode attention for continuous batching
(the port of ``repro/runtime/paged_kv.py``).

  * :class:`BlockAllocator` / :class:`PagedKVCache` — a host-side LIFO
    free-list allocator over a device-resident block pool
    ``[L, n_blocks, 2, page, KVH, hd]`` (axis 2: k=0 / v=1) with
    per-request block tables. Unallocated table entries hold the sentinel
    id ``n_blocks``: scatters drop them, attention clips and masks them.
  * :func:`scatter_prefill` / :func:`scatter_token` write K/V into the
    pool through the tables. The reference's JAX scatters donate the pool
    and drop out-of-range ids (``mode="drop"``); torch indexing raises on
    out-of-range ids, and filtering them out would size a tensor by the
    data (a host sync, which a CUDA graph cannot capture). So every row
    writes: a dropped row writes, where the first kept row writes, that
    row's own value (or, with no row kept, the value already there), and
    the pool is updated in place (the donated buffer's counterpart).
  * :func:`paged_decode_attention` — the wrapper of the paged CUDA kernel
    (``kernels/csrc/ff_decode_attention.cu``, which reads pages through the
    table itself; the reference fused an ``ff_gather`` producer into the
    attention consumer for this), with :func:`paged_decode_attention_ref`
    as its plain version. It resolves its ring through the pipe policy
    as the reference's graph ``paged_decode_attention``, from the words
    the port's one launch streams (:func:`paged_decode_nodes`).
  * :func:`gather_indices` / :func:`paged_decode_unfused` — the staged
    baseline of the paged kernel: gather the step's pool rows
    (``ff_gather``), then contiguous decode.

Under a mesh (``runtime.sharding.use_sharding``) the pool is a DTensor
with its KV heads over "model" (the dense cache's ``kv_heads`` rule) and
the block tables are replicated: every rank's host allocator makes the
same choices, so each rank scatters into and attends over its own heads
in a local body.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels.ff_decode_attention import ops as dec_ops
from repro_torch.kernels.ff_gather import gather
from repro_torch.runtime import sharding as shlib

# the pool [L, n_blocks, 2, page, KVH, hd]: its KV heads as the dense
# cache's
POOL_AXES = ("layers", None, None, None, "kv_heads", None)


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


def paged_gather(kv_pool, block_tables):
    """Dereference a block table: pool [nb, 2, page, KVH, D] through
    ``block_tables`` [B, n_pages] (sentinels clip to the last block) into
    the cache views [B, KVH, n_pages*page, D] of K and of V."""
    nb, _, page, kvh, d = kv_pool.shape
    b, n_pages = block_tables.shape
    bt = block_tables.long().clamp(0, nb - 1)
    kv = kv_pool[bt]                            # [B, n_pages, 2, page, KVH, D]
    k = kv[:, :, 0].reshape(b, n_pages * page, kvh, d).transpose(1, 2)
    v = kv[:, :, 1].reshape(b, n_pages * page, kvh, d).transpose(1, 2)
    return k, v


def paged_decode_attention_ref(q, kv_pool, block_tables,
                               lengths) -> torch.Tensor:
    """Plain version of the paged kernel: gather the pages through the
    clipped table, then the plain contiguous version at
    ``block_kv == page``, so paged == contiguous holds bit for bit on the
    CPU as it does between the two kernels."""
    k, v = paged_gather(kv_pool, block_tables)
    return dec_ops.decode_attention_ref(q, k, v, lengths,
                                        block_kv=kv_pool.shape[2])


def paged_decode_nodes(b: int, h: int, kvh: int, n_pages: int, page: int,
                       d: int, *, dtype=torch.bfloat16):
    """The graph's nodes as ``(name, Workload, tile)``: one, the decode
    over the ``n_pages * page`` rows the table maps
    (:func:`~repro_torch.kernels.ff_decode_attention.ops.
    decode_attention_workload`: regular words of R cache rows, K and V).
    The reference declares two, an ``ff_gather`` of the step's page rows
    in irregular 8-row words and the decode over the gathered cache; the
    port runs no gather, its one kernel reads each page through the table
    in its own R-row words, so the rows stream once, as the contiguous
    cache's do."""
    w, tile = dec_ops.decode_attention_workload(b, h, kvh, n_pages * page,
                                                d, dtype=dtype)
    return (("decode", w, tile),)


def _apply(q, kv_pool, block_tables, lengths, *,
           policy: PipePolicy) -> torch.Tensor:
    """Decode attention for one new token through the block table.

    q: [B, H, d]; kv_pool: [n_blocks, 2, page, KVH, d] (one layer's pool);
    block_tables: [B, n_pages] int (entries >= n_blocks are sentinels);
    lengths: [B] (0 = inactive slot, whose output is exactly 0).
    The kernel's ring (the reference's ``Pipe`` arguments on its merged
    ``2 * page``-row K+V word) is sized by ``policy`` for the graph; it
    never changes the result. Returns [B, H, d]. mode="ref" and CPU
    tensors run :func:`paged_decode_attention_ref`; CUDA tensors launch
    the kernel."""
    if kv_pool.dim() != 5 or kv_pool.shape[1] != 2:
        raise ValueError(f"kv_pool {tuple(kv_pool.shape)} is not "
                         f"[nb, 2, page, KVH, d]")
    kvh, d = kv_pool.shape[3], kv_pool.shape[4]
    dec_ops.check_decode_inputs(q, kv_pool, lengths, kvh=kvh, d=d)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} is not "
                         f"[{q.shape[0]}, n_pages]")
    if block_tables.device != q.device:
        raise ValueError("block_tables must be on q's device")
    if policy.mode == "ref":
        return paged_decode_attention_ref(q, kv_pool, block_tables, lengths)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {q.device}")

    def run(depth, streams):
        if q.device.type == "cpu":
            return paged_decode_attention_ref(q, kv_pool, block_tables,
                                              lengths)
        return dec_ops.launch_paged(q, kv_pool, block_tables, lengths,
                                    depth=depth, streams=streams)

    nb, _, page = kv_pool.shape[:3]
    b, h, n_pages = q.shape[0], q.shape[1], block_tables.shape[1]
    depth, streams = dec_ops.resolve_pipe(
        "paged_decode_attention", policy, q, kvh, n_pages * page, d,
        2 * page, run,
        nodes=paged_decode_nodes(b, h, kvh, n_pages, page, d,
                                 dtype=kv_pool.dtype),
        site={"b": b, "h": h, "kvh": kvh, "n_pages": n_pages, "page": page,
              "d": d, "n_blocks": nb})
    out = run(depth, streams)
    if q.device.type == "cuda":
        paged_decode_attention.launches += 1
    return out


paged_decode_attention = make_entrypoint("paged_decode_attention", _apply)


def gather_indices(block_tables, *, page: int, kv_heads: int,
                   n_blocks: int) -> torch.Tensor:
    """Row indices into one layer's pool viewed as rows
    ``[nb*2*page*KVH, hd]`` for one decode step, int32.

    ``block_tables``: [B, n_pages] (entries >= ``n_blocks`` are sentinels;
    they clip to a real row and the length mask discards what they fetch).
    The order is [2, B, KVH, n_pages*page]: every K row of the step, then
    every V row, so the gathered rows are the contiguous caches
    ``K = rows[0]`` and ``V = rows[1]`` of shape [B, KVH, S, hd]. The
    reference orders the same rows [B, KVH, n_pages, 2, page] (each page's
    K rows, then its V rows: one ``ff_gather`` word per page); the port's
    decode kernel reads K and V as two caches, so they are taken apart in
    the index rather than by copying the gathered rows."""
    bt = torch.as_tensor(block_tables).long().clamp(0, n_blocks - 1)
    dev = bt.device
    which = torch.arange(2, device=dev).view(2, 1, 1, 1, 1)
    off = torch.arange(page, device=dev)
    heads = torch.arange(kv_heads, device=dev).view(1, 1, kv_heads, 1, 1)
    # [2, B, KVH, n_pages, page]: row = ((blk*2 + which)*page + off)*KVH + h
    rows = ((bt[None, :, None, :, None] * 2 + which) * page + off) \
        * kv_heads + heads
    return rows.reshape(-1).int()


def page_word_indices(block_tables, *, page: int, kv_heads: int,
                      n_blocks: int) -> torch.Tensor:
    """The same rows as :func:`gather_indices` in the reference's order
    (its ``gather_indices``), int32: [B, KVH, n_pages, 2, page], so gather
    word ``(b * KVH + h) * n_pages + p`` is page ``p``'s K rows then its V
    rows, the merged word the paged graph's consumer reads."""
    bt = torch.as_tensor(block_tables).long().clamp(0, n_blocks - 1)
    dev = bt.device
    which = torch.arange(2, device=dev).view(1, 1, 1, 2, 1)
    off = torch.arange(page, device=dev).view(1, 1, 1, 1, page)
    heads = torch.arange(kv_heads, device=dev).view(1, kv_heads, 1, 1, 1)
    rows = ((bt[:, None, :, None, None] * 2 + which) * page + off) \
        * kv_heads + heads
    return rows.reshape(-1).int()


def build_paged_decode_graph(*, b: int, kvh: int, g_pad: int, n_pages: int,
                             page: int, d: int, dtype=torch.float32,
                             kv_dtype=None, depth: int = 2,
                             streams: int = 1):
    """Declare the paged-decode StreamGraph at one shape point, as the
    reference does: an ``ff_gather`` of the step's page rows (a word of
    ``2 * page`` rows, one merged K+V page) feeding the paged consumer
    through a fusable edge. Fused, it runs the paged ``ring_decode_kernel``
    (one launch, the pages read through the block table the rows walk);
    staged, the gather then the contiguous kernel at ``block_kv ==
    page``."""
    from repro_torch.core.graph import GraphEdge, GraphNode, StreamGraph
    from repro_torch.kernels.ff_decode_attention.program import \
        build_paged_program
    from repro_torch.kernels.ff_gather.ops import _ROWS, gather_workload
    from repro_torch.kernels.ff_gather.program import \
        build_program as gather_prog

    kv_dtype = kv_dtype or dtype
    assert (2 * page) % _ROWS == 0, (page, _ROWS)
    n_rows = b * kvh * n_pages * 2 * page
    gather_p = gather_prog(n_rows, d, dtype=kv_dtype, depth=depth,
                           streams=(2 * page) // _ROWS)
    attn = build_paged_program(b, kvh, g_pad, n_pages, page, d, dtype=dtype,
                               kv_dtype=kv_dtype, depth=depth,
                               streams=streams)
    w_g, t_g = gather_workload(n_rows, d, dtype=kv_dtype)
    (_, w_a, t_a), = paged_decode_nodes(b, kvh * g_pad, kvh, n_pages, page,
                                        d, dtype=kv_dtype)
    return StreamGraph(
        name="paged_decode_attention",
        nodes=(
            GraphNode("gather", gather_p, workload=w_g, plan_tile=t_g),
            GraphNode("attn", attn, workload=w_a, plan_tile=t_a),
        ),
        edges=(
            GraphEdge("gather", "attn", "kv"),
        ),
    )


def _graph_args(q, kv_pool, block_tables, lengths):
    """:func:`paged_decode_attention`'s operands as the graph's: the
    table's row walk, the pool as rows, q by KV head."""
    nb, _, page, kvh, d = kv_pool.shape
    b, h, _ = q.shape
    idx = page_word_indices(block_tables, page=page, kv_heads=kvh,
                            n_blocks=nb)
    kw = dict(b=b, kvh=kvh, g_pad=h // kvh, n_pages=block_tables.shape[1],
              page=page, d=d, dtype=q.dtype, kv_dtype=kv_pool.dtype)
    return kw, (idx, kv_pool.reshape(-1, d), lengths,
                q.view(b, kvh, h // kvh, d)), \
        lambda out: out.reshape(b, h, d)


def paged_decode_unfused(q, kv_pool, idx, lengths) -> torch.Tensor:
    """Staged paged decode (the port of the reference's ``_paged_unfused``):
    gather the step's pool rows through ``idx`` (from
    :func:`gather_indices`), then contiguous decode at ``block_kv ==
    page``: the gathered cache round-trips HBM. q: [B, H, d]; kv_pool:
    [nb, 2, page, KVH, d]; lengths: [B]. Equals
    :func:`paged_decode_attention` bit for bit: both read the same values
    in the same tile order."""
    _, _, page, kvh, d = kv_pool.shape
    rows = gather(kv_pool.reshape(-1, d), idx)
    cache = rows.view(2, q.shape[0], kvh, -1, d)
    return dec_ops.decode_attention(q, cache[0], cache[1], lengths,
                                    block_kv=page)


# ---------------------------------------------------------------------------
# Scatter helpers (prefill admission, per-step token append)
# ---------------------------------------------------------------------------


def to_device(x, device) -> torch.Tensor:
    """``x`` (a host array or a tensor) on ``device`` without a host sync:
    a host-to-card copy goes through pinned memory, ``non_blocking``."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _masked_write(dst, index, vals, keep) -> None:
    """``dst[..., blk, :, off] = vals`` (each row's K and V) for the rows
    where ``keep`` holds, without sizing a tensor by ``keep``. ``dst`` is
    one layer's pool [nb, 2, page, KVH, hd] or the stacked pool
    [L, nb, ...]; ``index`` is (blk, off), [R] each, blk clipped into the
    block axis; ``vals`` is [R, 2, KVH, hd] or [R, L, 2, KVH, hd]. A
    dropped row writes where the first kept row writes, that row's
    values: duplicate writes of equal bits, so their order does not
    matter. With no row kept, every row writes back the values already
    at row 0's place."""
    blk, off = index
    first = torch.argmax(keep.to(torch.int32)).view(1)   # on the device
    b0, o0 = blk[first], off[first]
    tb = torch.where(keep, blk, b0)
    to = torch.where(keep, off, o0)
    stacked = dst.dim() == 6
    here = dst[:, b0, :, o0] if stacked else dst[b0, :, o0]  # [1, ...]
    donor = torch.where(keep[first], vals.index_select(0, first), here)
    vals = torch.where(keep.view(-1, *[1] * (vals.dim() - 1)), vals, donor)
    if stacked:
        dst[:, tb, :, to] = vals
    else:
        dst[tb, :, to] = vals


def _on_heads(fn, pool, head_dim: int, kvs, kv_head_dim: int, rest):
    """``fn(pool, *kvs, *rest)`` on a DTensor ``pool`` as a local body, in
    place: each rank writes its own KV heads (the pool's shards on dim
    ``head_dim``), the K/V operands ``kvs`` split on ``kv_head_dim`` as the
    pool's heads and gathered on every other dim (every replica of the
    pool takes every row), ``rest`` (tables, lengths: host arrays or
    tensors) whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pool_pl = tuple(p if p == Shard(head_dim) else Replicate()
                    for p in pool.placements)
    if pool_pl != tuple(pool.placements):
        raise ValueError(f"the pool is placed {pool.placements}: only its "
                         f"KV heads (dim {head_dim}) may be sharded")
    kv_pl = [Shard(kv_head_dim) if p == Shard(head_dim) else Replicate()
             for p in pool_pl]
    rep = [Replicate()] * len(pool_pl)
    body = local_map(
        fn, out_placements=list(pool_pl),
        in_placements=(pool_pl, *[kv_pl] * len(kvs),
                       *[rep if shlib.is_dtensor(a) else None
                         for a in rest]),
        device_mesh=pool.device_mesh, redistribute_inputs=True)
    return body(pool, *[shlib.as_dtensor(t, pool) for t in kvs], *rest)


def scatter_prefill(pool, k, v, block_tables, lengths, *, page: int,
                    n_blocks: int):
    """Write prefill KV into the pool (in place) through the block tables.

    pool: [L, nb, 2, page, KVH, hd]; k, v: [L, B, S_p, KVH, hd];
    block_tables: [B, n_pages]; lengths: [B] (host arrays or tensors: a
    host array is copied without a sync). Positions past ``lengths`` and
    sentinel table entries (>= ``n_blocks``) drop. No host sync. Returns
    ``pool``. A DTensor pool takes each rank's heads in a local body."""
    if shlib.is_dtensor(pool):
        return _on_heads(
            lambda p, k_, v_, t, n: scatter_prefill(
                p, k_, v_, t, n, page=page, n_blocks=n_blocks),
            pool, 4, (k, v), 3, (block_tables, lengths))
    dev = pool.device
    n_layers, b, s_p = k.shape[:3]
    pos = torch.arange(s_p, device=dev)
    bt = to_device(block_tables, dev).long()
    lens = to_device(lengths, dev).long()
    blk = bt[:, (pos // page).clamp(0, bt.shape[1] - 1)]      # [B, S_p]
    blk = torch.where(pos[None] < lens[:, None], blk, n_blocks)
    off = (pos % page).expand_as(blk)
    keep = ((blk >= 0) & (blk < n_blocks)).reshape(-1)
    index = (blk.reshape(-1).clamp(0, pool.shape[1] - 1), off.reshape(-1))
    kv = torch.stack([k, v], dim=3).to(pool.dtype)   # [L, B, S_p, 2, ...]
    _masked_write(pool, index,
                  kv.reshape(n_layers, b * s_p, *kv.shape[3:]).transpose(
                      0, 1), keep)
    return pool


def scatter_token(pool_layer, block_tables, lengths, k_new, v_new,
                  n_blocks: int):
    """Append one token's K/V at position ``lengths`` (per row) into one
    layer's pool, in place. pool_layer: [nb, 2, page, KVH, hd]; k_new,
    v_new: [B, KVH, hd]. Sentinel table entries (>= n_blocks) drop the
    write. No host sync: a CUDA graph captures it. Returns
    ``pool_layer``. A DTensor pool takes each rank's heads in a local
    body."""
    if shlib.is_dtensor(pool_layer):
        return _on_heads(
            lambda p, k_, v_, t, n: scatter_token(p, t, n, k_, v_, n_blocks),
            pool_layer, 3, (k_new, v_new), 1, (block_tables, lengths))
    page = pool_layer.shape[2]
    b = k_new.shape[0]
    bt = block_tables.long()
    lens = lengths.long()
    rows = torch.arange(b, device=bt.device)
    blk = bt[rows, (lens // page).clamp(0, bt.shape[1] - 1)]
    keep = (blk >= 0) & (blk < n_blocks)
    index = (blk.clamp(0, pool_layer.shape[0] - 1), lens % page)
    _masked_write(pool_layer, index,
                  torch.stack([k_new, v_new], dim=1).to(pool_layer.dtype),
                  keep)
    return pool_layer


# ---------------------------------------------------------------------------
# Host-side allocator + cache
# ---------------------------------------------------------------------------


class OutOfBlocks(RuntimeError):
    """Raised when an admission asks for more KV blocks than are free."""


class BlockAllocator:
    """LIFO free-list allocator over ``n_blocks`` page-sized KV blocks.

    Freshly retired blocks are reissued first, so the working set stays
    compact; any ``k <= n_free`` allocation succeeds (no external
    fragmentation; the only waste is at most ``page - 1`` rows in each
    request's last block).
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` block ids, or raise :class:`OutOfBlocks` leaving the
        free list untouched (admission is all-or-nothing)."""
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(pool has {self.n_blocks})")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        for i in ids:
            self._free.append(int(i))


class PagedKVCache:
    """Device-resident paged KV pool + host-side slot/block bookkeeping.

    The pool ``[L, n_blocks, 2, page, KVH, hd]`` is shared by all decode
    slots; each slot owns a block table (host array of block ids,
    sentinel-filled), mirrored in one device buffer that is rewritten only
    when a table changes (admit, retire). :meth:`cache_view` is the cache
    the model consumes: ``{"kv_pool": pool, "block_tables": [L, n_slots,
    n_pages_max]}`` (the device buffer broadcast over layers). After a
    decode step, :meth:`update` takes the pool and table buffer the step
    returned as the cache's own, so a compiled step, whose graph reads
    fixed addresses, gets back the buffers it wrote and copies nothing in.

    Made under a mesh (``runtime.sharding.use_sharding``), the pool is
    placed by :data:`POOL_AXES` (KV heads over "model" where they divide)
    and :meth:`cache_view` hands the tables out replicated: each rank
    keeps the same host tables, which agree while its scheduler's clock
    does.
    """

    def __init__(self, *, n_layers: int, n_blocks: int, page: int,
                 kv_heads: int, head_dim: int, n_slots: int,
                 n_pages_max: int, dtype=torch.float32, device="cpu"):
        self.n_layers = n_layers
        self.n_blocks = n_blocks
        self.page = page
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.n_slots = n_slots
        self.n_pages_max = n_pages_max
        self.device = torch.device(device)
        shape = (n_layers, n_blocks, 2, page, kv_heads, head_dim)
        self.pool = torch.zeros(shape, dtype=dtype, device=self.device)
        sharding = shlib.sharding_for(POOL_AXES, shape=shape)
        self._mesh = None if sharding is None else sharding.mesh
        if sharding is not None:
            self.pool = sharding.place(self.pool)
        self.allocator = BlockAllocator(n_blocks)
        self._tables = np.full((n_slots, n_pages_max), n_blocks, np.int32)
        self._device_tables = torch.as_tensor(self._tables).to(self.device)
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self.lengths = np.zeros((n_slots,), np.int32)
        self._live_tokens = 0

    # -- admission / retirement ---------------------------------------------

    def admit(self, slot: int, k_seq, v_seq, length: int,
              reserve_tokens: int) -> None:
        """Claim ``ceil(reserve_tokens / page)`` blocks for ``slot`` and
        scatter the prompt KV (``k_seq``/``v_seq``: [L, S_p, KVH, hd],
        valid prefix ``length``). Raises :class:`OutOfBlocks` atomically
        (no partial allocation) when the pool cannot hold the reservation.
        """
        if self._owned[slot]:
            raise ValueError(f"slot {slot} already occupied")
        n_pages = -(-int(reserve_tokens) // self.page)
        if n_pages > self.n_pages_max:
            raise ValueError(
                f"reservation {reserve_tokens} tokens = {n_pages} pages "
                f"exceeds n_pages_max={self.n_pages_max}")
        ids = self.allocator.alloc(n_pages)
        self._owned[slot] = ids
        self._tables[slot, :] = self.n_blocks
        self._tables[slot, :n_pages] = ids
        self.lengths[slot] = length
        self._live_tokens += int(length)
        self._sync_tables()
        scatter_prefill(self.pool, k_seq[:, None], v_seq[:, None],
                        self._device_tables[slot:slot + 1],
                        np.array([length], np.int32), page=self.page,
                        n_blocks=self.n_blocks)

    def append(self, n_per_slot) -> None:
        """Host bookkeeping after a decode step appended tokens on device."""
        self.lengths = self.lengths + np.asarray(n_per_slot, np.int32)
        self._live_tokens += int(np.sum(n_per_slot))

    def retire(self, slot: int) -> None:
        """Free ``slot``'s blocks back to the pool."""
        self._live_tokens -= int(self.lengths[slot])
        self.allocator.free(self._owned[slot])
        self._owned[slot] = []
        self._tables[slot, :] = self.n_blocks
        self.lengths[slot] = 0
        self._sync_tables()

    # -- device views --------------------------------------------------------

    def _sync_tables(self) -> None:
        """Copy the host tables into the device buffer (no host sync)."""
        self._device_tables.copy_(to_device(self._tables, self.device))

    def device_tables(self) -> torch.Tensor:
        """Block tables broadcast over layers: [L, n_slots, n_pages_max]
        (every layer shares one table; the pool's L axis separates them),
        a view of the one device buffer (replicated on a mesh)."""
        bt = self._device_tables
        bt = bt.expand(self.n_layers, *bt.shape)
        if self._mesh is None:
            return bt
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(bt, self._mesh,
                                  [Replicate()] * self._mesh.ndim,
                                  run_check=False)

    def cache_view(self) -> Dict[str, torch.Tensor]:
        """The paged decode cache ``attn_apply`` consumes (leading L axis
        on every leaf, matching the layer stack)."""
        return {"kv_pool": self.pool, "block_tables": self.device_tables()}

    def update(self, cache: Dict[str, torch.Tensor]) -> None:
        """Adopt the cache a decode step returned: its pool, and its table
        buffer (which holds this cache's tables: the step read them; on a
        mesh, the replicated DTensor's local buffer)."""
        bt = cache["block_tables"]
        if shlib.is_dtensor(bt):
            bt = bt.to_local()
        if bt.stride(0) != 0:
            raise ValueError("block_tables is not one [n_slots, n_pages] "
                             "buffer broadcast over layers")
        self.pool = cache["kv_pool"]
        self._device_tables = bt[0]

    # -- metrics -------------------------------------------------------------

    def utilization(self) -> Dict[str, float]:
        """KV-memory utilization: live tokens vs. allocated block capacity
        vs. whole-pool capacity."""
        alloc_blocks = self.n_blocks - self.allocator.n_free
        alloc_tokens = alloc_blocks * self.page
        pool_tokens = self.n_blocks * self.page
        return {
            "live_tokens": float(self._live_tokens),
            "allocated_tokens": float(alloc_tokens),
            "pool_tokens": float(pool_tokens),
            "util_vs_allocated": (self._live_tokens / alloc_tokens
                                  if alloc_tokens else 0.0),
            "util_vs_pool": self._live_tokens / pool_tokens,
        }


def _graph_inputs(gen, device, *, b=2, h=4, kvh=2, page=16, n_pages=4,
                  d=64, dtype=torch.float32):
    nb = b * n_pages + 2
    q = torch.randn((b, h, d), generator=gen, device=device).to(dtype)
    pool = torch.randn((nb, 2, page, kvh, d), generator=gen,
                       device=device).to(dtype)
    tables = torch.randperm(nb, generator=gen, device=device)[
        :b * n_pages].view(b, n_pages).int()
    lens = torch.randint(1, n_pages * page + 1, (b,), generator=gen,
                         device=device).int()
    return q, pool, tables, lens


def _graph_sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep)
    kvh = int(site["kvh"])
    return _graph_inputs(
        gen, device, b=int(site["b"]), h=max(1, int(site["h"]) // kvh) * kvh,
        kvh=kvh, page=int(site["page"]), n_pages=int(site["n_pages"]),
        d=int(site["d"]),
        dtype=getattr(torch, site.get("dtype", "float32"))), {}


def _graph_unfused(q, kv_pool, block_tables, lengths):
    nb, _, page, kvh, _ = kv_pool.shape
    idx = gather_indices(block_tables, page=page, kv_heads=kvh, n_blocks=nb)
    return paged_decode_unfused(q, kv_pool, idx, lengths)


def _register_graph():
    from repro_torch.kernels.registry import register_graph

    register_graph(
        name="paged_decode_attention",
        op=paged_decode_attention,
        make_inputs=_graph_inputs,
        ref=paged_decode_attention_ref,
        unfused=_graph_unfused,
        tol=2e-4,
        doc="block-table gather -> decode attention, one launch",
        sweep_inputs=_graph_sweep_inputs,
        build=build_paged_decode_graph,
        graph_args=_graph_args,
    )


_register_graph()
