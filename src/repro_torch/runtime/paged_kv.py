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
    out-of-range ids, so the ids are filtered first, and the pool is
    updated in place (the donated buffer's counterpart).
  * :func:`paged_decode_attention` — the wrapper of the paged CUDA kernel
    (``kernels/csrc/ff_decode_attention.cu``, which reads pages through the
    table itself; the reference fused an ``ff_gather`` producer into the
    attention consumer for this), with :func:`paged_decode_attention_ref`
    as its plain version.
  * :func:`gather_indices` / :func:`paged_decode_unfused` — the staged
    baseline of the paged kernel: gather the step's pool rows
    (``ff_gather``), then contiguous decode.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels.ff_decode_attention import ops as dec_ops
from repro_torch.kernels.ff_gather import gather


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


def paged_decode_attention(q, kv_pool, block_tables, lengths, *,
                           depth: int = dec_ops.DEFAULT_DEPTH,
                           streams: int = dec_ops.DEFAULT_STREAMS
                           ) -> torch.Tensor:
    """Decode attention for one new token through the block table.

    q: [B, H, d]; kv_pool: [n_blocks, 2, page, KVH, d] (one layer's pool);
    block_tables: [B, n_pages] int (entries >= n_blocks are sentinels);
    lengths: [B] (0 = inactive slot, whose output is exactly 0).
    ``depth`` and ``streams`` size the kernel's ring (the reference's
    ``Pipe`` arguments on its merged ``2 * page``-row K+V word); they
    never change the result. Returns [B, H, d]. CPU tensors run
    :func:`paged_decode_attention_ref`; CUDA tensors launch the kernel."""
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
    dec_ops._pipe(depth, streams, 2 * kv_pool.shape[2], d, q.dtype,
                  q.shape[1] // kvh)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, kv_pool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    out = dec_ops.launch_paged(q, kv_pool, block_tables, lengths,
                               depth=depth, streams=streams)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


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


def scatter_prefill(pool, k, v, block_tables, lengths, *, page: int,
                    n_blocks: int):
    """Write prefill KV into the pool (in place) through the block tables.

    pool: [L, nb, 2, page, KVH, hd]; k, v: [L, B, S_p, KVH, hd];
    block_tables: [B, n_pages]; lengths: [B]. Positions past ``lengths``
    and sentinel table entries (>= ``n_blocks``) drop. Returns ``pool``.
    """
    dev = pool.device
    s_p = k.shape[2]
    pos = torch.arange(s_p, device=dev)
    bt = torch.as_tensor(block_tables, device=dev).long()
    lens = torch.as_tensor(lengths, device=dev).long()
    blk = bt[:, (pos // page).clamp(0, bt.shape[1] - 1)]      # [B, S_p]
    blk = torch.where(pos[None] < lens[:, None], blk, n_blocks)
    off = (pos % page).expand_as(blk)
    keep = (blk >= 0) & (blk < n_blocks)
    bi, si = keep.nonzero(as_tuple=True)
    pool[:, blk[bi, si], 0, off[bi, si]] = k[:, bi, si].to(pool.dtype)
    pool[:, blk[bi, si], 1, off[bi, si]] = v[:, bi, si].to(pool.dtype)
    return pool


def scatter_token(pool_layer, block_tables, lengths, k_new, v_new,
                  n_blocks: int):
    """Append one token's K/V at position ``lengths`` (per row) into one
    layer's pool, in place. pool_layer: [nb, 2, page, KVH, hd]; k_new,
    v_new: [B, KVH, hd]. Sentinel table entries (>= n_blocks) drop the
    write. Returns ``pool_layer``."""
    page = pool_layer.shape[2]
    b = k_new.shape[0]
    bt = block_tables.long()
    lens = lengths.long()
    rows = torch.arange(b, device=bt.device)
    blk = bt[rows, (lens // page).clamp(0, bt.shape[1] - 1)]
    off = lens % page
    keep = ((blk >= 0) & (blk < n_blocks)).nonzero(as_tuple=True)[0]
    pool_layer[blk[keep], 0, off[keep]] = k_new[keep].to(pool_layer.dtype)
    pool_layer[blk[keep], 1, off[keep]] = v_new[keep].to(pool_layer.dtype)
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
    sentinel-filled). :meth:`cache_view` is the cache the model consumes:
    ``{"kv_pool": pool, "block_tables": [L, n_slots, n_pages_max]}``.
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
        self.pool = torch.zeros(
            (n_layers, n_blocks, 2, page, kv_heads, head_dim), dtype=dtype,
            device=self.device)
        self.allocator = BlockAllocator(n_blocks)
        self._tables = np.full((n_slots, n_pages_max), n_blocks, np.int32)
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
        scatter_prefill(self.pool, k_seq[:, None], v_seq[:, None],
                        self._tables[slot:slot + 1], [length],
                        page=self.page, n_blocks=self.n_blocks)

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

    # -- device views --------------------------------------------------------

    def device_tables(self) -> torch.Tensor:
        """Block tables broadcast over layers: [L, n_slots, n_pages_max]
        (every layer shares one table; the pool's L axis separates them)."""
        bt = torch.as_tensor(self._tables).to(self.device)
        return bt.expand(self.n_layers, *bt.shape)

    def cache_view(self) -> Dict[str, torch.Tensor]:
        """The paged decode cache ``attn_apply`` consumes (leading L axis
        on every leaf, matching the layer stack)."""
        return {"kv_pool": self.pool, "block_tables": self.device_tables()}

    def update_pool(self, new_pool) -> None:
        self.pool = new_pool

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
