"""Overlap-friendly collectives as Stream producers/consumers (the port of
``repro/runtime/collectives.py``).

The feed-forward model at mesh scale: communication is the producer, the
tensor cores are the consumer, and point-to-point rings are the pipes.
:class:`RingStream` is the ring of one mesh axis, so the word schedule
reads like a kernel's body::

    for word in ring.words():
        hop = ring.hop(cur)        # producer: next word's transfer in flight
        part = consume(cur)        # compute on the landed word
        cur = hop.wait()

``allgather_matmul`` and ``matmul_reducescatter`` interleave each ring hop
with the partial product it feeds: hop k+1's ``batch_isend_irecv`` is in
flight while chunk k multiplies. The local product is pluggable: pass a
:class:`~repro_torch.core.program.PipePolicy` to route it through
``repro_torch.ops.matmul``, the hand-written ``ff_matmul`` kernel on the
card, planned at the *local shard shapes* and cache-keyed by the mesh.

These run on every rank of the axis with local tensors (the reference's
``shard_map`` bodies): the axis's process group is
``mesh.get_group(axis_name)``, the mesh the one given or the ambient
``runtime.sharding`` context's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.runtime import sharding as shlib
    ctx = shlib.current()
    if ctx is None:
        raise ValueError("no mesh: pass mesh= or enter "
                         "repro_torch.runtime.sharding.use_sharding(mesh)")
    return ctx.mesh


class Hop:
    """One transfer in flight: :meth:`wait` returns the received word."""

    def __init__(self, reqs, buf: torch.Tensor):
        self._reqs = reqs
        self._buf = buf

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return self._buf


def exchange(x: torch.Tensor, send_to: Optional[int],
             recv_from: Optional[int], group) -> Hop:
    """Send ``x`` to group rank ``send_to`` and receive a word of its shape
    from ``recv_from`` (either None to skip), both in flight at once
    (``batch_isend_irecv``); the Hop waits for both. Without a receive the
    Hop's word is a zero tensor, as a ``ppermute`` gives a rank no one
    sends to."""
    buf = torch.empty_like(x) if recv_from is not None else \
        torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, recv_from), group))
    return Hop(dist.batch_isend_irecv(ops) if ops else [], buf)


@dataclasses.dataclass(frozen=True)
class RingStream:
    """The inter-device pipe of one mesh axis.

    A hop is the producer moving the next word into this rank's (single)
    ring slot, the loop body is the consumer, and the ring has
    ``n_words() == axis size`` words, one per source shard. ``reverse``
    flips the direction (gather rings shift forward, reduce-scatter rings
    shift partial sums backward).
    """

    axis_name: str
    reverse: bool = False
    mesh: Any = None

    @property
    def group(self):
        return _mesh(self.mesh).get_group(self.axis_name)

    def n_words(self) -> int:
        return dist.get_world_size(self.group)

    def index(self) -> int:
        return dist.get_rank(self.group)

    def hop(self, x: torch.Tensor) -> Hop:
        """Issue the next word's transfer: shift ``x`` one hop around the
        ring (rank i sends to i+1, or i-1 with ``reverse``); the caller
        computes while it is in flight, then waits."""
        n, i = self.n_words(), self.index()
        step = -1 if self.reverse else 1
        return exchange(x, (i + step) % n, (i - step) % n, self.group)


def _local_matmul(policy=None) -> Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]:
    """The consumer's product: ``torch.matmul`` in the promoted type by
    default; with a policy, ``repro_torch.ops.matmul`` under that policy
    (mesh-tagged by :func:`repro_torch.runtime.streams.mesh_policy`, so
    the per-shard plan is keyed by the topology it runs under)."""
    if policy is None:
        def dot(x, w):
            dt = torch.promote_types(x.dtype, w.dtype)
            return torch.matmul(x.to(dt), w.to(dt))
        return dot
    from repro_torch import ops
    from repro_torch.runtime.streams import mesh_policy
    pol = mesh_policy(policy)

    def dot(x, w):
        dt = torch.promote_types(x.dtype, w.dtype)
        return ops.matmul(x, w, policy=pol, out_dtype=dt).to(dt)
    return dot


def ring_allgather(x: torch.Tensor, axis_name: str, mesh=None
                   ) -> torch.Tensor:
    """All-gather along ``axis_name`` via the ring: the concatenation of
    every rank's ``x`` along dim 0, in rank order."""
    ring = RingStream(axis_name, mesh=mesh)
    n, idx = ring.n_words(), ring.index()
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    cur = x
    for word in range(n):
        hop = ring.hop(cur) if word + 1 < n else None   # produce
        out[(idx - word) % n] = cur                      # consume
        if hop is not None:
            cur = hop.wait()
    return out.reshape(n * x.shape[0], *x.shape[1:])


def allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                     axis_name: str, policy=None, mesh=None) -> torch.Tensor:
    """``allgather(x) @ w`` with per-hop overlap.

    x_shard: [m_shard, k] (this rank's rows); w: [k, n] replicated.
    Returns [m_shard * n_dev, n]: each hop's chunk multiplies while the
    next hop's transfer is in flight. ``policy`` routes the per-word
    product through ``repro_torch.ops.matmul``.
    """
    ring = RingStream(axis_name, mesh=mesh)
    dot = _local_matmul(policy)
    n_dev, idx = ring.n_words(), ring.index()
    m = x_shard.shape[0]
    out = torch.empty((n_dev, m, w.shape[1]),
                      dtype=torch.promote_types(x_shard.dtype, w.dtype),
                      device=x_shard.device)
    cur = x_shard
    for word in range(n_dev):
        hop = ring.hop(cur) if word + 1 < n_dev else None   # producer
        out[(idx - word) % n_dev] = dot(cur, w)              # consumer
        if hop is not None:
            cur = hop.wait()
    return out.reshape(n_dev * m, w.shape[1])


def matmul_reducescatter(x: torch.Tensor, w_shard: torch.Tensor,
                         axis_name: str, policy=None, mesh=None
                         ) -> torch.Tensor:
    """``reduce_scatter(x @ allgathered-w)`` in ring form: each word
    multiplies one block of rows by this rank's weight shard and shifts
    the partial sum, the ring reduce-scatter fused with the product that
    feeds it.

    x: [m, k_shard] (this rank's k columns); w_shard: [k_shard, n].
    Returns this rank's [m // n_dev, n] rows of the sum over the axis.
    ``policy`` routes the per-word product through
    ``repro_torch.ops.matmul``.
    """
    ring = RingStream(axis_name, reverse=True, mesh=mesh)
    dot = _local_matmul(policy)
    n_dev, idx = ring.n_words(), ring.index()
    rows = x.shape[0] // n_dev
    hop = None
    for word in range(n_dev):
        blk = (idx + 1 + word) % n_dev
        # consumer: this word's product runs while the partial sum it adds
        # to is still in flight
        part = dot(x[blk * rows:(blk + 1) * rows], w_shard)
        acc = part if hop is None else hop.wait() + part
        if word + 1 < n_dev:
            hop = ring.hop(acc)                        # producer (reverse)
    return acc
