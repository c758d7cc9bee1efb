"""Collective statistics of one step, from records of its collectives (the
port of ``repro/launch/hlo_stats.py``).

The reference parses compiled HLO text: its ``cost_analysis()`` has no
collective term. The port has no HLO. What stands in for it is a record
of every collective a step *dispatches*: :class:`CommCapture` is a
``TorchDispatchMode`` over the functional collectives
(``torch.ops._c10d_functional.*``, which DTensor and the runtime issue on
each rank's local tensors) that records each one's kind, bytes and group
size. ``torch.distributed.tensor.debug.CommDebugMode`` counts the same
operations but gives no bytes. :func:`collective_stats` then applies the
reference's ring model to the records, a wire-time estimate per device:

    all-reduce          2 (g-1)/g * bytes / link_bw
    all-gather          (g-1)/g * bytes / link_bw
    reduce-scatter      (g-1)/g * bytes / link_bw
    all-to-all          (g-1)/g * bytes / link_bw
    collective-permute  bytes / link_bw                (a send)

with ``bytes`` the result's, as the reference's parser reads them from the
HLO (an all-gather's gathered tensor, a reduce-scatter's scattered one).

The dry run (:mod:`repro_torch.launch.dryrun`) captures the L=1 and L=2
variants of a cell and extrapolates per layer, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collective (name after the namespace) -> the reference's kind
_FUNCOL_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective: its kind (one of :data:`KINDS`), its result's bytes
    (what the reference's model counts) and its group size."""

    kind: str
    bytes: int
    group: int


def _nbytes(x) -> int:
    flat, _ = tree_flatten(x)
    return sum(t.numel() * t.element_size() for t in flat
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int:
    """The size of the group named by the collective's last argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[-1]
    return _resolve_process_group(group).size() if isinstance(group, str) \
        else 1


def record_of(func, args, out) -> Optional[CollectiveRecord]:
    """The record of one dispatched operation, or None if it is not a
    functional collective (``wait_tensor`` is not one)."""
    ns, _, rest = func.name().partition("::")
    if ns not in _NAMESPACES:
        return None
    kind = _FUNCOL_KIND.get(rest.split(".")[0])
    if kind is None:
        return None
    # a send's result is the tensor sent
    return CollectiveRecord(kind, _nbytes(out), max(_group_size(args), 1))


class CommCapture(TorchDispatchMode):
    """Records every functional collective dispatched in its scope
    (``records``). An operation on DTensors is left to DTensor
    (``NotImplemented``), so the collectives DTensor issues on the local
    tensors come back through this mode and are seen; the results are
    those of the operations themselves."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(t, DTensor) for t in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, flat, out)
        return out

    def observe(self, func, args, kwargs, flat, out) -> None:
        """One operation on local tensors and its result (``flat``: its
        arguments flattened); records it if it is a collective."""
        rec = record_of(func, args, out)
        if rec is not None:
            self.records.append(rec)


def collective_stats(records: Iterable[CollectiveRecord],
                     link_bw: float = 50e9) -> Dict:
    """Returns {kind: {count, bytes, seconds}, total_bytes, total_seconds,
    total_count}: the reference's dict, from records instead of HLO."""
    stats = {k: {"count": 0, "bytes": 0.0, "seconds": 0.0} for k in KINDS}
    for r in records:
        g = max(int(r.group), 1)
        if r.kind == "all-reduce":
            sec = 2.0 * (g - 1) / g * r.bytes / link_bw
        elif r.kind == "collective-permute":
            sec = r.bytes / link_bw
        else:
            sec = (g - 1) / g * r.bytes / link_bw
        stats[r.kind]["count"] += 1
        stats[r.kind]["bytes"] += float(r.bytes)
        stats[r.kind]["seconds"] += sec
    stats["total_bytes"] = sum(stats[k]["bytes"] for k in KINDS)
    stats["total_seconds"] = sum(stats[k]["seconds"] for k in KINDS)
    stats["total_count"] = sum(stats[k]["count"] for k in KINDS)
    return stats
