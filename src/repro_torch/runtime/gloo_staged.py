"""``gloo_staged``: gloo with point-to-point transfers of CUDA tensors staged
through pinned host memory.

Several ranks sharing one card cannot run NCCL ("Duplicate GPU
detected"), so they run gloo. Gloo's collectives take CUDA tensors (it
stages them itself), but its ``send``/``recv`` hand the device pointer to
the TCP transport and the process dies ("writev ... Bad address"). The
ring hops of :mod:`repro_torch.runtime.collectives` and the stage handoffs
of :mod:`repro_torch.runtime.pipeline_parallel` are point-to-point, so
this backend wraps one gloo process group: every collective goes to gloo
as it is, and ``send``/``recv`` of a CUDA tensor go through a pinned host
copy (``recv`` copies back to the card when its work is waited on, so the
transfer stays in flight while the caller computes). Nothing else runs on
the host.

It also counts the payload bytes this process hands to each collective
(:func:`traffic`), the per-step collective bytes the trainer reports.

The caller chooses it by name (``--dist-backend gloo_staged``, or
``init_process_group("gloo_staged", ...)`` after :func:`register`); a
failure never switches backends.
"""

from __future__ import annotations

import collections
import datetime
from typing import Dict, List

import torch
import torch.distributed as dist

NAME = "gloo_staged"

# payload bytes this process handed to each kind of call, every group
_TRAFFIC: "collections.Counter[str]" = collections.Counter()


def traffic() -> Dict[str, int]:
    """Payload bytes this process has handed to each kind of call of a
    ``gloo_staged`` group so far (the input tensors: what a rank puts on
    the wire, before any fan-out)."""
    return dict(_TRAFFIC)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _host(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


class _RecvWork(dist._Work):
    """A gloo receive into host buffers; waiting copies them to the card."""

    def __init__(self, inner, pairs):
        super().__init__()
        self._inner = inner
        self._pairs = pairs

    def wait(self, timeout: datetime.timedelta = datetime.timedelta(0)
             ) -> bool:
        self._inner.wait()
        for dst, host in self._pairs:
            dst.copy_(host, non_blocking=True)
        return True

    def is_completed(self) -> bool:
        return self._inner.is_completed()


class _SendWork(dist._Work):
    """A gloo send from host copies, kept alive until it is waited on."""

    def __init__(self, inner, hosts):
        super().__init__()
        self._inner = inner
        self._hosts = hosts

    def wait(self, timeout: datetime.timedelta = datetime.timedelta(0)
             ) -> bool:
        self._inner.wait()
        self._hosts = None
        return True

    def is_completed(self) -> bool:
        return self._inner.is_completed()


class _AllWork(dist._Work):
    """Several gloo works waited on as one."""

    def __init__(self, works):
        super().__init__()
        self._works = works

    def wait(self, timeout: datetime.timedelta = datetime.timedelta(0)
             ) -> bool:
        for w in self._works:
            w.wait()
        return True

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self._works)


class StagedGloo(dist.ProcessGroup):
    """One gloo process group; point-to-point CUDA tensors staged."""

    def __init__(self, store, rank: int, size: int,
                 timeout: datetime.timedelta):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._group_name = ""

    def getBackendName(self) -> str:
        return NAME

    @property
    def group_name(self) -> str:
        # the C++ base reads its name off a backend, which a Python
        # process group does not register
        return self._group_name

    def send(self, tensors: List[torch.Tensor], dst: int, tag: int = 0):
        _TRAFFIC["send"] += _nbytes(tensors)
        if not any(t.is_cuda for t in tensors):
            return self._gloo.send(tensors, dst, tag)
        hosts = [_host(t) for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t)          # synchronous: the send reads it at once
        return _SendWork(self._gloo.send(hosts, dst, tag), hosts)

    def recv(self, tensors: List[torch.Tensor], src: int, tag: int = 0):
        if not any(t.is_cuda for t in tensors):
            return self._gloo.recv(tensors, src, tag)
        hosts = [_host(t) for t in tensors]
        return _RecvWork(self._gloo.recv(hosts, src, tag),
                         list(zip(tensors, hosts)))


    # gloo's Python binding lacks the coalesced tensor forms the functional
    # collectives (DTensor's) call: one base call a pair
    def allgather_into_tensor_coalesced(self, outputs, inputs, opts):
        _TRAFFIC["allgather"] += _nbytes(inputs)
        return _AllWork([self._gloo._allgather_base(o, i, opts)
                         for o, i in zip(outputs, inputs)])

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts):
        _TRAFFIC["reduce_scatter"] += _nbytes(inputs)
        return _AllWork([self._gloo._reduce_scatter_base(o, i, opts)
                         for o, i in zip(outputs, inputs)])


def _delegate(name, payload):
    """gloo's ``name``, counting its argument ``payload`` (the input)."""
    kind = name.lstrip("_").replace("_base", "").replace("_coalesced", "")

    def method(self, *args, **kwargs):
        if payload is not None and len(args) > payload:
            _TRAFFIC[kind] += _nbytes(args[payload])
        return getattr(self._gloo, name)(*args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"gloo's ``{name}`` (it takes CUDA tensors itself)."
    return method


# (method, index of its input argument, None for no payload)
for _name, _payload in (
        ("allreduce", 0), ("allreduce_coalesced", 0), ("allgather", 1),
        ("_allgather_base", 1), ("allgather_coalesced", 1),
        ("reduce_scatter", 1), ("_reduce_scatter_base", 1),
        ("alltoall_base", 1), ("alltoall", 1), ("broadcast", 0),
        ("gather", 1), ("scatter", 1), ("reduce", 0), ("barrier", None),
        ("monitored_barrier", None), ("recv_anysource", None)):
    setattr(StagedGloo, _name, _delegate(_name, _payload))


def _create(opts, _backend_options):
    pg = StagedGloo(opts.store, opts.group_rank, opts.group_size,
                    opts.timeout)
    pg._group_name = opts.group_id     # device meshes look groups up by it
    return pg


def register() -> None:
    """Register ``gloo_staged`` with ``torch.distributed`` in this process
    (idempotent); every rank calls it before ``init_process_group``."""
    if not hasattr(dist.Backend, NAME.upper()):
        dist.Backend.register_backend(NAME, _create, extended_api=True,
                                      devices=["cpu", "cuda"])
