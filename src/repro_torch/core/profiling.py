"""Call-site traffic recording: the hook side of the plan service (the port
of ``repro/core/profiling.py``).

The fleet-scale plan pipeline (:mod:`repro_torch.plans`) needs to know what the
*real* traffic looks like — which ops resolve plans, at which shapes, under
which policies and mesh topologies — rather than tuning against fixed
benchmark shapes. This module is the core-side half of that contract: a
process-global recorder callback that :func:`repro_torch.core.autotune.resolve_call`
and :func:`repro_torch.core.planner.resolve_policy` invoke with one
:class:`CallSite` per resolution.

Core stays dependency-free: nothing here imports :mod:`repro_torch.plans` (the
profile/plandb layer installs itself via :func:`set_recorder`), and with no
recorder installed every hook is a cheap no-op, so serving/training paths
pay nothing unless ``--record-profile`` is active.

Double-count suppression: ``resolve_call`` internally funnels into
``planner.resolve_policy`` (for the analytic reference and fallbacks), so a
single kernel call would otherwise record twice. ``resolve_call`` emits its
richer autotune-origin record first and wraps the rest of the resolution in
:func:`suppress_planner`; planner-origin records are only emitted for call
sites that reach the planner *directly* (legacy callers, graph planning).
The suppression flag is thread-local, so concurrent tuning threads cannot
mask each other's records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Callable, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One recorded plan resolution.

    ``workload`` is the exact :class:`~repro_torch.core.pipeline_model.Workload`
    the call site planned for; ``site`` is the kernel-specific shape
    kwargs (mirroring the kernel's workload builder signature) that the
    offline sweep uses to synthesize concrete operands, with
    ``site_dynamic`` naming the keys that vary with traffic (and are
    therefore shape-bucketed by :class:`repro_torch.plans.TrafficProfile`).
    ``policy`` is a plain-dict summary (mode/depth/streams/stream_options/
    interpret) — enough to rebuild an equivalent search policy offline.
    ``interpret`` is always false in the port (it has no interpret mode);
    the key stays so that a profile's format is the reference's.
    """

    origin: str                       # "autotune" | "planner"
    op: str
    workload: Any
    tile: Tuple[int, ...]
    dtype: str
    hw: str
    mesh_axes: Tuple[Tuple[str, int], ...]
    policy: Mapping[str, Any]
    extra_key: str = ""
    site: Optional[Mapping[str, Any]] = None
    site_dynamic: Tuple[str, ...] = ()


_recorder: Optional[Callable[[CallSite], None]] = None


class _TLS(threading.local):
    def __init__(self):
        self.suppress = 0


_tls = _TLS()


def set_recorder(fn: Optional[Callable[[CallSite], None]]):
    """Install (or clear, with None) the process-global recorder; returns
    the previous recorder so scopes can nest and restore."""
    global _recorder
    prev = _recorder
    _recorder = fn
    return prev


def recording() -> bool:
    """True when a recorder is installed (hooks short-circuit otherwise)."""
    return _recorder is not None


@contextlib.contextmanager
def suppress_planner():
    """Scope in which planner-origin emits are dropped (resolve_call has
    already recorded the richer autotune-origin CallSite)."""
    _tls.suppress += 1
    try:
        yield
    finally:
        _tls.suppress -= 1


def policy_summary(policy) -> dict:
    """The rebuildable subset of a PipePolicy (duck-typed); ``interpret``
    is false (see :class:`CallSite`)."""
    return {
        "mode": policy.mode,
        "depth": policy.depth,
        "streams": policy.streams,
        "stream_options": tuple(int(s) for s in policy.stream_options),
        "interpret": False,
    }


def _emit(cs: CallSite) -> None:
    rec = _recorder
    if rec is None:
        return
    try:
        rec(cs)
    except Exception as e:   # noqa: BLE001 — recording must never break serving
        set_recorder(None)
        warnings.warn(
            f"traffic recorder raised ({type(e).__name__}: {e}); recording "
            f"disabled for the rest of the process", RuntimeWarning,
            stacklevel=2)


def emit_call(*, op, policy, workload, tile, dtype, mesh, extra_key="",
              site=None, site_dynamic=()) -> None:
    """Autotune-origin record (one per ``resolve_call``)."""
    if _recorder is None:
        return
    _emit(CallSite(
        origin="autotune", op=op, workload=workload, tile=tuple(tile),
        dtype=str(dtype), hw=policy.hw.name, mesh_axes=tuple(mesh.axes),
        policy=policy_summary(policy), extra_key=extra_key,
        site=dict(site) if site else None,
        site_dynamic=tuple(site_dynamic)))


def emit_planner(*, op, policy, workload, tile, dtype, mesh) -> None:
    """Planner-origin record — dropped inside :func:`suppress_planner`
    (the owning ``resolve_call`` already recorded the call site)."""
    if _recorder is None or _tls.suppress:
        return
    _emit(CallSite(
        origin="planner", op=op, workload=workload, tile=tuple(tile),
        dtype=str(dtype), hw=policy.hw.name, mesh_axes=tuple(mesh.axes),
        policy=policy_summary(policy)))
