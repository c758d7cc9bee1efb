"""Roofline-driven pipe planner (the port of ``repro/core/planner.py``).

The paper leaves (depth, #producers, #consumers) to the programmer, guided
by profiler output, and reports two empirical rules: depth barely matters
once latency is hidden, and >2x2 streams saturate the memory system. The
planner encodes exactly that reasoning on top of the analytic model, so the
framework can size pipes automatically per kernel call site.

The port plans against one block's shared memory (227 KB) instead of TPU
VMEM, and every kernel passes what it can run: its deepest ring
(``depth_cap``, the kernel's ``max_depth``) and its legal stream counts
(``stream_options``). Everything else is the reference's, to the number.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.core import profiling
from repro_torch.core.meshspec import MeshSpec, SINGLE_DEVICE, resolve_mesh
from repro_torch.core.pipe import DEFAULT_SMEM_BUDGET_BYTES, Pipe, \
    dtype_name, required_depth, smem_budget_ok
from repro_torch.core.pipeline_model import (
    H100_SXM,
    HardwareModel,
    Workload,
    estimate_feedforward,
)


class PlanError(RuntimeError):
    """No feasible (depth, streams) candidate under the shared-memory
    budget.

    Raised (never asserted: asserts vanish under ``python -O``) with the
    full search context attached, so autotune/bench callers can report the
    search space instead of a bare failure:

    Attributes:
      workload: the :class:`~repro_torch.core.pipeline_model.Workload` planned for.
      smem_budget_bytes: the budget every candidate was checked against.
      rejected: one human-readable line per rejected candidate.
    """

    def __init__(self, workload: Workload, smem_budget_bytes: int,
                 rejected: Sequence[str]):
        self.workload = workload
        self.smem_budget_bytes = smem_budget_bytes
        self.rejected = tuple(rejected)
        lines = "; ".join(self.rejected) or "(no candidates generated)"
        super().__init__(
            f"no feasible pipe under the {smem_budget_bytes}-byte shared-"
            f"memory budget for workload {workload}; rejected: {lines}")


@dataclasses.dataclass(frozen=True)
class Plan:
    pipe: Pipe
    consumers: int
    predicted_s: float
    predicted_bw: float
    rationale: str
    skipped: Tuple[str, ...] = ()    # rejected candidates, one line each
    # what the plan was sized against: the (local, per-shard) workload and
    # the mesh topology the call site ran under — introspectable via
    # last_plan() so sharded tests can assert local-shape planning
    workload: Optional[Workload] = None
    mesh: MeshSpec = SINGLE_DEVICE


def plan_pipe(
    w: Workload,
    tile: Tuple[int, ...],
    dtype,
    hw: HardwareModel = H100_SXM,
    stream_options: Sequence[int] = (1, 2, 4),
    depth_cap: int = 17,     # (cap-1) outstanding = burst-LSU parity
    smem_budget_bytes: Optional[int] = DEFAULT_SMEM_BUDGET_BYTES,
) -> Plan:
    """Pick (depth, streams) minimizing modeled time under the
    shared-memory budget (``None``: no budget check; a kernel of the port
    passes its own deepest ring as ``depth_cap`` instead, since its
    planning tile is the reference's word, not its ring's stage).

    Ties break toward fewer streams and shallower pipes (the paper's
    "limit the number of channels" guidance).
    """
    base_pipe = Pipe(tile=tile, dtype=dtype, depth=2, streams=1)
    service = w.word_bytes / hw.stream_bandwidth(1, w.regular)
    # a kernel whose ring holds one stage at these shapes caps it below
    # required_depth's floor of 2
    depth = min(required_depth(hw.dma_latency_s, service, cap=depth_cap),
                depth_cap)

    best: Plan | None = None
    skipped = []
    for streams in stream_options:
        if tile[0] % streams != 0:
            skipped.append(
                f"streams={streams}: tile[0]={tile[0]} not divisible")
            continue
        pipe = base_pipe.with_depth(depth).with_streams(streams)
        if smem_budget_bytes is not None and \
                not smem_budget_ok([pipe], smem_budget_bytes):
            skipped.append(
                f"streams={streams} depth={depth}: ring smem "
                f"{pipe.smem_bytes}B > budget {smem_budget_bytes}B")
            continue
        est = estimate_feedforward(w, hw, pipe)
        cand = Plan(
            pipe=pipe,
            consumers=streams,
            predicted_s=est.total_s,
            predicted_bw=est.achieved_bw,
            workload=w,
            rationale=(
                f"depth={depth} hides dma latency "
                f"({hw.dma_latency_s*1e9:.0f}ns over {service*1e9:.0f}ns/word); "
                f"streams={streams} bottleneck={est.bottleneck}"),
        )
        # require a >2% modeled win to take on more streams (channel-count
        # frugality, per the paper)
        if best is None or cand.predicted_s < best.predicted_s * 0.98:
            best = cand
    if best is None:
        raise PlanError(w, smem_budget_bytes, skipped)
    if skipped:
        best = dataclasses.replace(
            best, skipped=tuple(skipped),
            rationale=best.rationale + f"; skipped: {'; '.join(skipped)}")
    return best


# -- call-site auto-sizing (depth="auto" / streams="auto") --------------------
#
# Every kernel's public op wrapper routes through here: the op builds its
# Workload from the call-site shapes and the planner returns the (depth,
# streams) the analytic model picks. Plans are memoized: the key is
# (op, workload, tile, dtype, hw, mesh, knobs) — workload and tile are pure
# functions of (op, shape, dtype), so this is the per-(op, shape, dtype, hw,
# mesh) plan cache with no risk of shape aliasing, and plans sized under one
# mesh topology are never served to call sites running under another.
#
# The cache is a hand-rolled insertion-ordered dict (FIFO eviction), as the
# reference's. Its generation counts the clears: a compiled step keys its
# CUDA graphs by it (launch/steps.py), since a graph holds the plans it was
# captured with.


class _CacheInfo(NamedTuple):
    hits: int
    misses: int
    maxsize: int
    currsize: int


_PLAN_MAXSIZE = 1024
_PLANS: "dict[tuple, Plan]" = {}    # insertion-ordered: FIFO eviction
_PLAN_HITS = 0
_PLAN_MISSES = 0
_GENERATION = 0


def generation() -> int:
    """How many times the plan cache was cleared."""
    return _GENERATION


def _plan_cached(op: str, w: Workload, tile: Tuple[int, ...],
                 dtype: str, hw: HardwareModel,
                 stream_options: Tuple[int, ...], depth_cap: int,
                 smem_budget_bytes: Optional[int], mesh: MeshSpec) -> Plan:
    global _PLAN_HITS, _PLAN_MISSES
    key = (op, w, tile, dtype, hw, stream_options, depth_cap,
           smem_budget_bytes, mesh)
    plan = _PLANS.get(key)
    if plan is not None:
        _PLAN_HITS += 1
        return plan
    _PLAN_MISSES += 1
    plan = plan_pipe(w, tile, dtype, hw,
                     stream_options=stream_options, depth_cap=depth_cap,
                     smem_budget_bytes=smem_budget_bytes)
    plan = dataclasses.replace(plan, mesh=mesh)
    if len(_PLANS) >= _PLAN_MAXSIZE:
        _PLANS.pop(next(iter(_PLANS)))
    _PLANS[key] = plan
    return plan


def invalidate_mesh_plans(keep: MeshSpec, *,
                          keep_single: bool = True) -> int:
    """Drop every cached plan keyed by a mesh other than ``keep``.

    The elastic-recovery hook: after a remesh the surviving topology is
    ``keep``; plans sized under the lost topology must never be served
    again, while plans for the surviving mesh (and, by default, the
    topology-independent :data:`SINGLE_DEVICE` entries) stay warm.
    ``last_plan`` entries for dropped meshes are cleared too. Returns the
    number of plans dropped.
    """
    kept_meshes = {keep} | ({SINGLE_DEVICE} if keep_single else set())
    stale = [k for k, p in _PLANS.items() if p.mesh not in kept_meshes]
    for k in stale:
        del _PLANS[k]
    for op in [op for op, p in _LAST_PLAN.items()
               if p.mesh not in kept_meshes]:
        del _LAST_PLAN[op]
    return len(stale)


_LAST_PLAN: "dict[str, Plan]" = {}   # op -> most recent plan resolved


def last_plan(op: str) -> Optional[Plan]:
    """The most recent plan resolved for ``op`` (introspection hook: its
    ``workload``/``mesh`` record what the call site was actually sized
    against — the sharded-stream tests assert local-shape planning here)."""
    return _LAST_PLAN.get(op)


def planned_pipe(
    op: str,
    w: Workload,
    tile: Tuple[int, ...],
    dtype,
    hw: HardwareModel = H100_SXM,
    stream_options: Sequence[int] = (1, 2, 4),
    depth_cap: int = 17,
    smem_budget_bytes: Optional[int] = DEFAULT_SMEM_BUDGET_BYTES,
    mesh: MeshSpec = SINGLE_DEVICE,
) -> Plan:
    """Memoized :func:`plan_pipe` for one kernel call site."""
    pre_misses = _PLAN_MISSES
    with obs.span("plan_pipe", op=op, mesh=mesh.token) as sp:
        plan = _plan_cached(op, w, tuple(tile), dtype_name(dtype), hw,
                            tuple(stream_options), depth_cap,
                            smem_budget_bytes, mesh)
        sp.set(depth=plan.pipe.depth, streams=plan.pipe.streams,
               predicted_s=plan.predicted_s,
               cached=_PLAN_MISSES == pre_misses)
    _LAST_PLAN[op] = plan
    return plan


def resolve_auto(
    op: str,
    depth: Union[int, str],
    streams: Union[int, str],
    *,
    workload: Workload,
    tile: Tuple[int, ...],
    dtype,
    hw: HardwareModel = H100_SXM,
    stream_options: Sequence[int] = (1, 2, 4),
    mesh: MeshSpec = SINGLE_DEVICE,
    depth_cap: int = 17,
    smem_budget_bytes: Optional[int] = DEFAULT_SMEM_BUDGET_BYTES,
) -> Tuple[int, int]:
    """Resolve ``depth="auto"`` / ``streams="auto"`` to planned integers.

    Explicit integers pass through untouched (the paper's programmer-chosen
    sizing stays available); the planner only runs when at least one of the
    two is ``"auto"``, and its Plan is served from the per-(op, shape,
    dtype, hw, mesh) cache on repeat call sites. ``"measured"`` is accepted
    as a synonym for ``"auto"`` here: it is the analytic *fallback* for call
    sites the autotuner (:mod:`repro_torch.core.autotune`) cannot measure (traced
    arguments, no runner) — measured resolution itself never reaches this
    function. ``depth_cap`` is the kernel's deepest ring, with
    ``smem_budget_bytes=None`` the only bound on it.
    """
    for label, val in (("depth", depth), ("streams", streams)):
        if isinstance(val, str) and val not in ("auto", "measured"):
            raise ValueError(
                f"{label} must be an int or 'auto'/'measured', got {val!r}")
    depth = "auto" if depth == "measured" else depth
    streams = "auto" if streams == "measured" else streams
    if depth != "auto" and streams != "auto":
        return int(depth), int(streams)
    plan = planned_pipe(op, workload, tile, dtype, hw,
                        stream_options=stream_options, depth_cap=depth_cap,
                        smem_budget_bytes=smem_budget_bytes, mesh=mesh)
    d = plan.pipe.depth if depth == "auto" else int(depth)
    s = plan.pipe.streams if streams == "auto" else int(streams)
    return d, s


def resolve_policy(
    op: str,
    policy,
    *,
    workload: Workload,
    tile: Tuple[int, ...],
    dtype,
    mesh: Optional[MeshSpec] = None,
    depth_cap: Optional[int] = None,
    stream_options: Optional[Sequence[int]] = None,
) -> Tuple[int, int]:
    """Planner entry for :class:`repro_torch.core.program.PipePolicy` call
    sites.

    Duck-typed over anything exposing ``mode`` / ``depth`` / ``streams`` /
    ``hw`` / ``stream_options`` (and optionally ``mesh``): resolves "auto"
    fields against the policy's hardware model and mesh topology (so plans
    are cache-keyed by policy *and* topology, not just shape) and applies
    the mode semantics — ``baseline`` forces the synchronous depth=1 pipe
    after planning, exactly like the legacy per-kernel keyword plumbing
    did. A policy without a mesh plans under the ambient mesh (the
    installed ``runtime.sharding`` context), else single-device.
    ``depth_cap`` and
    ``stream_options`` (default: the policy's) are what the kernel can run:
    its deepest ring and its legal stream counts among the policy's. A
    kernel's ``depth_cap`` replaces the generic budget check (its own
    shared-memory model bounds its ring); without one the reference's
    cap (17) and the budget apply.
    """
    if mesh is None:
        mesh = resolve_mesh(getattr(policy, "mesh", None))
    if profiling.recording():
        # planner-origin traffic record: suppressed when the call came
        # through autotune.resolve_call (which already recorded it)
        profiling.emit_planner(op=op, policy=policy, workload=workload,
                               tile=tile, dtype=dtype_name(dtype),
                               mesh=mesh)
    with obs.span("resolve_policy", op=op, mode=policy.mode,
                  mesh=mesh.token) as sp:
        depth, streams = resolve_auto(
            op, policy.depth, policy.streams, workload=workload, tile=tile,
            dtype=dtype, hw=policy.hw,
            stream_options=tuple(policy.stream_options
                                 if stream_options is None
                                 else stream_options),
            mesh=mesh, depth_cap=17 if depth_cap is None else depth_cap,
            smem_budget_bytes=(DEFAULT_SMEM_BUDGET_BYTES
                               if depth_cap is None else None))
        if policy.mode == "baseline":
            depth = 1
        sp.set(depth=depth, streams=streams)
    return depth, streams


# -- multi-kernel graphs ------------------------------------------------------
#
# A fused graph runs several stream programs in one launch, so one block's
# shared memory is split across the fused stages: each node plans its pipes
# against its share.


def split_graph_budget(names: Sequence[str],
                       smem_budget_bytes: int = DEFAULT_SMEM_BUDGET_BYTES,
                       ) -> "dict[str, int]":
    """Split the shared-memory budget evenly across a graph's nodes.

    Even split is deliberate: the budget bounds the *worst case* where every
    adjacent edge fuses and all stages cohabit one kernel. A node that plans
    under its share is guaranteed composable into any fused segment.
    """
    if not names:
        return {}
    share = smem_budget_bytes // len(names)
    return {n: share for n in names}


def plan_cache_info() -> _CacheInfo:
    """Hit/miss stats of the planner's plan cache (CacheInfo-shaped)."""
    return _CacheInfo(_PLAN_HITS, _PLAN_MISSES, _PLAN_MAXSIZE, len(_PLANS))


def plan_cache_clear() -> None:
    global _PLAN_HITS, _PLAN_MISSES, _GENERATION
    _GENERATION += 1
    _PLANS.clear()
    _PLAN_HITS = 0
    _PLAN_MISSES = 0
    _LAST_PLAN.clear()
