"""Measured autotuner: search (tile, depth, streams) per call site (the
port of ``repro/core/autotune.py``).

The paper sizes pipes *empirically* — profiler-guided depth/stream choices
per kernel, with the observation that the best configuration is device- and
access-pattern-specific. The analytic planner (:mod:`~repro_torch.core.planner`)
encodes the paper's reasoning but never measures anything; The Memory
Controller Wall (arXiv 1910.06726) documents exactly the gap between
modeled and achieved memory bandwidth that opens up. This module closes it:

* **Candidate generation** is seeded and pruned by the analytic model —
  for every tile option the kernel declares (``KernelSpec.tile_options``)
  and every (depth, streams) the planner considers feasible (shared memory,
  divisibility), candidates are ranked by :func:`estimate_feedforward`
  predicted time and only the top-K are measured. The analytic plan's own
  configuration is always measured first, so every tuned plan records a
  measured-vs-analytic comparison and can never select something slower
  than the analytic choice (it is the argmin over a set containing it).
* **Measurement** runs the real kernel at the call site's shapes:
  warmup + median-of-N wall times, the card synchronized before and after
  each run (the reference's ``jax.block_until_ready``).
* **Persistence**: selected plans land in an on-disk JSON cache
  (``~/.cache/repro_torch/plans.json``, override with the
  ``REPRO_TORCH_PLAN_CACHE`` env var or :func:`tuning_config`), keyed by
  ``(op, workload, dtype, hw, mesh topology, PLAN_FORMAT_VERSION)``. The
  mesh component (axis names/sizes + device count, from ``policy.mesh``)
  scopes tuned plans to the topology they were measured under. The disk cache fronts
  an in-memory dict the same way the planner's ``lru_cache`` fronts
  ``plan_pipe``, so a fresh process reloads tuned plans without
  re-measuring. Checkpoints carry them too: :func:`snapshot_plans` goes
  into every checkpoint's ``extra`` (``runtime/fault_tolerance.py``) and
  :func:`restore_snapshot` pre-warms a resumed job from it.

Entry point for kernels: :func:`resolve_call` — a drop-in superset of
``PipePolicy.resolve`` that returns a :class:`TunedChoice` (tile override +
depth + streams). Policies opt in with ``PipePolicy(mode="autotune")``
(full tile/depth/streams search) or ``depth="measured"`` /
``streams="measured"`` (measured sizing at the kernel's default tile). Call
sites that cannot be measured fall back to the analytic plan with a
warning.

What cannot be measured here: a call inside a compiled step
(``launch/steps.py``), in its eager warm-up or its CUDA-graph capture —
the port's counterpart of the reference's traced operands. Nothing may
launch a candidate or synchronize while a stream is capturing, so
``CompiledStep`` holds :func:`capture_scope` open around both, and every
kernel passes ``runner=None`` inside it (:func:`in_capture`). Measuring
happens only in eager calls and in ``python -m repro_torch.plans sweep``.
A compiled step resolves its plans once, at capture, and its replays
reuse them, so ``plan_resolutions_total`` counts resolutions at capture,
not at replay, as the reference's counts them at trace.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import threading
import time
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import planner, profiling
from repro_torch.core.meshspec import MeshSpec, SINGLE_DEVICE, resolve_mesh
# the graph tuner's keys live with the graph IR; callers reach them here
from repro_torch.core.graph import graph_signature, graph_workload  # noqa: F401
from repro_torch.core.pipe import DEFAULT_SMEM_BUDGET_BYTES, Pipe, \
    dtype_name, required_depth, smem_budget_ok
from repro_torch.core.pipeline_model import estimate_feedforward

# Bump whenever the record schema or the meaning of a key field changes:
# stale on-disk plans from an older format are ignored (their keys embed the
# version), and CI keys its plan-cache restore on this constant.
# v2: keys gained the mesh-topology component (axis names/sizes + device
# count) — plans tuned on one topology must never be served to another, so
# every pre-mesh entry is invalidated wholesale.
# v3: whole-layer graphs widened the joint search space — one (tile, depth,
# streams) choice now covers a 4-6 node decode_layer graph with epilogues
# and multi-consumer edges, and the VMEM budget is split across every fused
# chain stage — so a v2 record tuned against the old per-pair space could
# silently pin a layer-wide plan it never measured.
# The port keeps the reference's format and key layout; its keys differ by
# their hardware name (h100-sxm) and their words.
PLAN_FORMAT_VERSION = 3

_DEFAULT_CACHE_PATH = os.path.join("~", ".cache", "repro_torch",
                                   "plans.json")
_SMEM_BUDGET_BYTES = DEFAULT_SMEM_BUDGET_BYTES
_DEPTH_CAP = 17


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """One resolved call-site configuration.

    ``tile_kwargs`` is the kernel-specific tile override (e.g.
    ``{"block": (256, 128, 128)}`` or ``{"block_kv": 64}``); empty means
    the call site's default tile. ``source`` records where the choice came
    from: "analytic" (policy did not ask for measurement),
    "analytic-fallback" (asked but unmeasurable), "measured" (tuned now),
    "memory"/"disk"/"plandb" (served from the plan cache). ``origin``
    names the tier that originally produced the record ("disk" /
    "plandb" / "measured" / "snapshot") — for a memory hit, the tier that
    installed the in-memory entry, so a cache hit stays distinguishable
    from the layer it shadows; empty for analytic resolutions, which are
    never cached.
    """

    tile_kwargs: Mapping[str, Any]
    depth: int
    streams: int
    source: str
    origin: str = ""


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """Knobs of one tuning session (see :func:`tuning_config`)."""

    warmup: int = 1
    iters: int = 3
    top_k: int = 6
    budget_s: Optional[float] = None
    cache_path: Optional[str] = None
    # release PlanDB (repro_torch.plans.plandb) consulted between the
    # per-host disk cache and measurement; None = $REPRO_TORCH_PLAN_DB
    plan_db: Optional[str] = None
    # tracing sink for the scope: passing trace_path= to tuning_config
    # enables obs spans to that JSONL file (None explicitly disables);
    # leaving the field untouched keeps the ambient REPRO_TORCH_TRACE state
    trace_path: Optional[str] = None


class _ConfigStack(threading.local):
    def __init__(self):
        self.stack = [TuningConfig()]


_configs = _ConfigStack()


def current_tuning_config() -> TuningConfig:
    return _configs.stack[-1]


@contextlib.contextmanager
def tuning_config(**fields):
    """Override tuning knobs for a scope (thread-local, nests).

    ``with tuning_config(budget_s=12, iters=2): ...`` bounds the wall time
    and sampling of any tuning triggered inside; ``cache_path=`` redirects
    the persistent plan cache (tests point it at a tmpdir);
    ``trace_path=`` turns on obs tracing spans to that JSONL file for the
    scope (``trace_path=None`` explicitly disables; omitting the field
    keeps the ambient ``REPRO_TORCH_TRACE`` state).
    """
    cfg = dataclasses.replace(current_tuning_config(), **fields)
    _configs.stack.append(cfg)
    trace_state = None
    if "trace_path" in fields:
        trace_state = (obs.enable(cfg.trace_path) if cfg.trace_path
                       else obs.disable())
    try:
        yield cfg
    finally:
        if trace_state is not None:
            obs.restore(trace_state)
        _configs.stack.pop()


def cache_path() -> str:
    """Resolve the plan-cache file: tuning_config >
    $REPRO_TORCH_PLAN_CACHE > ``~/.cache/repro_torch/plans.json``."""
    cfg = current_tuning_config()
    if cfg.cache_path:
        return cfg.cache_path
    return os.path.expanduser(
        os.environ.get("REPRO_TORCH_PLAN_CACHE") or _DEFAULT_CACHE_PATH)


def plan_db_path() -> Optional[str]:
    """Resolve the release PlanDB file: tuning_config >
    $REPRO_TORCH_PLAN_DB > none. The DB sits *after* the per-host cache in the lookup chain
    (host-measured plans are fresher than the shipped artifact) and is
    read-only: newly measured plans go to the host cache, never the DB."""
    cfg = current_tuning_config()
    p = cfg.plan_db or os.environ.get("REPRO_TORCH_PLAN_DB")
    return os.path.expanduser(p) if p else None


# ---------------------------------------------------------------------------
# Persistent plan cache (disk JSON fronted by an in-memory dict)
# ---------------------------------------------------------------------------

_MEM: Dict[Tuple[str, str], dict] = {}   # (cache path, plan_key) -> record
# which tier installed each _MEM record ("disk" / "plandb" / "measured" /
# "snapshot"): repeat resolutions report source="memory", and this map is
# what keeps a prewarmed-PlanDB hit distinguishable from a self-measured
# one in plan_stats_snapshot() / the obs counters
_MEM_ORIGIN: Dict[Tuple[str, str], str] = {}
_DISK: Dict[str, Dict[str, dict]] = {}   # cache file path -> parsed plans
_LAST: Dict[str, dict] = {}         # op -> last record resolved (for bench)
# (op, plan_key) pairs already warned about: the unmeasurable-call-site
# fallback fires once per distinct (op, workload/constraints), not per call
_warned_fallback_ops = set()

# per-source resolution counters for measured policies (memory / disk /
# plandb / measured / analytic-fallback) plus "analytic" for unmeasured
# policies — the plan service's hit-rate metric.
# "memory" hits additionally count under "memory.<origin>" (disk / plandb /
# measured / snapshot), naming the tier that originally installed the
# in-memory record: a PlanDB prewarm followed by hits is distinguishable
# from records this process measured itself.
_STATS: "collections.Counter[str]" = collections.Counter()

# sources that served a plan without re-measurement at the call site
HIT_SOURCES = ("memory", "disk", "plandb")


def plan_stats_snapshot() -> Dict[str, int]:
    """Resolution counts by source since the last :func:`plan_stats_clear`.

    ``hits``/``lookups``/``hit_rate`` summarize measured-policy resolutions:
    a hit is any plan served without measuring (in-memory, per-host disk
    cache, or the release PlanDB); "measured" and "analytic-fallback" are
    the misses. Unmeasured ("analytic") resolutions are reported but not
    counted as lookups. ``memory.<origin>`` keys split the in-memory hits
    by the tier that installed the record.

    The same counts flow into the obs metrics registry as
    ``plan_resolutions_total{source=...}`` — ``obs.metrics_snapshot()`` is
    the unified surface; this accessor remains for plan-service internals
    and benches."""
    out: Dict[str, Any] = dict(_STATS)
    lookups = sum(_STATS[s] for s in
                  HIT_SOURCES + ("measured", "analytic-fallback"))
    hits = sum(_STATS[s] for s in HIT_SOURCES)
    out["lookups"] = lookups
    out["hits"] = hits
    out["hit_rate"] = (hits / lookups) if lookups else None
    return out


def plan_stats_clear() -> None:
    _STATS.clear()
    obs.metrics_clear("plan_resolutions_total")


def plans_generation() -> tuple:
    """What the plans a call site resolves depend on besides its policy and
    shapes: the planner's and the tuner's cache generations (each clear
    counts) and the plan-cache and PlanDB paths. A compiled step keys its
    CUDA graphs by it (``launch/steps.py``)."""
    return (planner.generation(), _GENERATION, cache_path(), plan_db_path())


def plan_key(op: str, workload, dtype, hw, constraints: str = "",
             mesh: MeshSpec = SINGLE_DEVICE) -> str:
    """Cache key of one call site: (op, workload, dtype, hw, mesh, search
    constraints, format). ``constraints`` carries everything that shapes
    the search or the measurement besides the workload — policy pins,
    kernel statics — so a cached plan is only served to
    call sites it is actually valid for. ``mesh`` is the call site's
    topology (axis names/sizes + device count): a plan measured under one
    mesh never leaks to another (or to single-device call sites)."""
    wl = json.dumps(dataclasses.asdict(workload), sort_keys=True)
    return (f"{op}|{hw.name}|{dtype_name(dtype)}"
            f"|fmt{PLAN_FORMAT_VERSION}"
            f"|mesh{mesh.token}|dev{mesh.device_count}"
            f"|{constraints}|{wl}")


def _policy_constraints(policy, extra_key: str = "") -> str:
    """The search-space signature of a policy: pinned ints (and, outside
    mode="autotune", planner-pinned "auto" fields) constrain the
    candidates, mode="autotune" enables the tile search — plans cached
    under one signature must not be served to another. The port has no
    interpret mode: ``interp0`` keeps the reference's key layout."""
    sig = (f"tiles{int(policy.mode == 'autotune')}"
           f"|d{policy.depth}|s{policy.streams}"
           f"|so{','.join(map(str, policy.stream_options))}"
           f"|interp0")
    return f"{sig}|{extra_key}" if extra_key else sig


_GENERATION = 0


def tuned_cache_clear() -> None:
    """Drop the in-memory tuned-plan caches (the disk *file* is untouched:
    the next lookup re-reads it, like a fresh process would)."""
    global _GENERATION
    _GENERATION += 1
    _MEM.clear()
    _MEM_ORIGIN.clear()
    _DISK.clear()
    _LAST.clear()


def snapshot_plans(path: Optional[str] = None) -> dict:
    """Every tuned-plan record this process can serve for its plan-cache
    path (the parsed disk cache overlaid with the in-memory front) as a
    JSON-serializable snapshot keyed by :data:`PLAN_FORMAT_VERSION`.

    The fault-tolerance supervisor embeds it in every checkpoint's
    ``extra``, so a restarted job, possibly on another host with a cold
    plan cache, pre-warms the autotune chain from the checkpoint and
    measures nothing again (:func:`restore_snapshot`)."""
    path = path or cache_path()
    plans: Dict[str, dict] = dict(load_plans(path))
    plans.update({k: rec for (p, k), rec in _MEM.items() if p == path})
    return {"format": PLAN_FORMAT_VERSION, "plans": plans}


def restore_snapshot(snapshot: Optional[Mapping[str, Any]],
                     path: Optional[str] = None) -> int:
    """Pre-warm the in-memory tuned-plan cache from a checkpoint's
    snapshot (:func:`snapshot_plans`). A snapshot of another plan format
    is ignored with a warning (its records could never be served, and the
    restarted job then measures again). Records never overwrite ones this
    process already holds. Returns the number of records installed."""
    if not snapshot:
        return 0
    if snapshot.get("format") != PLAN_FORMAT_VERSION:
        warnings.warn(
            f"ignoring checkpoint plan snapshot with format "
            f"{snapshot.get('format')!r} != {PLAN_FORMAT_VERSION}; tuned "
            f"plans will be re-measured", RuntimeWarning, stacklevel=2)
        return 0
    path = path or cache_path()
    installed = 0
    for key, rec in dict(snapshot.get("plans") or {}).items():
        if isinstance(rec, dict) and (path, key) not in _MEM:
            _MEM[(path, key)] = rec
            _MEM_ORIGIN[(path, key)] = "snapshot"
            installed += 1
    return installed


def _key_mesh_component(mesh: MeshSpec) -> str:
    return f"|mesh{mesh.token}|dev{mesh.device_count}|"


def invalidate_mesh(keep: MeshSpec, *, keep_single: bool = True) -> int:
    """Drop in-memory tuned-plan entries keyed by a mesh other than
    ``keep`` (the elastic-recovery hook, as
    ``planner.invalidate_mesh_plans``).

    Only the in-memory front is touched: the disk cache and the PlanDB are
    partitioned by mesh token inside every key, so entries for other
    topologies are never *served* to the surviving mesh; what goes is the
    warm state (``_MEM``/``_LAST``) a long-lived process accumulated under
    the lost topology. Returns the number of records dropped."""
    kept_components = {_key_mesh_component(keep)}
    kept_tokens = {keep.token}
    if keep_single:
        kept_components.add(_key_mesh_component(SINGLE_DEVICE))
        kept_tokens.add(SINGLE_DEVICE.token)
    stale = [mk for mk in _MEM
             if not any(c in mk[1] for c in kept_components)]
    for mk in stale:
        del _MEM[mk]
        _MEM_ORIGIN.pop(mk, None)
    for op in [op for op, rec in _LAST.items()
               if rec.get("mesh", SINGLE_DEVICE.token) not in kept_tokens]:
        del _LAST[op]
    return len(stale)


def last_record(op: str) -> Optional[dict]:
    """The most recent tuned-plan record resolved for ``op`` (bench report
    hook; includes the candidate table and the measured analytic config)."""
    return _LAST.get(op)


def load_plans(path: Optional[str] = None) -> Dict[str, dict]:
    """The on-disk plan cache, parsed once per path per process (cleared
    by :func:`tuned_cache_clear`). A corrupt or wrong-format file warns
    once and reads as empty (callers then fall back to the analytic plan
    or re-measure) — it is a cache, never a source of failure."""
    path = path or cache_path()
    if path in _DISK:
        return _DISK[path]
    _DISK[path] = plans = _read_plans_file(path)
    return plans


def _read_plans_file(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            payload = json.load(f)
        plans = payload["plans"]
        if payload.get("format") != PLAN_FORMAT_VERSION \
                or not isinstance(plans, dict):
            raise ValueError(f"plan format {payload.get('format')!r} != "
                             f"{PLAN_FORMAT_VERSION}")
        return plans
    except FileNotFoundError:
        return {}
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"ignoring corrupt plan cache {path} ({e}); tuned plans will "
            f"be re-measured or fall back to the analytic planner",
            RuntimeWarning, stacklevel=2)
        return {}


def store_plan(key: str, record: dict, path: Optional[str] = None) -> None:
    """Merge one record into the on-disk cache (atomic tmp+rename). The
    file is re-read before writing so records tuned by concurrent
    processes are merged, not clobbered."""
    path = path or cache_path()
    plans = _read_plans_file(path)
    plans[key] = record
    _DISK[path] = plans
    payload = {"format": PLAN_FORMAT_VERSION, "plans": plans}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError as e:    # read-only HOME etc.: keep the in-memory plan
        warnings.warn(f"could not persist plan cache to {path}: {e}",
                      RuntimeWarning, stacklevel=2)


def _as_tuples(obj):
    """JSON round-trip turns tuples into lists; restore tuples (tile
    options stay hashable)."""
    if isinstance(obj, list):
        return tuple(_as_tuples(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _as_tuples(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# Measurement harness
# ---------------------------------------------------------------------------


def _sync() -> None:
    """Wait for the card, where one is in use (never probes CUDA on a
    process that has not touched it)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable[[], Any], *, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds of ``fn()`` over ``iters`` timed runs.

    ``warmup`` untimed runs absorb the kernel's build and load; the card is
    synchronized before and after every run (the reference's
    ``jax.block_until_ready``), so an asynchronous launch cannot fake a
    zero-cost kernel.
    """
    for _ in range(max(warmup, 0)):
        fn()
    _sync()
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


class _Capturing(threading.local):
    def __init__(self):
        self.depth = 0


_capturing = _Capturing()


@contextlib.contextmanager
def capture_scope():
    """The scope of a compiled step's warm-up and capture: inside it no
    call site is measurable (:func:`in_capture`)."""
    _capturing.depth += 1
    try:
        yield
    finally:
        _capturing.depth -= 1


def in_capture() -> bool:
    """True inside :func:`capture_scope` — the port's counterpart of the
    reference's ``has_tracers``: there is nothing a candidate may launch
    or wait for, so a kernel passes ``runner=None``."""
    return _capturing.depth > 0


def wants_measured(policy) -> bool:
    """Does this policy resolve through the tuner?  mode="autotune", or
    depth/streams "measured" in a pipelined mode (the baseline strawman is
    depth=1 by definition — nothing to measure)."""
    if policy.mode == "autotune":
        return True
    return policy.mode not in ("baseline", "ref") and \
        "measured" in (policy.depth, policy.streams)


# ---------------------------------------------------------------------------
# Candidate generation (seeded and pruned by the analytic model)
# ---------------------------------------------------------------------------


def _candidate_depths(workload, hw, cap: Optional[int] = None
                      ) -> Tuple[int, ...]:
    """Depth candidates around the analytic latency-hiding point, up to
    the kernel's deepest ring ``cap``."""
    cap = _DEPTH_CAP if cap is None else cap
    service = workload.word_bytes / hw.stream_bandwidth(1, workload.regular)
    need = required_depth(hw.dma_latency_s, service, cap=cap)
    return tuple(sorted({min(d, cap)
                         for d in (2, 3, 4, need, min(2 * need, cap))}))


def _enumerate_candidates(policy, workload_fn, tile_options, dtype,
                          pinned_depth, pinned_streams, skipped,
                          depth_cap: Optional[int] = None):
    """All shared-memory-feasible (tile_kwargs, depth, streams) points with
    their model-predicted times. ``pinned_depth``/``pinned_streams`` fix
    that axis of the search (None = free); ``skipped`` collects rejection
    lines. With a kernel's ``depth_cap`` its own shared-memory model
    bounds the ring, and the generic budget check is skipped."""
    hw = policy.hw
    tiles = ({},)
    if policy.mode == "autotune":
        tiles += tuple(tk for tk in tile_options if tk)
    out = []
    for tk in tiles:
        try:
            w_t, plan_tile = workload_fn(_as_tuples(tk))
        except Exception as e:    # noqa: BLE001 — tile invalid at this shape
            skipped.append(f"tile {tk}: {type(e).__name__}: {e}")
            continue
        depths = (pinned_depth,) if pinned_depth else \
            _candidate_depths(w_t, hw, depth_cap)
        streams_opts = (pinned_streams,) if pinned_streams else \
            tuple(policy.stream_options)
        for d in depths:
            for s in streams_opts:
                if plan_tile[0] % s != 0:
                    skipped.append(f"tile {tk or 'default'} streams={s}: "
                                   f"tile[0]={plan_tile[0]} not divisible")
                    continue
                try:
                    pipe = Pipe(tile=tuple(plan_tile), dtype=dtype,
                                depth=d, streams=s)
                except ValueError as e:
                    skipped.append(f"tile {tk or 'default'} streams={s}: {e}")
                    continue
                if depth_cap is None and \
                        not smem_budget_ok([pipe], _SMEM_BUDGET_BYTES):
                    skipped.append(
                        f"tile {tk or 'default'} depth={d} streams={s}: "
                        f"ring smem {pipe.smem_bytes}B over budget")
                    continue
                est = estimate_feedforward(w_t, hw, pipe)
                out.append({"tile_kwargs": dict(tk), "depth": int(d),
                            "streams": int(s),
                            "predicted_s": float(est.total_s)})
    return out


def _dedupe(cands):
    seen, out = set(), []
    for c in cands:
        k = (json.dumps(c["tile_kwargs"], sort_keys=True, default=list),
             c["depth"], c["streams"])
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _analytic_choice(op, policy, *, workload, tile, dtype,
                     source: str, mesh: MeshSpec = SINGLE_DEVICE,
                     depth_cap: Optional[int] = None) -> TunedChoice:
    # resolve_auto treats "measured" as "auto" (the documented analytic
    # approximation), so the policy can be handed over unchanged.
    depth, streams = planner.resolve_policy(op, policy, workload=workload,
                                            tile=tile, dtype=dtype, mesh=mesh,
                                            depth_cap=depth_cap)
    return TunedChoice({}, depth, streams, source)


def _tune(op, policy, *, workload, tile, dtype, workload_fn, runner,
          tile_options, mesh: MeshSpec = SINGLE_DEVICE,
          depth_cap: Optional[int] = None) -> Optional[dict]:
    """Measure the pruned candidate set; return the tuned record or None
    if nothing could be measured."""
    cfg = current_tuning_config()
    t0 = time.monotonic()
    skipped: list = []

    # The analytic plan at the default tile: always candidate #0, so the
    # record carries a measured analytic reference and the argmin can only
    # improve on it. Resolved through resolve_policy so policy-pinned ints
    # constrain the reference exactly like they constrain the search.
    depth_a, streams_a = planner.resolve_policy(
        op, policy, workload=workload, tile=tuple(tile), dtype=dtype,
        mesh=mesh, depth_cap=depth_cap)
    est_a = estimate_feedforward(
        workload, policy.hw,
        Pipe(tile=tuple(tile), dtype=dtype, depth=depth_a,
             streams=streams_a))
    analytic = {"tile_kwargs": {}, "depth": depth_a, "streams": streams_a,
                "predicted_s": float(est_a.total_s)}

    # Which axes does this policy open to empirical search? Explicit ints
    # always pin. In mode="autotune" everything else is searched; in a
    # pipelined mode with depth/streams="measured", an "auto" field keeps
    # its documented meaning — planner-sized — and is pinned to the
    # analytic resolution rather than silently promoted to the search.
    def _pin(val, analytic_val):
        if isinstance(val, int):
            return val
        if val == "auto" and policy.mode != "autotune":
            return analytic_val
        return None
    cands = _enumerate_candidates(policy, workload_fn, tile_options, dtype,
                                  _pin(policy.depth, depth_a),
                                  _pin(policy.streams, streams_a), skipped,
                                  depth_cap)
    cands.sort(key=lambda c: c["predicted_s"])
    cands = _dedupe([analytic] + cands)[:max(cfg.top_k, 1)]

    measured = []
    for i, c in enumerate(cands):
        if i > 0 and cfg.budget_s is not None \
                and time.monotonic() - t0 >= cfg.budget_s:
            skipped.append(
                f"candidate depth={c['depth']} streams={c['streams']} "
                f"tile={c['tile_kwargs'] or 'default'}: tuning budget "
                f"{cfg.budget_s}s exhausted")
            c["measured_s"] = None
            continue
        try:
            fn = runner(_as_tuples(c["tile_kwargs"]), c["depth"],
                        c["streams"])
            c["measured_s"] = measure(fn, warmup=cfg.warmup,
                                      iters=cfg.iters)
            measured.append(c)
        except Exception as e:   # noqa: BLE001 — candidate infeasible at run
            c["measured_s"] = None
            skipped.append(
                f"candidate depth={c['depth']} streams={c['streams']} "
                f"tile={c['tile_kwargs'] or 'default'}: "
                f"{type(e).__name__}: {e}")
    if not measured:
        return None
    best = min(measured, key=lambda c: c["measured_s"])
    return {
        "format": PLAN_FORMAT_VERSION,
        "op": op,
        "hw": policy.hw.name,
        "dtype": dtype_name(dtype),
        "mesh": mesh.token,
        "devices": mesh.device_count,
        "workload": dataclasses.asdict(workload),
        "tile_kwargs": best["tile_kwargs"],
        "depth": best["depth"],
        "streams": best["streams"],
        "measured_s": best["measured_s"],
        "analytic": dict(cands[0]),     # == analytic config, now measured
        "candidates": cands,
        "skipped": skipped[:40],
        "measure": {"warmup": cfg.warmup, "iters": cfg.iters},
    }


def resolve_call(op: str, policy, *, workload, tile, dtype,
                 workload_fn: Optional[Callable] = None,
                 runner: Optional[Callable] = None,
                 tile_options: Sequence[Mapping[str, Any]] = (),
                 extra_key: str = "",
                 site: Optional[Mapping[str, Any]] = None,
                 site_dynamic: Sequence[str] = (),
                 depth_cap: Optional[int] = None,
                 ) -> TunedChoice:
    """Resolve one kernel call site's (tile, depth, streams) under
    ``policy`` — the measured superset of ``PipePolicy.resolve``.

    Args:
      op/workload/tile/dtype: the analytic planner inputs (default tile).
      workload_fn: ``f(tile_kwargs) -> (Workload, plan_tile)`` re-deriving
        the planner inputs for a tile candidate (``f({})`` must equal the
        defaults).
      runner: ``f(tile_kwargs, depth, streams) -> g`` where ``g()`` runs
        the real kernel once at the call-site operands under that
        configuration. ``None`` means the call site cannot be measured
        (inside a compiled step: :func:`in_capture`) — measured policies
        then fall back to the analytic plan with a warning.
      tile_options: the kernel's declared tile candidates
        (``KernelSpec.tile_options``), searched only in mode="autotune".
      extra_key: kernel statics that change the measured kernel but are
        not part of the Workload (e.g. chunk_scan's subtile, attention's
        kv length) — folded into the plan-cache key so a tuned plan is
        never served across call sites it was not measured for.
      site/site_dynamic: kernel shape kwargs (mirroring the kernel's
        workload-builder signature) for the traffic recorder
        (:mod:`repro_torch.core.profiling`) — ``site_dynamic`` names the
        keys the profile shape-buckets. Never part of the plan key.
      depth_cap: the kernel's deepest ring (its ``max_depth`` at these
        shapes): no plan or candidate goes deeper, and it replaces the
        generic shared-memory check of the planning tile (the reference's
        word, not the kernel's stage). ``None``: the reference's cap (17)
        and the budget check. The kernel narrows the
        policy's ``stream_options`` to the counts it can run before the
        call, so the recorded policy and the key carry them.

    Resolution order for measured policies: in-memory cache -> on-disk
    per-host plan cache -> release PlanDB (:func:`plan_db_path`) ->
    measure-and-persist -> analytic fallback. The cache key also carries
    the policy's search constraints (pinned depth/streams, stream_options,
    tile-search on/off).
    """
    mesh = resolve_mesh(getattr(policy, "mesh", None))
    profiling.emit_call(
        op=op, policy=policy, workload=workload, tile=tile,
        dtype=dtype_name(dtype), mesh=mesh, extra_key=extra_key,
        site=site, site_dynamic=site_dynamic)
    # resolve_call funnels into planner.resolve_policy internally — the
    # suppression scope keeps those inner calls out of the recorded profile
    with obs.span("resolve_call", op=op, mesh=mesh.token) as sp:
        with profiling.suppress_planner():
            choice = _resolve_call(
                op, policy, workload=workload, tile=tile, dtype=dtype,
                workload_fn=workload_fn, runner=runner,
                tile_options=tile_options, extra_key=extra_key, mesh=mesh,
                depth_cap=depth_cap)
        sp.set(source=choice.source, origin=choice.origin,
               depth=choice.depth, streams=choice.streams)
    _STATS[choice.source] += 1
    if choice.source == "memory" and choice.origin:
        _STATS[f"memory.{choice.origin}"] += 1
    # structural counter, always on: the obs registry is the unified
    # surface (metrics_snapshot) over the same counts plan_stats reports
    obs.counter("plan_resolutions_total",
                "plan resolutions by source (autotune lookup chain)",
                source=choice.source, origin=choice.origin).inc()
    return choice


def _resolve_call(op, policy, *, workload, tile, dtype, workload_fn,
                  runner, tile_options, extra_key, mesh,
                  depth_cap) -> TunedChoice:
    if not wants_measured(policy):
        depth, streams = planner.resolve_policy(
            op, policy, workload=workload, tile=tile, dtype=dtype, mesh=mesh,
            depth_cap=depth_cap)
        return TunedChoice({}, depth, streams, "analytic")

    key = plan_key(op, workload, dtype, policy.hw,
                   _policy_constraints(policy, extra_key), mesh=mesh)
    # the in-memory front is keyed per cache file, so redirecting the
    # plan cache (tuning_config / REPRO_TORCH_PLAN_CACHE) mid-process never
    # serves plans from the previously selected file
    path = cache_path()
    mem_key = (path, key)
    source = "memory"
    origin = ""
    record = _MEM.get(mem_key)
    if record is not None:
        origin = _MEM_ORIGIN.get(mem_key, "")
    if record is None:
        record = load_plans(path).get(key)
        source = "disk"
        if record is not None:
            _MEM[mem_key] = record
            _MEM_ORIGIN[mem_key] = "disk"
    if record is None:
        db = plan_db_path()
        if db is not None:
            from repro_torch.plans import plandb as _plandb   # lazy
            record = _plandb.lookup(key, path=db)
            source = "plandb"
            if record is not None:
                _MEM[mem_key] = record
                _MEM_ORIGIN[mem_key] = "plandb"
    if record is None:
        if runner is None or workload_fn is None:
            if (op, key) not in _warned_fallback_ops:
                _warned_fallback_ops.add((op, key))
                warnings.warn(
                    f"{op}: measured plan requested but the call site is "
                    f"not measurable (inside a compiled step's capture, or "
                    f"no runner); falling back to the analytic plan",
                    RuntimeWarning, stacklevel=3)
            return _analytic_choice(op, policy, workload=workload,
                                    tile=tile, dtype=dtype,
                                    source="analytic-fallback", mesh=mesh,
                                    depth_cap=depth_cap)
        record = _tune(op, policy, workload=workload, tile=tile,
                       dtype=dtype, workload_fn=workload_fn, runner=runner,
                       tile_options=tile_options, mesh=mesh,
                       depth_cap=depth_cap)
        if record is None:    # every candidate failed to run
            warnings.warn(
                f"{op}: no autotune candidate could be measured; using the "
                f"analytic plan", RuntimeWarning, stacklevel=3)
            return _analytic_choice(op, policy, workload=workload,
                                    tile=tile, dtype=dtype,
                                    source="analytic-fallback", mesh=mesh,
                                    depth_cap=depth_cap)
        source = "measured"
        _MEM[mem_key] = record
        _MEM_ORIGIN[mem_key] = "measured"
        store_plan(key, record, path)
    _LAST[op] = dict(record, source=source)
    # origin = which lookup layer first produced this record (every branch
    # above stamps _MEM_ORIGIN as it populates the memory front), so a
    # later memory hit stays distinguishable from the layer it shadowed
    return TunedChoice(_as_tuples(record["tile_kwargs"]),
                       int(record["depth"]), int(record["streams"]), source,
                       _MEM_ORIGIN.get(mem_key, origin))


def resolve_graph(graph_name: str, policy, *, workload, tile, dtype,
                  signature: str,
                  workload_fn: Optional[Callable] = None,
                  runner: Optional[Callable] = None,
                  tile_options: Sequence[Mapping[str, Any]] = (),
                  site: Optional[Mapping[str, Any]] = None,
                  site_dynamic: Sequence[str] = (),
                  depth_cap: Optional[int] = None,
                  ) -> TunedChoice:
    """Joint (depth, streams) resolution for one multi-kernel graph (the
    port's fused launches and launch chains: the paged decode, the decode
    layer, ``attention_proj``, the MoE dispatch).

    The whole graph is one call site: a candidate is one (depth, streams)
    applied to every launch of the graph. ``runner(tile_kwargs, depth,
    streams)`` runs the graph end to end at that configuration, so what is
    measured is the whole graph, not any node in isolation.
    ``depth_cap`` is the smallest of the nodes' deepest rings and the
    policy's ``stream_options`` the counts every node can run.

    ``workload`` summarizes the graph (:func:`graph_workload`);
    ``signature`` is the structural graph key (nodes, shapes) folded into
    the plan-cache key, so tuned graph plans are cached under the graph —
    never served across graphs that happen to share a workload summary —
    and reload from disk like kernel plans do.
    """
    return resolve_call(f"graph:{graph_name}", policy, workload=workload,
                        tile=tile, dtype=dtype, workload_fn=workload_fn,
                        runner=runner, tile_options=tile_options,
                        extra_key=f"sig={signature}",
                        site=site, site_dynamic=site_dynamic,
                        depth_cap=depth_cap)
