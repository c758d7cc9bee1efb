"""Offline sweep: tune a PlanDB from a recorded TrafficProfile (the port of
``repro/plans/sweep.py``).

Replaces fixed-benchmark-shape tuning with traffic-driven tuning: buckets
are ranked by **observed frequency x modeled cost** (count times the
roofline seconds of the bucket's heaviest workload — the buckets that
dominate real wall time tune first) and measured until the time budget
runs out. For each bucket the sweep

1. rebuilds the *serving* policy (``mode="autotune"`` with the recorded
   stream_options/pins, the recorded hardware model, and the
   recorded mesh topology — so the computed keys match what serving
   lookups will ask for);
2. synthesizes concrete operands at the bucketed shape via the kernel's
   ``KernelSpec.sweep_inputs`` builder, on the card (``device="cuda"``,
   the default) or the CPU, and runs the op once under a scratch plan
   cache, which drives the real measured autotuner (on the CPU it times
   the plain versions);
3. writes the tuned record into the PlanDB under **every exact plan key**
   observed in the bucket — serving lookups stay exact-match, bucketing
   only decides where the measurement happens.

Planner-origin records carry no shape dict and are skipped with a logged
reason — the sweep never silently drops coverage.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import autotune
from repro_torch.core.meshspec import MeshSpec
from repro_torch.core.pipeline_model import ARRIA_CX, H100_SXM, TPU_V5E, \
    HardwareModel, Workload
from repro_torch.plans.plandb import PlanDB
from repro_torch.plans.profile import ProfileEntry, TrafficProfile
from repro_torch.plans.registry import plan_namespace

# recorded hw name -> analytic model (plan keys embed hw.name, so the
# sweep must rebuild the exact model the traffic planned against)
HW_BY_NAME: Dict[str, HardwareModel] = {
    H100_SXM.name: H100_SXM,
    TPU_V5E.name: TPU_V5E,
    ARRIA_CX.name: ARRIA_CX,
}


def modeled_cost_s(entry: ProfileEntry) -> float:
    """Roofline seconds of the bucket's heaviest observed workload — the
    cost half of the frequency x cost priority. A deliberately simple
    max(bytes/bw, flops/peak) bound: ranking needs ordering, not
    accuracy."""
    hw = HW_BY_NAME.get(entry.hw)
    worst = 0.0
    for var in entry.variants.values():
        w = var["workload"]
        loaded = float(w["n_words"]) * float(w["word_bytes"])
        flops = float(w["n_words"]) * float(w["flops_per_word"])
        if hw is None:
            worst = max(worst, loaded)     # bytes as a unitless proxy
        else:
            worst = max(worst, loaded / hw.hbm_bw, flops / hw.flops)
    return worst


def entry_priority(entry: ProfileEntry) -> float:
    return entry.count * modeled_cost_s(entry)


def _rebuild_policy(entry: ProfileEntry):
    """The serving-equivalent search policy for one bucket. mode is forced
    to "autotune" (profiles recorded under mode="ff" are swept for the
    measured path); everything that shapes the plan key — pins,
    stream_options, hw, mesh — comes from the recording."""
    from repro_torch.core.program import PipePolicy

    hw = HW_BY_NAME.get(entry.hw)
    if hw is None:
        raise KeyError(f"unknown hardware model {entry.hw!r} "
                       f"(register it in repro_torch.plans.sweep."
                       f"HW_BY_NAME)")
    pol = entry.policy
    mesh = MeshSpec(axes=tuple(entry.mesh_axes)) if entry.mesh_axes else None
    return PipePolicy(
        mode="autotune",
        depth=pol["depth"] if isinstance(pol["depth"], int) else "auto",
        streams=pol["streams"] if isinstance(pol["streams"], int) else "auto",
        stream_options=tuple(int(s) for s in pol["stream_options"]),
        hw=hw, mesh=mesh)


@dataclasses.dataclass
class SweepResult:
    db: PlanDB
    namespace: str
    tuned_buckets: int = 0
    keys_written: int = 0
    skipped: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    def to_payload(self) -> dict:
        return {"namespace": self.namespace,
                "tuned_buckets": self.tuned_buckets,
                "keys_written": self.keys_written,
                "skipped": self.skipped, "wall_s": self.wall_s,
                "db": self.db.stats()}


def sweep_profile(profile: TrafficProfile, *,
                  db: Optional[PlanDB] = None,
                  namespace: Optional[str] = None,
                  budget_s: Optional[float] = None,
                  scratch_cache: Optional[str] = None,
                  warmup: int = 1, iters: int = 2,
                  top_k: Optional[int] = None,
                  seed: int = 0,
                  device: str = "cuda",
                  log=print) -> SweepResult:
    """Tune every sweepable bucket of ``profile`` (priority order) into
    ``db`` under ``budget_s`` total wall seconds.

    ``scratch_cache`` is the throwaway per-host plan-cache path the
    measured autotuner persists through during the sweep (default: a
    path derived from the namespace under /tmp is *not* chosen for you —
    pass one; tests and the CLI use a tempdir). ``top_k`` caps the
    measured candidates per bucket (None keeps the tuner default; 2 =
    analytic reference + best predicted, the cheap smoke setting).
    ``device`` is where the operands are made and the kernels timed:
    ``"cuda"`` (raises without a card) or ``"cpu"``. Returns a
    :class:`SweepResult`; ``result.db`` holds the merged records.
    """
    from repro_torch.kernels import registry as kernel_registry

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("plans sweep: no CUDA device (pass --device cpu "
                           "to time the plain versions)")

    ns = namespace or plan_namespace()
    result = SweepResult(db=db if db is not None else PlanDB(),
                         namespace=ns)
    t0 = time.monotonic()

    order = sorted(
        profile.entries.items(),
        key=lambda kv: (-entry_priority(kv[1]), kv[0]))

    for i, (bkey, entry) in enumerate(order):
        spent = time.monotonic() - t0
        if budget_s is not None and spent >= budget_s:
            result.skipped.append(
                f"{entry.op}: sweep budget {budget_s}s exhausted "
                f"({len(order) - result.tuned_buckets - len(result.skipped)}"
                f" buckets left)")
            break
        # fair-share the remaining budget across the remaining buckets so
        # a deep search on one bucket can't starve the tail out of their
        # (always-measured) analytic-reference candidate
        budget_left = None if budget_s is None else \
            (budget_s - spent) / (len(order) - i)
        reason = _sweep_bucket(
            entry, result, kernel_registry,
            budget_left=budget_left,
            scratch_cache=scratch_cache, warmup=warmup, iters=iters,
            top_k=top_k, seed=seed, device=dev)
        if reason is None:
            result.tuned_buckets += 1
            log(f"# sweep: tuned {entry.op} bucket "
                f"(count={entry.count}, variants={len(entry.variants)})")
        else:
            result.skipped.append(f"{entry.op}: {reason}")
    result.wall_s = time.monotonic() - t0
    return result


def _sweep_bucket(entry: ProfileEntry, result: SweepResult, kernel_registry,
                  *, budget_left: Optional[float], scratch_cache,
                  warmup: int, iters: int, top_k: Optional[int],
                  seed: int, device: torch.device) -> Optional[str]:
    """Tune one bucket; returns None on success or a skip reason."""
    if entry.op.startswith("graph:"):
        try:
            gspec = kernel_registry.get_graph(entry.op[len("graph:"):])
        except KeyError:
            return "not a registered graph"
        if gspec.op is None or gspec.sweep_inputs is None:
            return "graph declares no sweep entrypoint/inputs builder"
        op_fn, sweep_inputs = gspec.op, gspec.sweep_inputs
    else:
        try:
            spec = kernel_registry.get_kernel(entry.op)
        except KeyError:
            return "not a registry kernel (legacy planner call site)"
        if spec.sweep_inputs is None:
            return "kernel declares no sweep_inputs builder"
        op_fn, sweep_inputs = spec.op, spec.sweep_inputs
    if entry.site is None:
        return "no recorded shape dict (planner-origin record)"

    try:
        policy = _rebuild_policy(entry)
    except KeyError as e:
        return str(e)

    # builders see the recorded operand dtype alongside the shape dict
    site = dict(entry.site, dtype=entry.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    try:
        args, kw = sweep_inputs(gen, site, device)
    except Exception as e:   # noqa: BLE001 — report, don't abort the sweep
        return f"sweep_inputs failed at {entry.site}: " \
               f"{type(e).__name__}: {e}"

    cfg: Dict[str, Any] = {"warmup": warmup, "iters": iters,
                           "budget_s": budget_left}
    if top_k is not None:
        cfg["top_k"] = top_k
    if scratch_cache:
        cfg["cache_path"] = scratch_cache
    try:
        with autotune.tuning_config(**cfg):
            op_fn(*args, **kw, policy=policy)
            autotune._sync()
    except Exception as e:   # noqa: BLE001
        return f"measurement failed: {type(e).__name__}: {e}"

    record = autotune.last_record(entry.op)
    if record is None:
        return "tuner produced no record (analytic fallback at the bucket)"

    # one DB record per *exact* observed key: serving lookups are
    # exact-match, the bucket only chose the measurement point
    mesh = MeshSpec(axes=tuple(entry.mesh_axes))
    constraints = autotune._policy_constraints(policy, entry.extra_key)
    tuned_at = time.time()
    for var in entry.variants.values():
        w = Workload(**var["workload"])
        key = autotune.plan_key(entry.op, w, entry.dtype, policy.hw,
                                constraints, mesh=mesh)
        result.db.put(result.namespace, key, record, tuned_at=tuned_at)
        result.keys_written += 1
    return None
