"""Elastic scaling: restore a checkpoint onto a different mesh, plan-aware
(the port of ``repro/runtime/elastic.py``).

A torch job resizes by relaunching with the surviving ranks: the new job
builds the largest mesh those ranks support (:func:`survivable_mesh`),
derives every leaf's placements from the same logical rules, and restores
the last checkpoint with them. Checkpoints hold whole host arrays and
placements are derived (not stored), so any mesh whose axes divide the
array dims works: scale down 2 pods -> 1, or up 1 -> 2.

The restore is **plan-aware**:

* the surviving topology is resolved to a
  :class:`~repro_torch.core.meshspec.MeshSpec` and every planner / autotune
  cache entry keyed by a mesh that no longer exists is dropped
  (``planner.invalidate_mesh_plans`` / ``autotune.invalidate_mesh``);
* the release PlanDB (``REPRO_TORCH_PLAN_DB`` / ``tuning_config(plan_db=)``),
  whose keys embed the mesh token, is pre-warmed so call sites under the
  new topology hit swept plans first;
* :func:`last_remesh` exposes a :class:`RemeshReport` (surviving mesh
  token, dropped-entry counts, PlanDB coverage).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.checkpoint import restore
from repro_torch.core import autotune, planner
from repro_torch.core.meshspec import MeshSpec
from repro_torch.runtime import sharding as shlib


@dataclasses.dataclass(frozen=True)
class RemeshReport:
    """What one :func:`remesh_restore` did to the plan stack."""

    mesh: MeshSpec
    step: int
    planner_dropped: int
    autotune_dropped: int
    plan_db: Optional[str] = None
    plan_db_records: int = 0     # swept records covering the new namespace


_LAST_REMESH: "list[RemeshReport]" = []


def last_remesh() -> Optional[RemeshReport]:
    """The most recent remesh's report."""
    return _LAST_REMESH[-1] if _LAST_REMESH else None


def remesh_restore(ckpt_dir: str, state_like: Any, axes_tree: Any, mesh, *,
                   step: Optional[int] = None, overrides=None,
                   invalidate_plans: bool = True,
                   plan_db: Optional[str] = None) -> Tuple[Any, int]:
    """Restore ``state_like`` onto the ``DeviceMesh`` ``mesh`` with the
    placements the logical ``axes_tree`` gives under the rules (updated by
    ``overrides``); every rank of the mesh calls it and keeps its shards.

    ``invalidate_plans`` (default on) drops planner/autotune entries keyed
    by any topology other than ``mesh`` (single-device plans survive: they
    are topology-independent) and pre-warms the PlanDB (``plan_db``, else
    the configured one) for the new topology.
    """
    spec = MeshSpec.from_mesh(mesh)
    with obs.span("remesh_restore", mesh=spec.token,
                  devices=spec.device_count) as sp:
        planner_dropped = autotune_dropped = 0
        db = plan_db if plan_db is not None else autotune.plan_db_path()
        db_records = 0
        if invalidate_plans:
            planner_dropped = planner.invalidate_mesh_plans(spec)
            autotune_dropped = autotune.invalidate_mesh(spec)
        if db:
            from repro_torch.plans import plandb as plandb_lib
            pre = plandb_lib.prewarm(db)
            db_records = int(pre["records_in_namespace"]
                             + pre["records_in_default"])
        with shlib.use_sharding(mesh, overrides=overrides) as ctx:
            shardings = shlib.tree_shardings(axes_tree, ctx)
            state, got_step, _ = restore(ckpt_dir, state_like, step=step,
                                         shardings=shardings)
        sp.set(step=got_step, planner_dropped=planner_dropped,
               autotune_dropped=autotune_dropped, plan_db_records=db_records)
    _LAST_REMESH[:] = [RemeshReport(
        mesh=spec, step=got_step, planner_dropped=planner_dropped,
        autotune_dropped=autotune_dropped, plan_db=db,
        plan_db_records=db_records)]
    obs.counter("remesh_total", "elastic remesh_restore calls").inc()
    obs.counter("remesh_plans_dropped_total",
                "stale plan entries dropped by remesh", layer="planner"
                ).inc(planner_dropped)
    obs.counter("remesh_plans_dropped_total",
                "stale plan entries dropped by remesh", layer="autotune"
                ).inc(autotune_dropped)
    return state, got_step


def survivable_shape(n: int, model_axis: int, pod_axis: int = 1
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the largest (pod, data, model) mesh ``n``
    surviving ranks support.

    Keeps the model axis intact (tensor-parallel groups must be complete)
    and shrinks data parallelism, the standard elastic-DP policy. ``n``
    must divide into ``pod_axis * model_axis`` groups (a partial TP group
    or a ragged pod cannot host the model): otherwise ``ValueError``,
    never a silently dropped rank.
    """
    if n % model_axis != 0:
        raise ValueError(
            f"{n} surviving devices cannot host model_axis={model_axis}")
    if n % (model_axis * pod_axis) != 0:
        raise ValueError(
            f"{n} surviving devices do not divide into pod_axis={pod_axis} "
            f"x model_axis={model_axis} groups")
    data = n // (model_axis * pod_axis)
    if data < 1:
        raise ValueError("not enough devices for one data shard")
    if pod_axis > 1:
        return (pod_axis, data, model_axis), ("pod", "data", "model")
    return (data, model_axis), ("data", "model")


def survivable_mesh(ranks: Sequence[int], model_axis: int,
                    pod_axis: int = 1, *, device_type: str = "cpu"):
    """The ``DeviceMesh`` of :func:`survivable_shape` over the surviving
    global ``ranks`` (in order; every rank of the default group calls
    it)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = survivable_shape(len(ranks), model_axis, pod_axis)
    n = 1
    for s in shape:
        n *= s
    grid = torch.tensor(list(ranks)[:n], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def replace_host(ckpt_dir: str, state_like: Any, axes_tree: Any,
                 surviving_ranks: Sequence[int], *, model_axis: int,
                 pod_axis: int = 1, step: Optional[int] = None,
                 overrides=None, plan_db: Optional[str] = None,
                 device_type: str = "cpu") -> Tuple[Any, int, Any]:
    """The straggler watchdog's "replace" action, end to end: build the
    largest mesh the surviving ranks support and plan-aware-restore the
    newest checkpoint onto it. Returns ``(state, step, mesh)``; the caller
    re-installs ``use_sharding(mesh)``."""
    mesh = survivable_mesh(surviving_ranks, model_axis, pod_axis=pod_axis,
                           device_type=device_type)
    state, got_step = remesh_restore(
        ckpt_dir, state_like, axes_tree, mesh, step=step,
        overrides=overrides, plan_db=plan_db)
    return state, got_step, mesh
