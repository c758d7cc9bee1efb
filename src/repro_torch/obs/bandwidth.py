"""Bandwidth-utilization accounting: modeled bytes ÷ measured seconds.

The paper's claim is about achieved memory bandwidth — pipes win because
the access kernel streams at a rate the fused baseline cannot sustain —
and the claim is only falsifiable if achieved GB/s and its fraction of
the roofline are *measured*, per kernel and per graph edge (Memory
Controller Wall / MKPipe, PAPERS.md). This module makes the join:

* modeled bytes come from the same :class:`~repro_torch.core.pipeline_model`
  objects the planner used (``Workload`` for a single kernel,
  ``GraphEstimate.per_stage`` for graphs — each stage's estimate encodes
  ``bytes = achieved_bw * total_s`` exactly, so post-fusion traffic with
  fused-edge savings already applied is recoverable without recompiling);
* measured seconds come from the caller (``autotune.measure`` wall time,
  synchronized on the card);
* utilization is ``achieved / hw.hbm_bw``, reported clamped to 1.0 with
  the raw ratio kept — CPU runs of the plain versions land far below 1,
  the card should not exceed it, and a ratio > 1 flags a broken byte
  model rather than crashing the report.

Graph wall time is one number per compiled graph; stages get it
attributed proportionally to their modeled ``total_s`` share, and each
edge combines its producer+consumer stages (a stage shared by several
edges — a multi-consumer producer — is split evenly across them so edge
rows stay summable). ``hbm_bytes_saved`` per edge
is carried through so fused edges show the traffic they *removed* next
to the bandwidth they achieved.
"""

from __future__ import annotations

from typing import Dict, List

_EPS = 1e-30


def _utilization(achieved: float, roofline: float) -> Dict[str, float]:
    raw = achieved / max(roofline, _EPS)
    return {
        "achieved_gb_s": achieved / 1e9,
        "roofline_gb_s": roofline / 1e9,
        "utilization": min(raw, 1.0),
        "utilization_raw": raw,
    }


def kernel_utilization(workload, hw, measured_s: float) -> Dict[str, float]:
    """Achieved GB/s and roofline fraction for one kernel invocation.

    ``workload`` is the :class:`~repro_torch.core.pipeline_model.Workload` the
    kernel planned with, ``hw`` the :class:`HardwareModel` roofline, and
    ``measured_s`` the measured wall seconds for one call.
    """
    bytes_moved = workload.n_words * (
        workload.word_bytes + workload.store_bytes_per_word)
    out = {"hbm_bytes": bytes_moved, "measured_s": measured_s}
    out.update(_utilization(bytes_moved / max(measured_s, _EPS), hw.hbm_bw))
    return out


def graph_utilization(estimate, hw, measured_s: float) -> Dict[str, object]:
    """Per-stage and per-edge achieved bandwidth for one compiled graph.

    ``estimate`` is the compiled graph's
    :class:`~repro_torch.core.pipeline_model.GraphEstimate` (from
    ``estimate_graph``); ``measured_s`` is the measured wall seconds for one
    end-to-end run. Stage bytes are recovered from each stage's modeled
    ``achieved_bw * total_s`` (post-fusion traffic); the measured wall is
    attributed to stages by modeled-time share.
    """
    stage_bytes: Dict[str, float] = {}
    stage_model_s: Dict[str, float] = {}
    for name, est in estimate.per_stage:
        stage_bytes[name] = est.achieved_bw * est.total_s
        stage_model_s[name] = est.total_s
    model_total = sum(stage_model_s.values()) or _EPS

    stages: Dict[str, Dict[str, float]] = {}
    for name in stage_bytes:
        attributed_s = measured_s * stage_model_s[name] / model_total
        d = {"hbm_bytes": stage_bytes[name], "attributed_s": attributed_s}
        d.update(_utilization(
            stage_bytes[name] / max(attributed_s, _EPS), hw.hbm_bw))
        stages[name] = d

    # A stage may sit on several edges (multi-consumer producers like the
    # decode layer's oproj feeding both gateup and the down residual, or a
    # consumer with two planned inputs). Splitting each stage's bytes/wall
    # evenly across its edge memberships keeps the edge rows summable: the
    # shared stage is counted once across the graph, not once per edge.
    membership: Dict[str, int] = {}
    edge_names: List[List[str]] = []
    for e in estimate.edges:
        producer, _, consumer = e.edge.partition("->")
        names = [n for n in (producer, consumer) if n in stage_bytes]
        edge_names.append(names)
        for n in names:
            membership[n] = membership.get(n, 0) + 1

    edges: List[Dict[str, object]] = []
    for e, names in zip(estimate.edges, edge_names):
        e_bytes = sum(stage_bytes[n] / membership[n] for n in names)
        e_attr = sum(stages[n]["attributed_s"] / membership[n] for n in names)
        d: Dict[str, object] = {
            "edge": e.edge,
            "mode": e.mode,
            "hbm_bytes": e_bytes,
            "hbm_bytes_saved": e.hbm_bytes_saved,
            "attributed_s": e_attr,
            "rationale": e.rationale,
        }
        d.update(_utilization(e_bytes / max(e_attr, _EPS), hw.hbm_bw))
        edges.append(d)

    total_bytes = sum(stage_bytes.values())
    graph = {"hbm_bytes": total_bytes, "measured_s": measured_s,
             "modeled_s": estimate.total_s,
             "hbm_bytes_saved": estimate.hbm_bytes_saved}
    graph.update(_utilization(
        total_bytes / max(measured_s, _EPS), hw.hbm_bw))
    return {"graph": graph, "stages": stages, "edges": edges}
