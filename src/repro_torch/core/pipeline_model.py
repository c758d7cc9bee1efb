"""Analytic cycle model of the feed-forward (DAE) pipeline (the port of
``repro/core/pipeline_model.py``: the same model, the same numbers, and an
H100 descriptor beside the reference's two).

The paper evaluates on an Arria-CX FPGA board with Intel's on-chip profiler.
The quantitative engine of the reproduction is an explicit analytic model
of a decoupled access/execute pipeline. It models, in seconds:

* the **baseline** ("single work-item") kernel, where loads are *entangled*
  with compute: the conservative compiler serializes the loop whenever it
  suspects a memory loop-carried dependency (false MLCD -> initiation
  interval II >> 1), and divergence/DLCDs stall the load units;
* the **feed-forward** kernel pair, where the producer streams words through
  a pipe of ``depth`` slots, so memory time and compute time *overlap* and
  the steady-state word time is max(t_mem, t_comp) instead of their sum;
* **multiple producers/consumers** (M2C2 etc.), which raise achievable
  memory-level parallelism until the memory system saturates — with a
  contention penalty for irregular access (the paper's Table 3 effect).

The model is deliberately simple, fully documented, and property-tested
(the reference's tests/test_pipeline_model.py; the port is held to the
reference's numbers exactly by tests/test_torch_planner.py): pipelining can never make a kernel slower
than the sum of its parts predicts, depth beyond the latency-hiding point
changes nothing (the paper's "depth does not significantly affect
performance"), and stream count saturates at the memory system's knee
(the paper's ">2x2 does not help").

Three hardware presets are provided:

* :data:`ARRIA_CX` — the paper's board (34.1 GB/s DDR4, ~300 MHz fabric);
* :data:`TPU_V5E` — the reference's target (its constants, as data: the
  port never runs on it);
* :data:`H100_SXM` — the port's card, the planner's default: the
  datasheet's memory rate, bf16 rate and clock, and five constants fitted
  from the card's own depth x streams sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.pipe import Pipe


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Memory/compute machine model for the DAE pipeline."""

    name: str
    clock_hz: float                   # fabric clock for II-denominated stalls
    hbm_bw: float                     # peak global-memory bandwidth, bytes/s
    stream_bw_frac: float             # fraction of peak one producer can pull
    dma_latency_s: float              # issue->first-byte latency of one copy
    flops: float                      # peak compute, FLOP/s
    irregular_eff: float              # bandwidth derate for irregular access
    contention_coeff: float           # per-extra-stream penalty (irregular)
    max_streams: int                  # memory-system saturation knee
    # rings that run side by side and share ``hbm_bw`` (an H100's SMs, one
    # ring a resident block); the reference's two machines run one. No
    # estimate reads it: the model sees the whole machine as one producer
    # stream, and ``dma_latency_s`` is that stream's time a word. A kernel
    # whose grid holds several blocks an SM uses it to keep its ring's
    # depth from pushing the grid into a second wave.
    sms: int = 1

    def stream_bandwidth(self, streams: int, regular: bool) -> float:
        """Aggregate achievable bandwidth for ``streams`` concurrent producers."""
        streams = min(streams, self.max_streams)
        eff = 1.0 if regular else self.irregular_eff
        per_stream = self.hbm_bw * self.stream_bw_frac * eff
        if not regular:
            # concurrent irregular streams fight for row buffers / channels
            per_stream = per_stream / (1.0 + self.contention_coeff * (streams - 1))
        return min(self.hbm_bw * eff, streams * per_stream)


# The paper's board: Intel PAC, Arria CX, 2x4GB DDR4 @ 34.1 GB/s.
ARRIA_CX = HardwareModel(
    name="arria-cx-pac",
    clock_hz=300e6,
    hbm_bw=34.1e9,
    stream_bw_frac=0.55,     # one in-order LSU stream cannot saturate DDR4
    dma_latency_s=300e-9,
    flops=1.5e12,
    irregular_eff=0.18,      # Wang et al. [17]: random access collapses DDR bw
    contention_coeff=0.85,
    max_streams=4,
)

# The reference's target, TPU v5e (its constants, kept as data).
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    clock_hz=940e6,
    hbm_bw=819e9,
    stream_bw_frac=0.55,     # one DMA queue's practical share of HBM
    dma_latency_s=2e-6,
    flops=197e12,
    irregular_eff=0.25,
    contention_coeff=0.6,
    max_streams=4,
)

# The port's card: NVIDIA H100 SXM5 80GB HBM3. hbm_bw, flops (dense bf16),
# clock_hz and sms are the datasheet's. The other five are fitted from the
# card's own depth x streams sweep of the row gather (the one irregular
# stream: table[2^20, 512] f32, idx[2^20], words of 8 rows) by
# ``chip_smoke.py`` ``fit_h100`` (its ``plans`` line, ``fit``), rounded to
# three figures, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (PERF.md names the run and shows the refits of later runs).
#
# In the model's terms the whole card is one producer stream. In the
# card's, each of the 132 SMs runs its own ring at 1/132 of the rate: one
# ring's word takes 132 x dma_latency_s (1.89 us at depth 1) and its
# service time 132 x the stream's. The planner's depth rule reads only
# the ratio of the two, so both readings plan the same depth. The regular
# ring kernels' sweeps (``chip_smoke.py`` ``regular_fits``) fit no single
# latency: the shallowest depth within 2% of each one's best puts it at
# most 4.9 ns for attention and decode attention, 9.8-19.6 ns for the
# products and 9.8-14.7 ns for the MLP tail (the gather's 14.3 inside);
# one stream's best is within 3% of the best in each, so stream_bw_frac
# 1.0 holds for regular streams too.
H100_SXM = HardwareModel(
    name="h100-sxm",
    clock_hz=1.98e9,
    hbm_bw=3.35e12,
    stream_bw_frac=1.0,        # streams=1 at the best depth is within 2% of
                               # the best: one stream pulls the whole rate
    dma_latency_s=14.3e-9,     # word time at depth 1, streams 1 (14.31 ns)
    flops=989e12,
    irregular_eff=0.869,       # best gather bytes / s over hbm_bw (0.8686)
    contention_coeff=0.682,    # depth 1: streams 2's word time against 1's
                               # (0.6825)
    max_streams=2,             # most streams whose best is within 2%
    sms=132,
)


@dataclasses.dataclass(frozen=True)
class Workload:
    """One kernel's stream program, in pipe words.

    Attributes:
      n_words: number of pipe words (tiles) the kernel processes.
      word_bytes: global-memory bytes loaded per word.
      flops_per_word: arithmetic work per word.
      regular: access pattern of the loads (paper: R vs IR).
      divergence: mean fractional control-flow bubble per word when control
        flow is *entangled* with the loads (baseline); in the FF design the
        bubble moves to the consumer and is smoothed across consumers.
      dlcd_cycles: length (cycles) of the data loop-carried dependency chain
        per word (reductions etc.). In the baseline this stalls the *loads*;
        in the FF design it bounds only the consumer.
      false_mlcd_ii: initiation interval (cycles) the conservative compiler
        assigns the baseline loop for a suspected-but-false memory LCD
        (paper: FW=285, BackProp=416). 0 = compiler proves independence.
      store_bytes_per_word: global stores per word (both designs keep stores).
    """

    n_words: int
    word_bytes: float
    flops_per_word: float
    regular: bool = True
    divergence: float = 0.0
    dlcd_cycles: float = 0.0
    false_mlcd_ii: float = 0.0
    store_bytes_per_word: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_word / max(self.word_bytes, 1e-30)


@dataclasses.dataclass(frozen=True)
class PipelineEstimate:
    """Model output for one design point."""

    total_s: float
    t_mem_word_s: float
    t_comp_word_s: float
    achieved_bw: float          # bytes/s pulled from global memory
    bottleneck: str             # "memory" | "compute" | "latency" | "ii"
    smem_bytes: int

    @property
    def achieved_bw_mb_s(self) -> float:
        return self.achieved_bw / 1e6


def _word_mem_bytes(w: Workload) -> float:
    return w.word_bytes + w.store_bytes_per_word


_BURST_LSU_OUTSTANDING = 16   # burst-coalesced LSU request buffer depth


def estimate_baseline(w: Workload, hw: HardwareModel) -> PipelineEstimate:
    """Single work-item kernel: loads entangled with compute.

    A *well-pipelined* baseline loop (no LCD) still achieves II=1 with the
    burst-coalesced LSU hiding latency over its request buffer — that is why
    the paper's saturated kernels (PageRank, Hotspot) see ~1x from FF. What
    the baseline cannot escape: the compiler-assigned II from (suspected)
    MLCDs / DLCD chains serializes the *whole* loop, and divergence bubbles
    stall the load units (control flow entangled with addresses).
    """
    bw = hw.stream_bandwidth(1, w.regular)
    t_transfer = _word_mem_bytes(w) / bw
    t_compute = max(w.flops_per_word / hw.flops,
                    w.dlcd_cycles / hw.clock_hz)
    t_lat = (0.0 if w.regular
             else hw.dma_latency_s / _BURST_LSU_OUTSTANDING)
    # divergence inflates everything entangled with the loads — including
    # the DLCD chain; the false-MLCD II is a fixed compiler schedule
    serial = max(t_lat, t_transfer, t_compute, 1.0 / hw.clock_hz) \
        * (1.0 + w.divergence)

    t_ii = w.false_mlcd_ii / hw.clock_hz
    t_word = max(serial, t_ii)
    bottleneck = "ii" if t_ii >= serial and w.false_mlcd_ii > 0 else (
        "memory" if t_transfer >= t_compute else "compute")
    total = w.n_words * t_word
    return PipelineEstimate(
        total_s=total,
        t_mem_word_s=t_transfer,
        t_comp_word_s=t_compute,
        achieved_bw=w.n_words * _word_mem_bytes(w) / total,
        bottleneck=bottleneck,
        smem_bytes=0,
    )


def estimate_feedforward(
    w: Workload,
    hw: HardwareModel,
    pipe: Pipe,
    consumers: Optional[int] = None,
) -> PipelineEstimate:
    """Feed-forward kernel pair connected by ``pipe``.

    Steady state: producer and consumer overlap; the word time is the max of
    the two stages. The producer is free of DLCD/divergence (paper's whole
    point); the false MLCD vanishes because the split *proves* independence.

    Latency exposure: a *regular* stream is serviced by a prefetching LSU /
    streaming DMA — issue latency amortizes over the stream and only the
    pipeline fill pays it. An *irregular* stream pays latency per word,
    hidden by (depth-1) x streams outstanding transactions, but concurrent
    irregular streams also contend for the memory system's transaction
    resources (the paper's Table-3 effect). The pipelined loop itself can
    retire at most one word per clock (II=1 floor).
    """
    producers = pipe.streams
    consumers = producers if consumers is None else consumers

    bw = hw.stream_bandwidth(producers, w.regular)
    t_transfer = _word_mem_bytes(w) / bw
    if w.regular:
        t_latency_exposed = 0.0
    else:
        outstanding = max(pipe.depth - 1, 1) * producers
        lat = hw.dma_latency_s * (1.0 + hw.contention_coeff * (producers - 1))
        t_latency_exposed = lat / outstanding
    t_mem = max(t_transfer, t_latency_exposed)

    t_flops = w.flops_per_word / hw.flops
    t_dlcd = w.dlcd_cycles / hw.clock_hz
    # divergence bubbles smooth across consumers (static parity balancing)
    t_comp = (max(t_flops, t_dlcd) * (1.0 + w.divergence / consumers)) / consumers \
        if consumers > 1 else max(t_flops, t_dlcd) * (1.0 + w.divergence)

    t_word = max(t_mem, t_comp, 1.0 / hw.clock_hz)   # II=1 retirement floor
    fill = hw.dma_latency_s + pipe.depth * t_mem          # pipeline warmup
    total = fill + w.n_words * t_word
    if t_word == t_mem and t_mem == t_latency_exposed and t_latency_exposed > t_transfer:
        bottleneck = "latency"
    else:
        bottleneck = "memory" if t_mem >= t_comp else "compute"
    return PipelineEstimate(
        total_s=total,
        t_mem_word_s=t_mem,
        t_comp_word_s=t_comp,
        achieved_bw=w.n_words * _word_mem_bytes(w) / total,
        bottleneck=bottleneck,
        smem_bytes=pipe.smem_bytes,
    )


def speedup(w: Workload, hw: HardwareModel, pipe: Pipe,
            consumers: Optional[int] = None) -> float:
    """FF speedup over the single work-item baseline (paper Table 2 metric)."""
    base = estimate_baseline(w, hw)
    ff = estimate_feedforward(w, hw, pipe, consumers)
    return base.total_s / ff.total_s


# ---------------------------------------------------------------------------
# Multi-kernel graphs (MKPipe-style stage overlap)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphStage:
    """One node of a multi-kernel graph (in the port: one launch of a fused
    or staged graph), as the model sees it.

    ``fused_with_prev`` marks the in-edge from the previous stage as fused:
    the previous stage's output never stores to HBM
    (``saved_store_bytes``) and this stage's reloads of it are served from
    the on-chip ring (``saved_load_bytes``); the two stages overlap
    MKPipe-style instead of running back to back. ``rationale`` carries the
    fuser's per-edge decision line (fused: why legal; staged: why rejected)
    so bench reports can surface it without recompiling.
    """

    name: str
    workload: Workload
    pipe: Pipe
    fused_with_prev: bool = False
    saved_load_bytes: float = 0.0
    saved_store_bytes: float = 0.0
    rationale: str = ""


@dataclasses.dataclass(frozen=True)
class EdgeEstimate:
    """Model output for one graph edge."""

    edge: str                   # "producer->consumer"
    mode: str                   # "fused" | "staged"
    hbm_bytes_saved: float
    rationale: str


@dataclasses.dataclass(frozen=True)
class GraphEstimate:
    """Model output for one compiled multi-kernel graph.

    ``total_s`` models the chosen lowering (fused segments overlap, staged
    boundaries serialize); ``unfused_s`` is every stage alone with full HBM
    traffic — the two-calls baseline the paper's memory-controller-wall
    argument is made against. ``skipped`` mirrors ``Plan.skipped``: one
    line per staged edge explaining *why* it did not fuse, so fusion
    rejections are observable without rerunning.
    """

    total_s: float
    unfused_s: float
    per_stage: Tuple[Tuple[str, PipelineEstimate], ...]
    edges: Tuple[EdgeEstimate, ...]
    hbm_bytes_saved: float
    skipped: Tuple[str, ...]

    @property
    def overlap_speedup(self) -> float:
        return self.unfused_s / max(self.total_s, 1e-30)


def _adjusted(w: Workload, saved_load: float, saved_store: float) -> Workload:
    """Remove fused-edge HBM traffic from one stage's workload (the bytes
    now travel through on-chip rings instead of the memory controller)."""
    per_word_load = saved_load / max(w.n_words, 1)
    per_word_store = saved_store / max(w.n_words, 1)
    return dataclasses.replace(
        w,
        word_bytes=max(w.word_bytes - per_word_load, 0.0),
        store_bytes_per_word=max(w.store_bytes_per_word - per_word_store, 0.0),
    )


def estimate_graph(stages: Tuple[GraphStage, ...],
                   hw: HardwareModel, *,
                   extra_edges: Tuple[EdgeEstimate, ...] = ()
                   ) -> GraphEstimate:
    """Estimate a multi-kernel pipe graph (MKPipe, arXiv 2002.01614).

    Stages are given in topological (execution) order. Consecutive stages
    joined by a fused edge form a *segment*: their workloads shed the
    intermediate's HBM traffic and the segment's time is the max of its
    members plus one fill (producer and consumer overlap, like the paper's
    producer/consumer kernels overlap within one kernel). Staged edges
    serialize: the intermediate round-trips HBM and segment times add up —
    exactly the memory-controller round trip the fused lowering removes.

    ``extra_edges`` carries graph edges that do not join *consecutive*
    stages — a ring-served residual feeding a later chain member, or a
    multi-consumer skip edge. They are appended to ``edges`` verbatim,
    their savings count toward ``hbm_bytes_saved``, and staged ones with a
    rationale surface in ``skipped`` — so every edge of a whole-layer
    graph stays observable even when the stage sequence cannot express it.
    """
    if not stages:
        raise ValueError("estimate_graph needs at least one stage")

    # per-stage workloads with fused-edge traffic removed
    adj: list = [s.workload for s in stages]
    for i, s in enumerate(stages):
        if not s.fused_with_prev:
            continue
        adj[i - 1] = _adjusted(adj[i - 1], 0.0, s.saved_store_bytes)
        adj[i] = _adjusted(adj[i], s.saved_load_bytes, 0.0)

    per_stage = []
    edges = []
    skipped = []
    saved_total = 0.0
    total = 0.0
    unfused = 0.0
    seg_max = 0.0
    for i, s in enumerate(stages):
        est = estimate_feedforward(adj[i], hw, s.pipe)
        per_stage.append((s.name, est))
        unfused += estimate_feedforward(s.workload, hw, s.pipe).total_s
        if i > 0:
            prev = stages[i - 1]
            saved = (s.saved_load_bytes + s.saved_store_bytes) \
                if s.fused_with_prev else 0.0
            saved_total += saved
            edges.append(EdgeEstimate(
                edge=f"{prev.name}->{s.name}",
                mode="fused" if s.fused_with_prev else "staged",
                hbm_bytes_saved=saved,
                rationale=s.rationale,
            ))
            if not s.fused_with_prev and s.rationale:
                skipped.append(f"{prev.name}->{s.name}: {s.rationale}")
        if s.fused_with_prev:
            # overlap with the running segment: the segment retires at the
            # pace of its slowest member
            seg_max = max(seg_max, est.total_s)
        else:
            total += seg_max
            seg_max = est.total_s
    total += seg_max
    for e in extra_edges:
        edges.append(e)
        if e.mode == "fused":
            saved_total += e.hbm_bytes_saved
        elif e.rationale:
            skipped.append(f"{e.edge}: {e.rationale}")
    return GraphEstimate(
        total_s=total,
        unfused_s=unfused,
        per_stage=tuple(per_stage),
        edges=tuple(edges),
        hbm_bytes_saved=saved_total,
        skipped=tuple(skipped),
    )
