"""StreamGraph: multi-kernel pipe graphs, lowered fused or staged onto the
port's hand-written kernels (the host half of ``repro/core/graph.py``).

A :class:`StreamGraph` composes :class:`~repro_torch.core.program.
StreamProgram` declarations into a DAG whose inter-kernel edges are
:class:`GraphEdge` s ("node ``dst`` streams node ``src``'s output through
its ``dst_input``"). :func:`compile_graph` chooses per edge between

* **fused**: the edge's intermediate never leaves the chip. Legality is
  the reference's, on Python ints (:func:`check_fusion`): the producer's
  output block schedule must be the consumer's stream schedule, through
  row-major element offsets across an ``edge.reshape``; a gather never
  fuses. Fused edges compose into linear chains, a fused-away producer may
  feed a later chain member straight from the chain's intermediate ring
  (:func:`_check_ring_serve`). The reference then emits one Pallas kernel
  for the chain; the port has no generic emitter, so a legal chain runs
  the hand-fused kernel that computes it (:data:`FUSED_KERNELS`):

  - gather -> matmul: ``ff_matmul``'s dispatch path (``dispatch_matmul``);
  - attention -> projection: ``ff_attention_proj``;
  - gather -> paged decode attention: the paged ``ring_decode_kernel``;
  - the decode layer's out-projection -> SwiGLU -> down-projection with
    the residual served in-chain: ``ff_layer_mlp_tail``.

  A chain the legality analysis would fuse but for which the port has no
  kernel stages, and its rationale names the missing kernel; so does one
  whose kernel's shared memory does not fit the chain's share of the
  budget (``planner.split_graph_budget``). With ``prefer="fused"`` either
  raises :class:`~repro_torch.core.planner.PlanError`, as an infeasible
  fusion does.
* **staged**: the producer's output is written to device memory and the
  consumer launches its own kernel on it (the node's ``program.kernel``,
  through :func:`~repro_torch.core.program.compile_program`).

Every edge's decision carries a rationale (:class:`EdgePlan`) and the
bytes it keeps off device memory; :func:`~repro_torch.core.
pipeline_model.estimate_graph` models the plan. An :class:`Epilogue` names
what a hand-fused kernel does at its output write (the residual add, the
q bias and RoPE); the RMSNorm rides the programs' ``norm`` prologue.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch

from repro_torch import obs
from repro_torch.core import planner
from repro_torch.core.meshspec import SINGLE_DEVICE, MeshSpec, \
    localize_workload, resolve_sharding
from repro_torch.core.pipe import DEFAULT_SMEM_BUDGET_BYTES, Pipe, \
    dtype_name, itemsize
from repro_torch.core.pipeline_model import EdgeEstimate, GraphStage, \
    Workload, estimate_graph
from repro_torch.core.planner import PlanError
from repro_torch.core.program import BlockIn, ScalarIn, \
    ScheduleOpaqueError, StreamProgram, _clamped_streams, _OpaqueScalar, \
    compile_program, program_workload

_SMEM_BUDGET_BYTES = DEFAULT_SMEM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# The graph IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What a node's kernel does at its output write, by name.

    ``name`` is one of the epilogues the port's kernels implement
    (:data:`repro_torch.core.program.EPILOGUES`): ``"residual"`` (``out +=
    inputs[0]`` in the output type) or ``"rope_bias"`` (the q bias
    ``inputs[0]`` added in f32, then RoPE by the positions ``inputs[1]``
    with ``params`` ``rope_theta`` and ``head_dim``). The reference's
    epilogue is a Pallas body; the port names one that a hand-written
    kernel implements, and a node whose kernel lacks it is refused when it
    compiles. ``inputs`` are extra BlockIn operands, appended to the
    program's inputs; a graph edge may feed them.
    """

    name: str
    inputs: Tuple[BlockIn, ...] = ()
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def _with_epilogue(program: StreamProgram,
                   ep: Optional[Epilogue]) -> StreamProgram:
    """The node's effective program: epilogue inputs appended, the
    epilogue named in the launch's keywords."""
    if ep is None:
        return program
    return dataclasses.replace(
        program, name=f"{program.name}+ep",
        inputs=tuple(program.inputs) + tuple(ep.inputs),
        kernel_kwargs={**program.kernel_kwargs, "epilogue": ep.name,
                       "epilogue_inputs": tuple(i.name for i in ep.inputs),
                       **ep.params})


@dataclasses.dataclass(frozen=True)
class GraphNode:
    """One kernel of the multi-kernel program.

    ``workload`` (optional) is the node's analytic Workload (the port's
    kernels' own words; omitted, it is synthesized from the program's
    streams); ``plan_tile`` the tile the planner sizes against (default:
    the first stream's); ``epilogue`` what the kernel does at its output
    write."""

    name: str
    program: StreamProgram
    workload: Optional[Workload] = None
    plan_tile: Optional[Tuple[int, ...]] = None
    epilogue: Optional[Epilogue] = None

    @property
    def effective_program(self) -> StreamProgram:
        return _with_epilogue(self.program, self.epilogue)


@dataclasses.dataclass(frozen=True)
class GraphEdge:
    """``dst`` reads ``src``'s output through its input ``dst_input``.

    ``prefer``: "auto" fuses when legal and a kernel fits, "fused" demands
    it (:class:`~repro_torch.core.planner.PlanError` otherwise), "staged"
    pins the device-memory handoff. ``reshape`` is the view the consumer
    takes of the intermediate; it must keep the element count."""

    src: str
    dst: str
    dst_input: str
    prefer: str = "auto"
    reshape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.prefer not in ("auto", "fused", "staged"):
            raise ValueError(f"edge {self.src}->{self.dst}: prefer must be "
                             f"auto|fused|staged, got {self.prefer!r}")

    @property
    def label(self) -> str:
        return f"{self.src}->{self.dst}"


@dataclasses.dataclass(frozen=True)
class StreamGraph:
    """A DAG of stream programs joined by pipe edges, validated at
    construction: unique node names, edges between known nodes into
    Stream or BlockIn inputs (epilogue inputs count), no input fed twice,
    a reshape that keeps the element count, and no cycle."""

    name: str
    nodes: Tuple[GraphNode, ...]
    edges: Tuple[GraphEdge, ...] = ()

    def __post_init__(self):
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate node names {names}")
        by_name = {n.name: n for n in self.nodes}
        fed = set()
        for e in self.edges:
            for end in (e.src, e.dst):
                if end not in by_name:
                    raise ValueError(f"{self.name}: edge {e.label} names "
                                     f"unknown node {end!r}")
            if e.src == e.dst:
                raise ValueError(f"{self.name}: self-edge on {e.src!r}")
            prog = by_name[e.dst].effective_program
            inputs = {i.name for i in prog.inputs
                      if not isinstance(i, ScalarIn)}
            if e.dst_input not in inputs:
                raise ValueError(
                    f"{self.name}: edge {e.label} must feed a Stream input "
                    f"or BlockIn operand of {e.dst!r}: {e.dst_input!r} not "
                    f"in {sorted(inputs)}")
            key = (e.dst, e.dst_input)
            if key in fed:
                raise ValueError(f"{self.name}: input {e.dst}.{e.dst_input} "
                                 f"is fed by more than one edge")
            fed.add(key)
            if e.reshape is not None:
                src_prog = by_name[e.src].program
                if math.prod(e.reshape) != math.prod(src_prog.out_shape):
                    raise ValueError(
                        f"{self.name}: edge {e.label} reshape {e.reshape} "
                        f"does not preserve the element count of "
                        f"{src_prog.out_shape}")
        self.topo_order()    # raises on cycles

    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"{self.name}: unknown node {name!r}")

    def topo_order(self) -> Tuple[GraphNode, ...]:
        """Kahn topological order (stable in declaration order); raises
        ValueError on cycles."""
        indeg = {n.name: 0 for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        order: List[GraphNode] = []
        ready = [n for n in self.nodes if indeg[n.name] == 0]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for e in self.edges:
                if e.src == n.name:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        ready.extend(m for m in self.nodes
                                     if m.name == e.dst)
        if len(order) != len(self.nodes):
            cyc = sorted(set(indeg) - {n.name for n in order})
            raise ValueError(f"{self.name}: graph has a cycle through "
                             f"{cyc}")
        return tuple(order)

    def sinks(self) -> Tuple[str, ...]:
        """Nodes with no out-edge (the graph's outputs), in topo order."""
        srcs = {e.src for e in self.edges}
        return tuple(n.name for n in self.topo_order() if n.name not in srcs)


# ---------------------------------------------------------------------------
# Workload synthesis + graph identity (autotune key)
# ---------------------------------------------------------------------------


def node_workload(node: GraphNode) -> Workload:
    """The node's analytic workload (declared, or synthesized from the
    program's streams)."""
    if node.workload is not None:
        return node.workload
    return program_workload(node.program)


def _node_tile(node: GraphNode) -> Tuple[int, ...]:
    return tuple(node.plan_tile or node.program.streams[0].spec.tile)


def _node_dtype(node: GraphNode):
    return node.program.streams[0].spec.dtype


def _launch_nodes(graph) -> List[Tuple[str, Workload, Tuple[int, ...]]]:
    """``(name, Workload, tile)`` of a graph's nodes in launch order: a
    StreamGraph's in topological order, or such triples as they are (the
    call sites of a fixed chain of launches describe themselves so)."""
    if isinstance(graph, StreamGraph):
        return [(n.name, node_workload(n), _node_tile(n))
                for n in graph.topo_order()]
    return [tuple(n) for n in graph]


def graph_workload(graph) -> Tuple[Workload, Tuple[int, ...]]:
    """Summarize a graph as one Workload (the joint tuner's call site):
    total words, byte/flop averages weighted by words, irregular if any
    node is; the tile is the first node's. ``graph``: a StreamGraph, or
    ``(name, Workload, tile)`` triples in launch order."""
    nodes = _launch_nodes(graph)
    ws = [w for _, w, _ in nodes]
    n_words = max(sum(w.n_words for w in ws), 1)
    w = Workload(
        n_words=n_words,
        word_bytes=sum(w.word_bytes * w.n_words for w in ws) / n_words,
        flops_per_word=sum(w.flops_per_word * w.n_words for w in ws)
        / n_words,
        regular=all(w.regular for w in ws),
        store_bytes_per_word=sum(w.store_bytes_per_word * w.n_words
                                 for w in ws) / n_words,
    )
    return w, tuple(nodes[0][2])


def graph_signature(graph) -> str:
    """Structural identity of a graph for the tuned-plan key. A
    StreamGraph's, as the reference's: nodes (program, words, shapes,
    pipe tiles, epilogue) and edges, so two graphs with one signature
    lower identically. ``(name, Workload, tile)`` triples: each node's
    name, words, tile and word bytes in launch order."""
    if not isinstance(graph, StreamGraph):
        return ";".join(
            f"{name}/{w.n_words}w/{'x'.join(map(str, tile))}/"
            f"{w.word_bytes:g}B" for name, w, tile in graph)
    parts = []
    for n in graph.topo_order():
        p = n.program
        tiles = ",".join("x".join(map(str, s.spec.tile)) for s in p.streams)
        ep = f"+ep{len(n.epilogue.inputs)}" if n.epilogue else ""
        parts.append(f"{n.name}={p.name}{ep}/{p.n_words}w/"
                     f"{'x'.join(map(str, p.out_shape))}"
                     f"{dtype_name(p.out_dtype)}/[{tiles}]")
    for e in graph.edges:
        parts.append(f"{e.label}.{e.dst_input}.{e.prefer}"
                     + (f".r{'x'.join(map(str, e.reshape))}"
                        if e.reshape else ""))
    return ";".join(parts)


# ---------------------------------------------------------------------------
# Fusion legality (the reference's, on Python ints)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusionReport:
    """Outcome of the static legality analysis of one edge.

    When ``ok``: ``wpb`` producer words complete each of ``n_blocks``
    output blocks (contiguous, in ordinal order); ``ord_seq[g]`` is the
    block ordinal consumer word ``g`` reads; ``squeeze`` leading unit dims
    of the producer block are dropped to match the consumer tile;
    ``inter_depth`` sizes the on-chip intermediate ring.
    """

    ok: bool
    reason: str
    wpb: int = 1
    n_blocks: int = 0
    ord_seq: Tuple[int, ...] = ()
    squeeze: int = 0
    inter_depth: int = 1


def _strides(shape: Sequence[int]) -> List[int]:
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    return st


def _block_offset(idx, block, shape) -> int:
    return sum(int(i) * b * s for i, b, s in zip(idx, block, _strides(shape)))


def _is_contiguous_slab(block, shape) -> bool:
    """Is a block at any grid-aligned start a contiguous row-major slab?
    Leading unit dims are free; after the first non-unit dim every dim must
    be full."""
    dims = list(zip(block, shape))
    i = 0
    while i < len(dims) and dims[i][0] == 1:
        i += 1
    return all(b == d for b, d in dims[i + 1:])


def _squeeze(pblock, tile) -> int:
    squeeze = 0
    while len(pblock) - squeeze > len(tile) and pblock[squeeze] == 1:
        squeeze += 1
    return squeeze


def _runs(pout) -> List[List[Any]]:
    """The producer's completion runs: [block, start word, length]."""
    runs: List[List[Any]] = []
    for w, blk in enumerate(pout):
        if runs and runs[-1][0] == blk:
            runs[-1][2] += 1
        else:
            runs.append([blk, w, 1])
    return runs


def check_fusion(producer: StreamProgram, consumer: StreamProgram,
                 edge: GraphEdge) -> FusionReport:
    """Static legality of fusing ``edge`` (pure-Python schedule analysis).

    Legal iff the producer's output block schedule *is* the consumer's
    stream schedule: same tile (modulo leading unit dims), blocks completed
    in contiguous equal-length word runs, and the consumer's declared
    request order walks the completion order contiguously (a block may
    serve several consecutive consumer words). Anything else returns
    ``ok=False`` with the rationale that ends up in the plan.
    """

    def no(reason: str) -> FusionReport:
        return FusionReport(False, reason)

    try:
        st = consumer.stream(edge.dst_input)
    except KeyError as e:
        return no(str(e))
    if st.gather:
        return no(f"consumer stream {edge.dst_input!r} is an irregular "
                  f"gather (data-dependent addresses)")
    try:
        pout = producer.out_schedule()
    except ScheduleOpaqueError as e:
        return no(f"producer schedule opaque: {e}")
    try:
        creq = consumer.stream_schedule(edge.dst_input)
    except ScheduleOpaqueError as e:
        return no(f"consumer schedule opaque: {e}")

    pblock = tuple(producer.out_block)
    tile = tuple(st.spec.tile)
    squeeze = _squeeze(pblock, tile)
    if pblock[squeeze:] != tile:
        return no(f"mismatched block schedules: producer out_block {pblock} "
                  f"vs consumer tile {tile}")
    if dtype_name(producer.out_dtype) != dtype_name(st.spec.dtype):
        return no(f"dtype mismatch: producer {dtype_name(producer.out_dtype)} "
                  f"vs consumer pipe {dtype_name(st.spec.dtype)}")
    cshape = tuple(edge.reshape) if edge.reshape else tuple(producer.out_shape)
    if len(cshape) != len(tile):
        return no(f"consumer operand rank {len(cshape)} (shape {cshape}) "
                  f"!= stream tile rank {len(tile)}")
    if not _is_contiguous_slab(producer.out_block, producer.out_shape):
        return no(f"producer blocks {pblock} of {producer.out_shape} are "
                  f"not contiguous slabs (cannot be matched through a "
                  f"reshape)")
    if not _is_contiguous_slab(tile, cshape):
        return no(f"consumer tiles {tile} of {cshape} are not contiguous "
                  f"slabs (k-dim must fit one tile)")
    for b in (i for i in producer.inputs if isinstance(i, BlockIn)):
        try:
            Pipe(tile=tuple(b.block), dtype=b.dtype, depth=2)
        except ValueError as e:
            return no(f"producer BlockIn {b.name!r} cannot be promoted to a "
                      f"ring stream: {e}")

    # rank guards: a short/long index tuple would drop schedule components
    bad = {len(b) for b in pout} - {len(producer.out_block)}
    if bad:
        return no(f"producer out_index_map rank {sorted(bad)} != out_block "
                  f"rank {len(producer.out_block)}")
    bad = {len(b) for b in creq} - {len(tile)}
    if bad:
        return no(f"consumer stream index rank {sorted(bad)} != tile rank "
                  f"{len(tile)}")

    # producer completion runs: contiguous, equal length, each block once
    runs = _runs(pout)
    ordinal: Dict[Tuple[int, ...], int] = {}
    for o, (blk, _, _) in enumerate(runs):
        if blk in ordinal:
            return no(f"producer revisits output block {blk} "
                      f"non-contiguously")
        ordinal[blk] = o
    lengths = {r[2] for r in runs}
    if len(lengths) != 1:
        return no(f"producer block runs have unequal lengths "
                  f"{sorted(lengths)}")
    wpb, n_blocks = runs[0][2], len(runs)

    # map consumer requests onto producer ordinals through element offsets
    # (offsets survive the edge reshape; block tuples do not)
    p_by_off = {_block_offset(blk, producer.out_block, producer.out_shape): o
                for blk, o in ordinal.items()}
    ord_seq: List[int] = []
    prev = -1
    for g, blk in enumerate(creq):
        off = _block_offset(blk, tile, cshape)
        if off not in p_by_off:
            return no(f"consumer word {g} requests block {blk} (offset "
                      f"{off}) the producer never writes")
        o = p_by_off[off]
        if o not in (prev, prev + 1):
            return no(f"consumer request order is not contiguous "
                      f"non-decreasing (ordinal {prev}->{o} at word {g})")
        prev = o
        ord_seq.append(o)
    if prev != n_blocks - 1:
        return no(f"consumer consumes {prev + 1} of {n_blocks} produced "
                  f"blocks — the rest would never be scheduled")
    return FusionReport(
        ok=True,
        reason=(f"fusable: {n_blocks} blocks x {wpb} producer words each, "
                f"tile {tile}, consumer revisits "
                f"{len(ord_seq) / n_blocks:.1f}x"),
        wpb=wpb,
        n_blocks=n_blocks,
        ord_seq=tuple(ord_seq),
        squeeze=squeeze,
        inter_depth=1 if n_blocks == 1 else 2,
    )


@dataclasses.dataclass(frozen=True)
class _RingServe:
    """A second consumer edge served from a fused chain's intermediate
    ring: the producer at chain position ``src_pos`` feeds stage
    ``dst_pos``'s input ``edge.dst_input`` (a Stream or BlockIn) straight
    from the ring of edge ``src_pos -> src_pos+1``; ``slot_seq[w]`` is the
    slot holding the needed block at stage-``dst_pos`` word ``w``."""

    edge: GraphEdge
    src_pos: int
    dst_pos: int
    kind: str                     # "stream" | "block"
    slot_seq: Tuple[int, ...]
    squeeze: int


def _blockin_schedule(program: StreamProgram,
                      bi: BlockIn) -> Tuple[Tuple[int, ...], ...]:
    """A BlockIn's block schedule, one index tuple per word (static only,
    like ``out_schedule``); ScheduleOpaqueError when data-dependent."""
    dummies = tuple(_OpaqueScalar()
                    for _ in range(program.num_scalar_prefetch))
    sched = []
    for g in range(program.n_words):
        try:
            idx = bi.index_map(g, *dummies)
            sched.append(tuple(int(i) for i in idx))
        except ScheduleOpaqueError:
            raise
        except Exception as e:   # noqa: BLE001 — map not int-evaluable
            raise ScheduleOpaqueError(
                f"{program.name}: BlockIn {bi.name!r} index_map is not "
                f"statically evaluable at word {g}: "
                f"{type(e).__name__}: {e}") from e
    return tuple(sched)


def _check_ring_serve(progs: Sequence[StreamProgram],
                      reps: Sequence[FusionReport], edge: GraphEdge,
                      src_pos: int, dst_pos: int):
    """Can ``edge`` be served from the fused chain's intermediate ring?

    Legal iff, at every word of the consuming stage, the block the input
    requests *is* the block the chain's demand-driven schedule most
    recently produced into the ring of edge ``src_pos -> src_pos+1``.
    Returns ``(ok, rationale, _RingServe | None)``.
    """
    def no(reason: str):
        return False, reason, None

    P, D = progs[src_pos], progs[dst_pos]
    try:
        st = D.stream(edge.dst_input)
    except KeyError:
        st = None
    if st is not None:
        if st.gather:
            return no(f"input {edge.dst_input!r} is an irregular gather "
                      f"(data-dependent addresses)")
        kind, tile, dt = "stream", tuple(st.spec.tile), st.spec.dtype
        try:
            creq = D.stream_schedule(edge.dst_input)
        except ScheduleOpaqueError as e:
            return no(str(e))
    else:
        bi = next((i for i in D.inputs
                   if isinstance(i, BlockIn) and i.name == edge.dst_input),
                  None)
        if bi is None:
            return no(f"{D.name} has no input {edge.dst_input!r}")
        kind, tile, dt = "block", tuple(bi.block), bi.dtype
        try:
            creq = _blockin_schedule(D, bi)
        except ScheduleOpaqueError as e:
            return no(str(e))

    pblock = tuple(P.out_block)
    squeeze = _squeeze(pblock, tile)
    if pblock[squeeze:] != tile:
        return no(f"mismatched block schedules: producer out_block {pblock} "
                  f"vs consumer block {tile}")
    if dtype_name(P.out_dtype) != dtype_name(dt):
        return no(f"dtype mismatch: producer {dtype_name(P.out_dtype)} vs "
                  f"consumer {dtype_name(dt)}")
    cshape = tuple(edge.reshape) if edge.reshape else tuple(P.out_shape)
    if len(cshape) != len(tile):
        return no(f"consumer operand rank {len(cshape)} != block rank "
                  f"{len(tile)}")
    if not _is_contiguous_slab(P.out_block, P.out_shape) \
            or not _is_contiguous_slab(tile, cshape):
        return no("blocks are not contiguous slabs (cannot be matched "
                  "through a reshape)")
    try:
        pout = P.out_schedule()
    except ScheduleOpaqueError as e:
        return no(f"producer schedule opaque: {e}")
    p_by_off = {
        _block_offset(blk, P.out_block, P.out_shape): o
        for o, (blk, _, _) in enumerate(_runs(pout))}
    depth = reps[src_pos].inter_depth
    slot_seq = []
    for g, blk in enumerate(creq):
        off = _block_offset(blk, tile, cshape)
        if off not in p_by_off:
            return no(f"word {g} requests block {blk} the producer never "
                      f"writes")
        need = p_by_off[off]
        # the ring holds the block the chain most recently produced: walk
        # the demand-driven schedule from the consuming stage back to the
        # producer (block -> last word that completed it, per edge)
        w, j = g, dst_pos - 1
        while True:
            held = reps[j].ord_seq[w]
            if j == src_pos:
                break
            w = (held + 1) * reps[j].wpb - 1
            j -= 1
        if need != held:
            return no(f"input does not track the chain's live intermediate "
                      f"(word {g} needs producer block ordinal {need}, the "
                      f"ring holds {held})")
        slot_seq.append(need % depth)
    rationale = (f"served in-chain from {edge.src!r}'s intermediate on-chip "
                 f"ring (depth {depth}); the shared output never "
                 f"materializes in device memory")
    return True, rationale, _RingServe(edge, src_pos, dst_pos, kind,
                                       tuple(slot_seq), squeeze)


# ---------------------------------------------------------------------------
# The hand-fused kernels a legal chain lowers onto
# ---------------------------------------------------------------------------


def _prog_kw(prog: StreamProgram, key: str, default=None):
    return prog.kernel_kwargs.get(key, default)


@dataclasses.dataclass(frozen=True)
class FusedKernel:
    """A hand-written kernel that computes a whole fused chain.

    ``kernels`` are the chain's programs' ``kernel`` names in order;
    ``accepts(progs, edges, serves)`` returns None where the kernel
    computes this chain, else why not; ``smem(progs, depth)`` is one
    block's shared memory at ring ``depth`` and ``max_depth(progs)`` the
    deepest ring that fits; ``run(progs, edges, serves, ops, policy)``
    launches it on ``ops`` ({node position: {input: tensor}}) and returns
    the chain's output in the tail program's ``out_shape``."""

    name: str
    kernels: Tuple[str, ...]
    accepts: Callable[..., Optional[str]]
    smem: Callable[..., int]
    max_depth: Callable[..., int]
    run: Callable[..., Any]


def _no_epilogues(progs, *_):
    for p in progs:
        if _prog_kw(p, "epilogue") is not None:
            return f"{p.name} carries an epilogue the kernel lacks"
    return None


def _dispatch_run(progs, edges, serves, ops, policy):
    from repro_torch.kernels.ff_matmul import dispatch_matmul
    return dispatch_matmul(ops[0]["table"], ops[0]["idx"], ops[1]["b"],
                           policy=policy)


def _dispatch_types(progs):
    """The expert product's operand types: the gathered rows', B's."""
    return progs[0].out_dtype, progs[1].stream("b").spec.dtype


def _dispatch_smem(progs, depth):
    from repro_torch.kernels.ff_matmul.ops import _smem_bytes
    return _smem_bytes(depth, *_dispatch_types(progs))


def _dispatch_max_depth(progs):
    from repro_torch.kernels.ff_matmul.ops import max_depth
    return max_depth(*_dispatch_types(progs))


def _attn_proj_accepts(progs, edges, serves):
    why = _no_epilogues(progs)
    if why is None and _prog_kw(progs[0], "kv_groups") != 1:
        why = ("ff_attention_proj takes one KV head a q head (kv_groups "
               f"{_prog_kw(progs[0], 'kv_groups')})")
    return why


def _attn_proj_run(progs, edges, serves, ops, policy):
    from repro_torch.kernels.ff_attention import attention_proj
    a = ops[0]
    return attention_proj(a["q"], a["k"], a["v"], ops[1]["b"],
                          causal=_prog_kw(progs[0], "causal"), policy=policy)


def _attn_d(progs) -> int:
    return progs[0].out_shape[-1]


def _attn_proj_smem(progs, depth):
    from repro_torch.kernels.ff_attention.ops import _smem_bytes
    return _smem_bytes(_attn_d(progs), depth, progs[0].out_dtype)


def _attn_proj_max_depth(progs):
    from repro_torch.kernels.ff_attention import max_depth
    return max_depth(_attn_d(progs), progs[0].out_dtype)


def _paged_geometry(progs):
    b, kvh, g, d = progs[1].out_shape
    return b, kvh, g, d, _prog_kw(progs[1], "page"), \
        _prog_kw(progs[1], "n_pages")


def _paged_run(progs, edges, serves, ops, policy):
    from repro_torch.runtime.paged_kv import paged_decode_attention, \
        page_word_indices
    b, kvh, g, d, page, n_pages = _paged_geometry(progs)
    idx, table = ops[0]["idx"], ops[0]["table"]
    nb = table.shape[0] // (2 * page * kvh)
    pool = table.view(nb, 2, page, kvh, d)
    # the kernel reads the pages through a block table: recover it from
    # the row stream, which must be the table's walk (page_word_indices)
    tables = (idx.view(b, kvh, n_pages, 2, page)[:, 0, :, 0, 0].long()
              // (2 * page * kvh))
    if not bool((page_word_indices(tables, page=page, kv_heads=kvh,
                                   n_blocks=nb) == idx.to(
                                       torch.int32)).all()):
        raise ValueError(
            "the fused paged decode reads the pool through a block table: "
            "the gather's rows are not one (page_word_indices)")
    q = ops[1]["q"]
    out = paged_decode_attention(q.reshape(b, kvh * g, d), pool, tables,
                                 ops[1]["lengths"], policy=policy)
    return out.view(b, kvh, g, d)


def _paged_smem(progs, depth):
    from repro_torch.kernels.ff_decode_attention.ops import smem_bytes
    b, kvh, g, d, _, _ = _paged_geometry(progs)
    return smem_bytes(depth, d, progs[0].out_dtype, g)


def _paged_max_depth(progs):
    from repro_torch.kernels.ff_decode_attention.ops import max_depth
    b, kvh, g, d, _, _ = _paged_geometry(progs)
    return max(max_depth(d, progs[0].out_dtype, g), 1)


def _tail_accepts(progs, edges, serves):
    oproj, gateup, down = progs
    if (_prog_kw(oproj, "norm") or _prog_kw(down, "norm")
            or not _prog_kw(gateup, "norm")):
        return ("ff_layer_mlp_tail normalizes the SwiGLU's input only (its "
                "projections take no RMSNorm prologue)")
    if _prog_kw(oproj, "epilogue") != "residual" \
            or _prog_kw(down, "epilogue") != "residual":
        return "ff_layer_mlp_tail adds a residual after both projections"
    if edges[0].dst_input != "x" or edges[1].dst_input != "a":
        return "the chain does not feed the SwiGLU's x and the down's a"
    res = _prog_kw(down, "epilogue_inputs")[0]
    if not any(s.src_pos == 0 and s.dst_pos == 2
               and s.edge.dst_input == res for s in serves):
        return ("ff_layer_mlp_tail adds the out-projection's output as the "
                "down-projection's residual: that edge is not served "
                "in-chain")
    return None


def _tail_run(progs, edges, serves, ops, policy):
    from repro_torch.kernels.ff_layer import ff_layer_mlp_tail
    from repro_torch.kernels.ff_layer.program import row
    oproj = ops[0]
    res1 = oproj[_prog_kw(progs[0], "epilogue_inputs")[0]]
    return ff_layer_mlp_tail(oproj["a"], oproj["b"], res1,
                             row(ops[1]["nw"]), ops[1]["wg"], ops[1]["wu"],
                             ops[2]["b"], eps=_prog_kw(progs[1], "eps"),
                             policy=policy)


def _tail_smem(progs, depth):
    from repro_torch.kernels.ff_layer.ops import _smem_bytes
    return _smem_bytes(depth)


def _tail_max_depth(progs):
    from repro_torch.kernels.ff_layer.ops import MAX_DEPTH
    return MAX_DEPTH


FUSED_KERNELS: Tuple[FusedKernel, ...] = (
    FusedKernel("ff_dispatch_matmul", ("ff_gather", "ff_matmul"),
                _no_epilogues, _dispatch_smem, _dispatch_max_depth,
                _dispatch_run),
    FusedKernel("ff_attention_proj", ("ff_attention", "ff_matmul"),
                _attn_proj_accepts, _attn_proj_smem, _attn_proj_max_depth,
                _attn_proj_run),
    FusedKernel("ff_paged_decode_attention",
                ("ff_gather", "ff_paged_decode_attention"), _no_epilogues,
                _paged_smem, _paged_max_depth, _paged_run),
    FusedKernel("ff_layer_mlp_tail",
                ("ff_layer_matmul", "ff_layer_swiglu", "ff_layer_matmul"),
                _tail_accepts, _tail_smem, _tail_max_depth, _tail_run),
)


def _match_kernel(progs, edges, serves) -> Tuple[Optional[FusedKernel], str]:
    """The hand-fused kernel that computes this chain, or why none."""
    names = tuple(p.kernel for p in progs)
    for fk in FUSED_KERNELS:
        if fk.kernels == names:
            why = fk.accepts(progs, edges, serves)
            if why is None:
                return fk, ""
            return None, f"{fk.name} does not apply: {why}"
    return None, (f"the port has no hand-fused kernel for the chain "
                  f"{' -> '.join(names)}")


# ---------------------------------------------------------------------------
# compile_graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """One edge's lowering decision, with the rationale that justifies it
    (fused: legality, kernel and shared-memory line; staged: why fusion
    was rejected)."""

    edge: GraphEdge
    mode: str                     # "fused" | "staged"
    rationale: str
    hbm_bytes_saved: float = 0.0


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """The compiled graph's plan: per-edge decisions, the pipe model's
    per-node sizing of the declared words under each node's share of the
    shared-memory budget, the budget split, and the estimate."""

    edges: Tuple[EdgePlan, ...]
    sizing: Mapping[str, Tuple[int, int]]       # node -> (depth, streams)
    budgets: Mapping[str, int]                  # node -> smem share
    estimate: Any                               # pipeline_model.GraphEstimate

    @property
    def fused(self) -> Tuple[EdgePlan, ...]:
        return tuple(e for e in self.edges if e.mode == "fused")

    @property
    def hbm_bytes_saved(self) -> float:
        return sum(e.hbm_bytes_saved for e in self.edges)


@dataclasses.dataclass(frozen=True)
class _Unit:
    """One launch of the compiled graph: a node's own kernel ("node") or a
    hand-fused kernel for a whole chain ("fused"). ``launch`` names the
    kernel; ``operands`` are ``(node, input)`` per call argument."""

    kind: str                     # "node" | "fused"
    out_node: str
    launch: str
    fn: Callable
    operands: Tuple[Tuple[str, str], ...]


class CompiledGraph:
    """The compiled multi-kernel program.

    Call it with the graph's external operands in :attr:`arg_names` order
    (``"node.input"`` labels; edge-fed inputs are internal); it returns the
    sink node's output (a tuple for several sinks). ``plan`` carries the
    per-edge decisions, rationales and the estimate; ``units`` the launch
    structure (one "fused" unit: one kernel for a whole chain)."""

    def __init__(self, graph: StreamGraph, policy, plan: GraphPlan,
                 units: Tuple[_Unit, ...], arg_names: Tuple[str, ...],
                 edges_in: Mapping[Tuple[str, str], GraphEdge]):
        self.graph = graph
        self.policy = policy
        self.plan = plan
        self.units = units
        self.arg_names = arg_names
        self._edges_in = dict(edges_in)
        self._sinks = graph.sinks()

    def __call__(self, *args):
        if len(args) != len(self.arg_names):
            raise TypeError(
                f"{self.graph.name}: expected {len(self.arg_names)} operands "
                f"{list(self.arg_names)}, got {len(args)}")
        vals = dict(zip(self.arg_names, args))
        outs: Dict[str, Any] = {}
        for unit in self.units:
            ops = []
            for node, name in unit.operands:
                e = self._edges_in.get((node, name))
                if e is not None:
                    v = outs[e.src]
                    ops.append(v.reshape(e.reshape) if e.reshape else v)
                else:
                    ops.append(vals[f"{node}.{name}"])
            outs[unit.out_node] = unit.fn(*ops)
        res = tuple(outs[s] for s in self._sinks)
        return res[0] if len(res) == 1 else res


def _resolve_node(graph: StreamGraph, node: GraphNode, policy,
                  budget: int, mesh: MeshSpec = SINGLE_DEVICE,
                  shards: int = 1) -> Tuple[Workload, int, int]:
    """Per-node (depth, streams) under the node's split budget: explicit
    policy ints pass through; "auto"/"measured" resolve through the
    planner. ``shards`` localizes the node's word schedule to the mesh's
    per-shard view before planning; ``mesh`` keys the plan."""
    w = localize_workload(node_workload(node), shards)
    depth, streams = policy.depth, policy.streams
    if isinstance(depth, str) or isinstance(streams, str):
        try:
            plan = planner.planned_pipe(
                f"graph:{graph.name}/{node.name}", w, _node_tile(node),
                _node_dtype(node), policy.hw,
                stream_options=tuple(policy.stream_options),
                smem_budget_bytes=budget, mesh=mesh)
            d_plan, s_plan = plan.pipe.depth, plan.pipe.streams
        except PlanError:
            # the split budget is too tight for the latency-hiding depth:
            # degrade to the shallowest ring that fits
            tile, dt = _node_tile(node), _node_dtype(node)
            d_plan = 2 if Pipe(tile=tile, dtype=dt,
                               depth=2).smem_bytes <= budget else 1
            s_plan = 1
        depth = d_plan if isinstance(depth, str) else int(depth)
        streams = s_plan if isinstance(streams, str) else int(streams)
    depth, streams = int(depth), int(streams)
    if w.n_words > 0:
        depth = max(1, min(depth, w.n_words))
    if policy.mode == "baseline":
        depth = 1
    return w, depth, streams


def _fused_fn(fk: FusedKernel, progs, cedges, serves, operands, policy):
    k = len(progs)

    def fn(*args):
        ops: Dict[int, Dict[str, Any]] = {i: {} for i in range(k)}
        for (pos, name), v in zip(operands, args):
            ops[pos][name] = v
        return fk.run(progs, cedges, serves, ops, policy)
    return fn


def compile_graph(graph: StreamGraph, *, policy=None,
                  smem_budget_bytes: int = _SMEM_BUDGET_BYTES,
                  prefer: Optional[str] = None,
                  sharding=None) -> CompiledGraph:
    """Compile a :class:`StreamGraph`, choosing fused/staged per edge.

    Per edge: "auto" fuses when the static legality analysis passes, the
    chain it joins is computed by a hand-fused kernel, and that kernel's
    shared memory fits the sum of the chain members' shares of
    ``smem_budget_bytes``; otherwise it stages with the rejection as its
    rationale. ``prefer`` (or ``edge.prefer``) = "fused" turns a staged
    outcome into a :class:`~repro_torch.core.planner.PlanError` carrying
    the lines; "staged" pins the device-memory handoff.

    ``sharding`` (a ShardingContext or a MeshSpec; None: the ambient one)
    makes the compile mesh-aware: each node's workload is localized to the
    per-shard word schedule before planning, and every node plan is keyed
    by the mesh topology.

    Each unit launches through the kernels' policy-taking entry points
    (those of ``repro_torch.ops``) under ``policy`` (default: the
    session's), which plan their own ring at launch; CPU tensors run their
    plain versions.
    """
    from repro_torch.core.program import current_policy
    policy = policy or current_policy()
    sh = sharding if sharding is not None else policy.mesh
    mesh, shards = resolve_sharding(sh)
    with obs.span("compile_graph", graph=graph.name,
                  nodes=len(graph.nodes)) as sp:
        compiled = _compile(graph, policy, smem_budget_bytes, prefer, mesh,
                            shards)
        n_fused = len(compiled.plan.fused)
        sp.set(hbm_bytes_saved=compiled.plan.hbm_bytes_saved,
               fused_edges=n_fused,
               staged_edges=len(compiled.plan.edges) - n_fused)
    return compiled


def _compile(graph, policy, smem_budget_bytes, prefer, mesh, shards):
    order = graph.topo_order()
    # epilogues fold into the program once, up front: everything below sees
    # the effective program
    nodes = {n.name: (dataclasses.replace(n, program=n.effective_program,
                                          epilogue=None)
                      if n.epilogue else n)
             for n in graph.nodes}
    budgets = planner.split_graph_budget(
        [n.name for n in order], smem_budget_bytes)
    resolved = {n.name: _resolve_node(graph, nodes[n.name], policy,
                                      budgets[n.name], mesh=mesh,
                                      shards=shards)
                for n in order}
    pos = {n.name: i for i, n in enumerate(order)}

    def _is_stream(dst: str, input_name: str) -> bool:
        try:
            nodes[dst].program.stream(input_name)
            return True
        except KeyError:
            return False

    stream_edges = [e for e in graph.edges if _is_stream(e.dst, e.dst_input)]
    block_edges = [e for e in graph.edges
                   if not _is_stream(e.dst, e.dst_input)]

    # -- pass A: greedy chain building over legal stream edges --------------
    edge_plans: Dict[GraphEdge, EdgePlan] = {}
    reports: Dict[GraphEdge, FusionReport] = {}
    fused_in: Dict[str, GraphEdge] = {}       # consumer -> fused in-edge
    fused_next: Dict[str, GraphEdge] = {}     # producer -> fused out-edge
    for e in sorted(stream_edges, key=lambda e: (pos[e.dst], pos[e.src])):
        pref = prefer or e.prefer
        if pref == "staged":
            edge_plans[e] = EdgePlan(e, "staged", "staged by request")
            continue
        rep = check_fusion(nodes[e.src].program, nodes[e.dst].program, e)
        if not rep.ok:
            reason = rep.reason
        elif e.src in fused_next:
            reason = (f"producer {e.src!r} already fuses into "
                      f"{fused_next[e.src].dst!r} (one fused out-edge "
                      f"per node)")
        elif e.dst in fused_in:
            reason = (f"consumer {e.dst!r} already has a fused in-edge "
                      f"from {fused_in[e.dst].src!r} (one fused in-edge "
                      f"per node)")
        else:
            reports[e] = rep
            fused_in[e.dst] = e
            fused_next[e.src] = e
            continue
        edge_plans[e] = EdgePlan(e, "staged", reason)

    def _chains() -> Dict[str, Tuple[Tuple[str, ...], int]]:
        res: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        for tail in (n for n in fused_in if n not in fused_next):
            cn = [tail]
            while cn[0] in fused_in:
                cn.insert(0, fused_in[cn[0]].src)
            for i, n in enumerate(cn):
                res[n] = (tuple(cn), i)
        return res

    def _unwind(cn, why):
        for m in cn[1:]:
            fe = fused_in.pop(m)
            del fused_next[fe.src]
            reports.pop(fe, None)
            edge_plans[fe] = EdgePlan(fe, "staged", why)

    serves: Dict[GraphEdge, Tuple[_RingServe, str]] = {}
    kernels: Dict[Tuple[str, ...], Tuple[FusedKernel, str]] = {}
    while True:
        # -- pass B: multi-consumer resolution (ring-serve or unwind) -------
        serves.clear()
        in_chain = _chains()
        conflict = None
        for src, fe in list(fused_next.items()):
            for e2 in graph.edges:
                if e2.src != src or e2 == fe:
                    continue
                if (prefer or e2.prefer) == "staged":
                    conflict = (fe, f"producer {src!r} output has multiple "
                                    f"consumers and edge {e2.label} is "
                                    f"staged by request, so it must "
                                    f"materialize in device memory")
                    break
                sinfo, dinfo = in_chain.get(src), in_chain.get(e2.dst)
                if sinfo and dinfo and sinfo[0] == dinfo[0] \
                        and dinfo[1] > sinfo[1]:
                    cn = sinfo[0]
                    ok, why, serve = _check_ring_serve(
                        [nodes[n].program for n in cn],
                        [reports[fused_in[n]] for n in cn[1:]],
                        e2, sinfo[1], dinfo[1])
                else:
                    ok, why, serve = False, (
                        f"consumer {e2.dst!r} is not downstream of "
                        f"{src!r} in the fused chain"), None
                if ok:
                    serves[e2] = (serve, why)
                else:
                    conflict = (fe, f"producer {src!r} also feeds "
                                    f"{e2.dst}.{e2.dst_input}, which "
                                    f"cannot be served from the chain's "
                                    f"intermediate on-chip ring: {why}")
                    break
            if conflict:
                break
        if conflict is not None:
            fe, why = conflict
            edge_plans[fe] = EdgePlan(fe, "staged", why)
            del fused_in[fe.dst]
            del fused_next[fe.src]
            reports.pop(fe, None)
            continue
        # -- pass C: each chain onto its hand-fused kernel, in its budget ---
        kernels.clear()
        unwound = False
        for cn in sorted({c for c, _ in _chains().values()},
                         key=lambda c: pos[c[0]]):
            progs = [nodes[n].program for n in cn]
            cedges = [fused_in[n] for n in cn[1:]]
            cserves = [s for s, _ in serves.values() if s.edge.dst in cn
                       and s.edge.src in cn]
            fk, why = _match_kernel(progs, cedges, cserves)
            if fk is not None:
                # the kernel plans its own ring at launch; the chain must
                # fit its share at least double-buffered (or at the
                # policy's own depth)
                depth = 1 if policy.mode == "baseline" else \
                    2 if isinstance(policy.depth, str) else int(policy.depth)
                depth = max(1, min(depth, fk.max_depth(progs)))
                need = fk.smem(progs, depth)
                share = sum(budgets[n] for n in cn)
                line = (f"{fk.name} shared memory {need}B at depth {depth} "
                        f"{'fits' if need <= share else 'exceeds'} the "
                        f"{share}B fused-stage budget")
                if need <= share:
                    kernels[cn] = (fk, line)
                    continue
                why = line
            _unwind(cn, f"legal to fuse, but {why}")
            unwound = True
        if not unwound:
            break

    for cn, (fk, line) in kernels.items():
        for m in cn[1:]:
            e = fused_in[m]
            P, C = nodes[e.src].program, nodes[e.dst].program
            st = C.stream(e.dst_input)
            saved = (float(math.prod(P.out_shape)) * itemsize(P.out_dtype)
                     + float(C.n_words) * st.spec.word_bytes)
            edge_plans[e] = EdgePlan(e, "fused",
                                     f"{reports[e].reason}; {line}", saved)

    for e2, (serve, why) in serves.items():
        D = nodes[e2.dst].program
        if serve.kind == "stream":
            load = float(D.n_words) * D.stream(e2.dst_input).spec.word_bytes
        else:
            bi = next(i for i in D.inputs
                      if isinstance(i, BlockIn) and i.name == e2.dst_input)
            load = float(D.n_words) * float(math.prod(bi.block)) \
                * itemsize(bi.dtype)
        edge_plans[e2] = EdgePlan(e2, "fused", why, load)

    for e2 in block_edges:
        if e2 in edge_plans:
            continue
        if (prefer or e2.prefer) == "staged":
            edge_plans[e2] = EdgePlan(e2, "staged", "staged by request")
            continue
        edge_plans[e2] = EdgePlan(e2, "staged", (
            f"consumer input {e2.dst}.{e2.dst_input} is a block-delivered "
            f"operand (BlockIn), not a pipe stream; its producer is not "
            f"fused away, so the intermediate materializes in device "
            f"memory"))

    rejected = [
        f"{e.label}: {edge_plans[e].rationale}"
        for e in sorted(graph.edges, key=lambda e: (pos[e.dst], pos[e.src]))
        if edge_plans[e].mode == "staged"
        and (prefer or e.prefer) == "fused"]
    if rejected:
        first = next(e for e in graph.edges
                     if edge_plans[e].mode == "staged"
                     and (prefer or e.prefer) == "fused")
        raise PlanError(resolved[first.dst][0],
                        budgets[first.src] + budgets[first.dst], rejected)

    # -- executable units (a fused chain is one launch) ---------------------
    edges_in = {(e.dst, e.dst_input): e for e in graph.edges
                if edge_plans[e].mode == "staged"}
    chain_map = _chains()
    units: List[_Unit] = []
    for n in order:
        if n.name in fused_next:
            continue    # launched inside its chain's fused unit
        if n.name in fused_in:
            cn, _ = chain_map[n.name]
            fk, _ = kernels[cn]
            progs = [nodes[m].program for m in cn]
            cedges = [fused_in[m] for m in cn[1:]]
            cserves = [s for s, _ in serves.values() if s.edge.dst in cn
                       and s.edge.src in cn]
            internal = {(e.dst, e.dst_input) for e in cedges} | \
                {(s.edge.dst, s.edge.dst_input) for s in cserves}
            operands = [(p, m, i.name) for p, m in enumerate(cn)
                        for i in nodes[m].program.inputs
                        if (m, i.name) not in internal]
            fn = _fused_fn(fk, progs, cedges, cserves,
                           [(p, name) for p, _, name in operands], policy)
            units.append(_Unit("fused", n.name, fk.name, fn,
                               tuple((m, name) for _, m, name in operands)))
        else:
            prog = nodes[n.name].program
            units.append(_Unit(
                "node", n.name, prog.kernel,
                compile_program(prog, policy=policy),
                tuple((n.name, i.name) for i in prog.inputs)))

    fed_any = {(e.dst, e.dst_input) for e in graph.edges}
    arg_names = tuple(
        f"{n.name}.{i.name}" for n in order
        for i in nodes[n.name].program.inputs
        if (n.name, i.name) not in fed_any)

    # -- analytic estimate (MKPipe stage overlap + per-edge traffic) --------
    stage_order: List[GraphNode] = []
    for u in units:
        if u.kind == "fused":
            cn, _ = chain_map[u.out_node]
            stage_order.extend(nodes[m] for m in cn)
        else:
            stage_order.append(nodes[u.out_node])
    stages = []
    for n in stage_order:
        w, d, s = resolved[n.name]
        tile = _node_tile(n)
        pipe = Pipe(tile=tile, dtype=_node_dtype(n), depth=max(d, 1),
                    streams=_clamped_streams(tile[0], s))
        e = fused_in.get(n.name)
        in_edges = [ed for ed in graph.edges if ed.dst == n.name]
        rationale = ""
        if e is not None:
            rationale = edge_plans[e].rationale
        elif in_edges:
            rationale = "; ".join(
                edge_plans[ed].rationale for ed in in_edges)
        prev_name = stages[-1].name if stages else None
        fused_with_prev = e is not None and e.src == prev_name
        saved_load = saved_store = 0.0
        if fused_with_prev:
            P = nodes[e.src].program
            st = nodes[e.dst].program.stream(e.dst_input)
            saved_store = float(math.prod(P.out_shape)) \
                * itemsize(P.out_dtype)
            saved_load = float(nodes[e.dst].program.n_words) \
                * st.spec.word_bytes
        stages.append(GraphStage(
            name=n.name, workload=w, pipe=pipe,
            fused_with_prev=fused_with_prev,
            saved_load_bytes=saved_load, saved_store_bytes=saved_store,
            rationale=rationale))
    adjacent = {(a.name, b.name)
                for a, b in zip(stage_order, stage_order[1:])}
    extra = tuple(
        EdgeEstimate(edge=e.label, mode=edge_plans[e].mode,
                     hbm_bytes_saved=edge_plans[e].hbm_bytes_saved
                     if edge_plans[e].mode == "fused" else 0.0,
                     rationale=edge_plans[e].rationale)
        for e in graph.edges if (e.src, e.dst) not in adjacent)
    estimate = estimate_graph(tuple(stages), policy.hw, extra_edges=extra)

    plan = GraphPlan(
        edges=tuple(edge_plans[e] for e in graph.edges),
        sizing={k: (d, s) for k, (_, d, s) in resolved.items()},
        budgets=budgets,
        estimate=estimate,
    )
    return CompiledGraph(graph, policy, plan, tuple(units), arg_names,
                         edges_in)
