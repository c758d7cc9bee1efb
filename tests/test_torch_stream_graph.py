"""The port's StreamProgram declarations and StreamGraph compiler
(``repro_torch.core.program``, ``repro_torch.core.graph``) against the
reference's (``repro.core.program``, ``repro.core.graph``), case for case
with ``tests/test_graph.py``:

* every ``build_program`` declares the reference's block schedules and
  workload at the same arguments, and ``compile_program`` launches the
  entry point ``repro_torch.ops`` launches;
* ``check_fusion`` verdicts and geometry, the graph validation errors, the
  fused/staged plan of the toy graph and the four shipped graphs (modes,
  ``hbm_bytes_saved``) equal the reference's; ``estimate_graph`` gives the
  reference's numbers on the same stages and hardware;
* the compiled graphs' outputs equal the reference's ``compile_graph``
  (Pallas in interpret mode) within each graph's tolerance, fused and
  staged;
* what only the port has: a legal chain with no hand-fused kernel stages
  (or raises under ``prefer="fused"``), an epilogue a kernel lacks is
  refused, and the shared-memory budget cases at shapes chosen for the
  port's budget (its kernels' footprints, not the reference's 96 MiB).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import graph as jg
from repro.core import pipeline_model as jpm
from repro.core.pipe import Pipe as JPipe
from repro.core.planner import PlanError as JPlanError
from repro.core.program import ScheduleOpaqueError as JOpaque
from repro.kernels import registry as JR
from repro.kernels.ff_attention.kernel import build_program as j_attn
from repro.kernels.ff_chunk_scan.kernel import build_program as j_scan
from repro.kernels.ff_decode_attention.kernel import \
    build_paged_program as j_paged
from repro.kernels.ff_decode_attention.kernel import build_program as j_dec
from repro.kernels.ff_gather.kernel import build_program as j_gather
from repro.kernels.ff_layer.kernel import build_matmul_program as j_lmm
from repro.kernels.ff_layer.kernel import build_swiglu_program as j_lsw
from repro.kernels.ff_matmul.kernel import build_program as j_mm
from repro.models import layers as JL
from repro.models import moe as JM
from repro.runtime import paged_kv as JP
from repro_torch.core import meshspec, planner
from repro_torch.core import pipeline_model as tpm
from repro_torch.core.graph import (Epilogue, GraphEdge, GraphNode,
                                    StreamGraph, check_fusion, compile_graph,
                                    graph_signature, graph_workload)
from repro_torch.core.pipe import Pipe, dtype_name
from repro_torch.core.planner import PlanError
from repro_torch.core.program import (BlockIn, PipePolicy,
                                      ScheduleOpaqueError, compile_program,
                                      program_workload)
from repro_torch.kernels import registry as TR
from repro_torch.kernels.ff_attention.program import build_program as t_attn
from repro_torch.kernels.ff_chunk_scan.program import build_program as t_scan
from repro_torch.kernels.ff_decode_attention.program import \
    build_paged_program as t_paged
from repro_torch.kernels.ff_decode_attention.program import \
    build_program as t_dec
from repro_torch.kernels.ff_gather.program import build_program as t_gather
from repro_torch.kernels.ff_layer.program import \
    build_matmul_program as t_lmm
from repro_torch.kernels.ff_layer.program import \
    build_swiglu_program as t_lsw
from repro_torch.kernels.ff_matmul.program import build_program as t_mm
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.runtime import paged_kv as TP

F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)

# (name, reference builder, port builder, args, keywords without dtype,
#  dtypes): each pair at the same arguments
PROGRAMS = [
    ("matmul", j_mm, t_mm, (256, 256, 256), {"block": (128, 128, 128)}, F32),
    ("matmul_k_split", j_mm, t_mm, (64, 256, 384), {"block": (8, 128, 128),
                                                     "streams": 2}, BF16),
    ("gather", j_gather, t_gather, (64, 128), {"streams": 2}, F32),
    ("attention", j_attn, t_attn, (4, 256, 256, 64),
     {"kv_groups": 2, "block_q": 64}, F32),
    ("decode", j_dec, t_dec, (4, 2, 8, 256, 64), {"block_kv": 64}, BF16),
    ("paged", j_paged, t_paged, (2, 2, 8, 4, 16, 64), {}, F32),
    ("layer_matmul", j_lmm, t_lmm, (16, 128, 64), {"norm": True}, F32),
    ("layer_swiglu", j_lsw, t_lsw, (16, 128, 64), {}, F32),
    ("chunk_scan", j_scan, t_scan, (4, 128, 16, 32),
     {"chunk": 64, "has_u": True}, F32),
]


def _schedules(prog, opaque):
    out = {"out": prog.out_schedule()}
    for st in prog.streams:
        try:
            out[st.name] = prog.stream_schedule(st.name)
        except opaque:
            out[st.name] = "opaque"
    return out


@pytest.mark.parametrize("case", PROGRAMS, ids=[c[0] for c in PROGRAMS])
def test_build_program_declares_the_reference_schedules(case):
    _, jb, tb, args, kw, (jdt, tdt) = case
    dkey = "kv_dtype" if jb is j_paged else "dtype"
    jp, tp = jb(*args, **kw, **{dkey: jdt}), tb(*args, **kw, **{dkey: tdt})
    assert (tp.name, tp.n_words, tp.out_shape, tp.out_block) == \
        (jp.name, jp.n_words, jp.out_shape, jp.out_block)
    assert dtype_name(tp.out_dtype) == jnp.dtype(jp.out_dtype).name
    assert [(type(i).__name__, i.name) for i in tp.inputs] == \
        [(type(i).__name__, i.name) for i in jp.inputs]
    assert [(s.spec.tile, s.spec.depth, s.spec.streams, s.gather)
            for s in tp.streams] == \
        [(s.spec.tile, s.spec.depth, s.spec.streams, s.gather)
         for s in jp.streams]
    assert [s.shape for s in tp.scratch] == [s.shape for s in jp.scratch]
    assert tp.smem_bytes == jp.vmem_bytes
    assert _schedules(tp, ScheduleOpaqueError) == _schedules(jp, JOpaque)
    jw, tw = jg.program_workload(jp), program_workload(tp)
    for f in ("n_words", "word_bytes", "flops_per_word", "regular",
              "store_bytes_per_word"):
        assert getattr(tw, f) == getattr(jw, f), f


def test_compile_program_launches_the_ops_entry_points():
    """Each declaration bound by compile_program computes what the
    ``repro_torch.ops`` entry point computes (on the CPU both run the
    plain version: the same bits); a program naming no written kernel is
    refused."""
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g)
    a, b = rn(64, 128), rn(128, 256)
    got = compile_program(t_mm(64, 256, 128, block=(8, 128, 128)))(a, b)
    assert torch.equal(got, repro_torch.ops.matmul(a, b))
    tab, idx = rn(96, 128), torch.randint(0, 96, (64,), generator=g).int()
    got = compile_program(t_gather(64, 128))(idx, tab)
    assert torch.equal(got, repro_torch.ops.gather(tab, idx))
    q, k, v = rn(4, 128, 64), rn(2, 128, 64), rn(2, 128, 64)
    got = compile_program(t_attn(4, 128, 128, 64, kv_groups=2,
                                 block_q=64))(q, k, v)
    assert torch.equal(got, repro_torch.ops.attention(q, k, v, kv_groups=2))
    q, kc, vc = rn(2, 2, 4, 64), rn(2, 2, 128, 64), rn(2, 2, 128, 64)
    lens = torch.tensor([77, 128]).int()
    got = compile_program(t_dec(2, 2, 4, 128, 64, block_kv=64))(
        lens, q, kc, vc)
    want = repro_torch.ops.decode_attention(q.view(2, 8, 64), kc, vc, lens,
                                            block_kv=64)
    assert torch.equal(got, want.view(2, 2, 4, 64))
    with pytest.raises(NotImplementedError, match="no hand-written kernel"):
        compile_program(dataclasses.replace(
            t_mm(8, 128, 128, block=(8, 128, 128)), kernel="ff_nothing"))


def test_compile_program_pipe_overrides_keep_one_ring():
    prog = t_mm(64, 128, 128, block=(8, 128, 128))
    a, b = torch.randn(64, 128), torch.randn(128, 128)
    ring = Pipe(tile=(8, 128), depth=3)
    fn = compile_program(prog, pipe_overrides={
        "a": ring, "b": Pipe(tile=(128, 128), depth=3)})
    assert (fn.policy.depth, fn.policy.streams) == (3, 1)
    assert torch.equal(fn(a, b), a @ b)
    with pytest.raises(ValueError, match="one ring"):
        compile_program(prog, pipe_overrides={
            "a": ring, "b": Pipe(tile=(128, 128), depth=2)})
    with pytest.raises(ValueError, match="keep tile"):
        compile_program(prog, pipe_overrides={"a": Pipe(tile=(16, 128))})


# ---------------------------------------------------------------------------
# The toy graph (tests/test_graph.py:36) on both sides
# ---------------------------------------------------------------------------


def _toy(side, block_m=8, prefer="auto"):
    if side == "ref":
        disp = j_gather(64, 128, dtype=jnp.float32, depth=2, streams=1)
        mm = j_mm(64, 128, 128, block=(block_m, 128, 128),
                  dtype=jnp.float32, depth=2, streams=1)
        return jg.StreamGraph("toy", (jg.GraphNode("d", disp),
                                      jg.GraphNode("e", mm)),
                              (jg.GraphEdge("d", "e", "a", prefer=prefer),))
    disp = t_gather(64, 128, dtype=torch.float32, depth=2, streams=1)
    mm = t_mm(64, 128, 128, block=(block_m, 128, 128), dtype=torch.float32,
              depth=2, streams=1)
    return StreamGraph("toy", (GraphNode("d", disp), GraphNode("e", mm)),
                       (GraphEdge("d", "e", "a", prefer=prefer),))


def _toy_inputs():
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((96, 128)).astype(np.float32)
    idx = rng.integers(0, 96, 64).astype(np.int32)
    w = (rng.standard_normal((128, 128)) / math.sqrt(128)).astype(np.float32)
    return idx, tab, w


def _plan_of(compiled):
    return [(e.edge.label, e.mode, e.hbm_bytes_saved)
            for e in compiled.plan.edges]


@pytest.mark.parametrize("block_m", [8, 16])
def test_toy_graph_plan_and_output_match_reference(block_m):
    j = jg.compile_graph(_toy("ref", block_m))
    t = compile_graph(_toy("port", block_m))
    assert _plan_of(t) == _plan_of(j)
    assert [(u.kind, u.out_node) for u in t.units] == \
        [(u.kind, u.out_node) for u in j.units]
    assert t.arg_names == j.arg_names
    idx, tab, w = _toy_inputs()
    want = np.asarray(j(jnp.asarray(idx), jnp.asarray(tab), jnp.asarray(w)))
    got = t(torch.from_numpy(idx), torch.from_numpy(tab),
            torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if block_m == 16:
        assert "mismatched block schedules" in t.plan.edges[0].rationale
    else:
        assert "ff_dispatch_matmul" in t.plan.edges[0].rationale


def test_out_schedule_runs():
    mm = t_mm(256, 256, 256, block=(128, 128, 128))
    sched = mm.out_schedule()
    assert len(sched) == mm.n_words
    assert sched[0] == sched[1] == (0, 0)
    assert sched[2] == sched[3] == (0, 1)


def test_stream_schedule_requires_declaration():
    with pytest.raises(ScheduleOpaqueError):
        t_gather(64, 128).stream_schedule("table")


def test_forced_fusion_of_illegal_edge_raises_plan_error():
    with pytest.raises(PlanError) as ei:
        compile_graph(_toy("port", 16, prefer="fused"))
    assert "mismatched block schedules" in str(ei.value)
    with pytest.raises(JPlanError):
        jg.compile_graph(_toy("ref", 16, prefer="fused"))


def test_check_fusion_reports_geometry():
    e = GraphEdge("d", "e", "a")
    rep = check_fusion(t_gather(64, 128), t_mm(64, 128, 128,
                                               block=(8, 128, 128)), e)
    jrep = jg.check_fusion(j_gather(64, 128),
                           j_mm(64, 128, 128, block=(8, 128, 128)),
                           jg.GraphEdge("d", "e", "a"))
    assert rep.ok and rep.n_blocks == 8 and rep.wpb == 1
    assert rep.ord_seq == tuple(range(8))
    assert rep.__dict__ == jrep.__dict__


@pytest.mark.parametrize("case", [
    # (producer, consumer, edge): legal, mismatched, reshape, k-split
    ("attn_proj", lambda m: (m["attn"](2, 256, 256, 64, block_q=128),
                             m["mm"](512, 256, 64, block=(128, 128, 64))),
     ("attn", "proj", "a", (512, 64))),
    ("attn_proj_bq64", lambda m: (m["attn"](2, 256, 256, 64, block_q=64),
                                  m["mm"](512, 256, 64,
                                          block=(128, 128, 64))),
     ("attn", "proj", "a", (512, 64))),
    ("mm_ksplit", lambda m: (m["mm"](64, 256, 64, block=(8, 128, 64)),
                             m["mm"](64, 128, 256, block=(8, 128, 128))),
     ("p", "c", "a", None)),
    ("dec_gather", lambda m: (m["gather"](2 * 2 * 4 * 32, 64, streams=4),
                              m["paged"](2, 2, 8, 4, 16, 64)),
     ("g", "a", "kv", None)),
    ("layer_chain", lambda m: (m["lmm"](16, 64, 128),
                               m["lsw"](16, 128, 64)),
     ("o", "g", "x", None)),
], ids=lambda c: c if isinstance(c, str) else "")
def test_check_fusion_verdicts_match_reference(case):
    _, make, (src, dst, inp, reshape) = case
    jp, jc = make({"attn": j_attn, "mm": j_mm, "gather": j_gather,
                   "paged": j_paged, "lmm": j_lmm, "lsw": j_lsw})
    tp, tc = make({"attn": t_attn, "mm": t_mm, "gather": t_gather,
                   "paged": t_paged, "lmm": t_lmm, "lsw": t_lsw})
    jr = jg.check_fusion(jp, jc, jg.GraphEdge(src, dst, inp,
                                              reshape=reshape))
    tr = check_fusion(tp, tc, GraphEdge(src, dst, inp, reshape=reshape))
    assert tr.__dict__ == jr.__dict__


# ---------------------------------------------------------------------------
# Graph validation
# ---------------------------------------------------------------------------


def test_cycle_detection():
    disp, mm = t_gather(64, 128), t_mm(64, 128, 128, block=(8, 128, 128))
    with pytest.raises(ValueError, match="cycle"):
        StreamGraph("cyc", (GraphNode("d", disp), GraphNode("e", mm)),
                    (GraphEdge("d", "e", "a"), GraphEdge("e", "d", "table")))


def test_edge_must_feed_a_stream():
    disp, mm = t_gather(64, 128), t_mm(64, 128, 128, block=(8, 128, 128))
    with pytest.raises(ValueError, match="Stream input"):
        StreamGraph("bad", (GraphNode("d", disp), GraphNode("e", mm)),
                    (GraphEdge("d", "e", "nope"),))


def test_input_fed_twice_rejected():
    disp, disp2 = t_gather(64, 128), t_gather(64, 128)
    mm = t_mm(64, 128, 128, block=(8, 128, 128))
    with pytest.raises(ValueError, match="more than one edge"):
        StreamGraph("bad", (GraphNode("d", disp), GraphNode("d2", disp2),
                            GraphNode("e", mm)),
                    (GraphEdge("d", "e", "a"), GraphEdge("d2", "e", "a")))


def test_bad_reshape_rejected():
    disp, mm = t_gather(64, 128), t_mm(64, 128, 128, block=(8, 128, 128))
    with pytest.raises(ValueError, match="element count"):
        StreamGraph("bad", (GraphNode("d", disp), GraphNode("e", mm)),
                    (GraphEdge("d", "e", "a", reshape=(3, 5)),))


def test_topo_order_and_sinks():
    g = TM.build_moe_graph()
    assert [n.name for n in g.topo_order()] == ["dispatch", "expert",
                                                "combine"]
    assert g.sinks() == ("combine",)


# ---------------------------------------------------------------------------
# Shared-memory budget (the port's kernels' footprints)
# ---------------------------------------------------------------------------


def test_smem_split_infeasible_fusion_stages_on_auto():
    """ff_dispatch_matmul needs 67,616 B at a double-buffered ring: a
    64 KiB budget cannot hold it (the reference's own case is 64 KiB of
    its declared VMEM)."""
    compiled = compile_graph(_toy("port"), smem_budget_bytes=64 * 1024)
    (plan,) = compiled.plan.edges
    assert plan.mode == "staged"
    assert "exceeds" in plan.rationale and "budget" in plan.rationale
    idx, tab, w = (torch.from_numpy(x) for x in _toy_inputs())
    np.testing.assert_allclose(compiled(idx, tab, w).numpy(),
                               (tab[idx.long()] @ w).numpy(), atol=1e-4)


def test_smem_split_infeasible_forced_fusion_raises():
    with pytest.raises(PlanError) as ei:
        compile_graph(_toy("port", prefer="fused"),
                      smem_budget_bytes=64 * 1024)
    assert "exceeds" in str(ei.value)
    assert ei.value.rejected


def test_budget_split_evenly_across_nodes():
    compiled = compile_graph(_toy("port"), smem_budget_bytes=1 << 20)
    assert compiled.plan.budgets == {"d": (1 << 20) // 2,
                                     "e": (1 << 20) // 2}


def test_chain_without_a_kernel_stages_with_rationale():
    """matmul -> matmul is legal to fuse (the reference emits one kernel
    for it) but the port has no hand-fused kernel for it: the edge stages
    and says so; prefer="fused" raises."""
    p1 = t_mm(64, 128, 64, block=(8, 128, 64))
    p2 = t_mm(64, 64, 128, block=(8, 64, 128))
    g = StreamGraph("mm2", (GraphNode("p", p1), GraphNode("c", p2)),
                    (GraphEdge("p", "c", "a"),))
    jgr = jg.StreamGraph("mm2", (
        jg.GraphNode("p", j_mm(64, 128, 64, block=(8, 128, 64))),
        jg.GraphNode("c", j_mm(64, 64, 128, block=(8, 64, 128)))),
        (jg.GraphEdge("p", "c", "a"),))
    assert jg.compile_graph(jgr).plan.edges[0].mode == "fused"
    (plan,) = compile_graph(g).plan.edges
    assert plan.mode == "staged"
    assert "no hand-fused kernel" in plan.rationale
    assert "ff_matmul -> ff_matmul" in plan.rationale
    a, w1, w2 = torch.randn(64, 64), torch.randn(64, 128), \
        torch.randn(128, 64)
    torch.testing.assert_close(compile_graph(g)(a, w1, w2), (a @ w1) @ w2)
    with pytest.raises(PlanError, match="no hand-fused kernel"):
        compile_graph(g, prefer="fused")


# ---------------------------------------------------------------------------
# Estimate
# ---------------------------------------------------------------------------


def test_estimate_graph_matches_reference_on_the_same_stages():
    """estimate_graph on the same stages and hardware (TPU_V5E: the
    reference's descriptor, a copy in the port) gives the same numbers."""
    def stages(pm, pipe_cls, fused):
        w = pm.Workload(n_words=64, word_bytes=4096.0, flops_per_word=1e6,
                        store_bytes_per_word=4096.0)
        pipe = pipe_cls(tile=(8, 128), depth=2)
        return (pm.GraphStage("a", w, pipe),
                pm.GraphStage("b", w, pipe, fused_with_prev=fused,
                              saved_load_bytes=64 * 4096.0 if fused else 0,
                              saved_store_bytes=64 * 4096.0 if fused else 0,
                              rationale="" if fused else "why not"))
    for fused in (True, False):
        j = jpm.estimate_graph(stages(jpm, JPipe, fused), jpm.TPU_V5E)
        t = tpm.estimate_graph(stages(tpm, Pipe, fused), tpm.TPU_V5E)
        assert (t.total_s, t.unfused_s, t.hbm_bytes_saved, t.skipped) == \
            (j.total_s, j.unfused_s, j.hbm_bytes_saved, j.skipped)
        if fused:
            assert t.total_s < t.unfused_s


def test_estimate_fused_beats_unfused_and_saves_bytes():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("moe_dispatch_ffn"))
    est = compiled.plan.estimate
    assert est.total_s < est.unfused_s
    assert est.hbm_bytes_saved > 0
    modes = {e.edge: e.mode for e in est.edges}
    assert modes == {"dispatch->expert": "fused",
                     "expert->combine": "staged"}
    assert any("gather" in s for s in est.skipped)


def test_estimate_graph_staged_everything_matches_sum():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("moe_dispatch_ffn"),
                                           prefer="staged")
    est = compiled.plan.estimate
    assert est.hbm_bytes_saved == 0
    assert est.total_s == pytest.approx(est.unfused_s)


# ---------------------------------------------------------------------------
# Identity, workload, mesh localisation
# ---------------------------------------------------------------------------


def test_graph_signature_distinguishes_graphs():
    g1, g2 = _toy("port"), _toy("port", block_m=16)
    assert graph_signature(g1) != graph_signature(g2)
    assert graph_signature(g1) == jg.graph_signature(_toy("ref"))
    w, tile = graph_workload(g1)
    jw, jtile = jg.graph_workload(_toy("ref"))
    assert w.n_words > 0 and tile == jtile == (8, 128)
    assert not w.regular
    assert (w.n_words, w.word_bytes, w.store_bytes_per_word) == \
        (jw.n_words, jw.word_bytes, jw.store_bytes_per_word)


def test_compile_graph_localizes_node_workloads():
    """compile_graph(sharding=...) plans each node against the per-shard
    word schedule, keyed by the mesh (tests/test_sharded_streams.py:182)."""
    g = TL.build_attention_proj_graph()
    planner.plan_cache_clear()
    compile_graph(g, policy=PipePolicy())
    single = {op: p.workload.n_words
              for op, p in planner._LAST_PLAN.items()}
    assert single
    planner.plan_cache_clear()
    compile_graph(g, policy=PipePolicy(),
                  sharding=meshspec.MeshSpec(axes=(("data", 4),)))
    for op, plan in planner._LAST_PLAN.items():
        assert plan.mesh.token == "data4", (op, plan.mesh)
        assert plan.workload.n_words <= -(-single[op] // 4) or \
            plan.workload.n_words == 1


# ---------------------------------------------------------------------------
# The four shipped graphs: plans and outputs against the reference
# ---------------------------------------------------------------------------


def _shipped(name):
    """(reference builder, port builder, shared build keywords, reference
    operands, port operands, tolerance) at small shapes of each shipped
    graph (the reference's interpret mode is slow at its defaults). The
    decode layer's RoPE is the positions (theta 1e4) on the port's side,
    the cos/sin tables made from them on the reference's."""
    rng = np.random.default_rng(0)

    def rn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    spec = JR.get_graph(name)
    if name == "attention_proj":
        kw = dict(bh=1, s=128, d=64, d_out=128)
        ops = (rn(1, 128, 64, scale=0.3), rn(1, 128, 64, scale=0.3),
               rn(1, 128, 64), rn(64, 128, scale=0.125))
        j_ops = t_ops = ops
        builders = (JL.build_attention_proj_graph,
                    TL.build_attention_proj_graph)
    elif name == "moe_dispatch_ffn":
        kw = dict(t_tokens=32, n_dispatch=16, d_model=128, d_ff=128,
                  t_out=16)
        ops = (rng.integers(0, 32, 16).astype(np.int32), rn(32, 128),
               rn(128, 128, scale=128 ** -0.5),
               rng.integers(0, 16, 16).astype(np.int32))
        j_ops = t_ops = ops
        builders = (JM.build_moe_graph, TM.build_moe_graph)
    elif name == "paged_decode_attention":
        kw = dict(b=2, kvh=1, g_pad=8, n_pages=2, page=16, d=64)
        nb = 6
        bt = rng.permutation(nb)[:4].reshape(2, 2).astype(np.int32)
        idx = TP.page_word_indices(torch.from_numpy(bt), page=16,
                                   kv_heads=1, n_blocks=nb).numpy()
        np.testing.assert_array_equal(idx, np.asarray(JP.gather_indices(
            bt, page=16, kv_heads=1, n_blocks=nb)))
        ops = (idx, rn(nb * 2 * 16, 64), np.array([21, 32], np.int32),
               rn(2, 1, 8, 64, scale=0.3))
        j_ops = t_ops = ops
        builders = (JP.build_paged_decode_graph, TP.build_paged_decode_graph)
    else:
        b, d, hd, f, s, bm = 8, 64, 16, 128, 128, 8
        hpad, half = 8 * hd, hd // 2
        kw = dict(b=b, d_model=d, kvh=1, g_pad=8, hd=hd, d_ff=f, s=s)
        lengths = rng.integers(1, s + 1, b).astype(np.int32)
        ang = (lengths - 1).astype(np.float32)[:, None] * (
            np.float32(1e4) ** (-np.arange(half, dtype=np.float32) / half))
        x = rn(b, d, scale=0.3)
        head = (x, rn(d, hpad, scale=d ** -0.5),
                np.broadcast_to(1 + rn(d, scale=0.1), (bm, d)).copy(),
                np.broadcast_to(rn(hpad, scale=0.1), (bm, hpad)).copy())
        tail = (lengths, rn(b, 1, s, hd, scale=0.3), rn(b, 1, s, hd),
                rn(hpad, d, scale=hpad ** -0.5), x,
                rn(d, f, scale=d ** -0.5), rn(d, f, scale=d ** -0.5),
                np.broadcast_to(1 + rn(d, scale=0.1), (bm, d)).copy(),
                rn(f, d, scale=f ** -0.5))
        j_ops = head + (np.cos(ang), np.sin(ang)) + tail
        t_ops = head + (lengths - 1,) + tail
        builders = (JL.build_decode_layer_graph, TL.build_decode_layer_graph)
    return (builders[0], builders[1], kw, tuple(map(jnp.asarray, j_ops)),
            tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in t_ops),
            spec.tol)


GRAPHS = ["moe_dispatch_ffn", "attention_proj", "paged_decode_attention",
          "decode_layer"]


@pytest.mark.parametrize("name", GRAPHS)
def test_shipped_graph_plan_and_output_match_reference(name):
    """The fused plans are the reference's, edge for edge (modes and
    bytes kept off device memory) and launch for launch; the staged plans
    too. The port's fused and staged outputs match the reference's fused
    output (Pallas in interpret mode) within the graph's tolerance."""
    jb, tb, kw, j_ops, t_ops, tol = _shipped(name)
    j = jg.compile_graph(jb(**kw))
    want = np.asarray(j(*j_ops), np.float32)
    for prefer in (None, "staged"):
        t = compile_graph(tb(**kw), prefer=prefer)
        jplan = j if prefer is None else jg.compile_graph(jb(**kw),
                                                          prefer=prefer)
        assert _plan_of(t) == _plan_of(jplan)
        assert [(u.kind, u.out_node) for u in t.units] == \
            [(u.kind, u.out_node) for u in jplan.units]
        np.testing.assert_allclose(t(*t_ops).float().numpy(), want,
                                   atol=tol, rtol=0)


def test_moe_fused_edge_is_single_launch():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("moe_dispatch_ffn"))
    assert [(u.kind, u.out_node, u.launch) for u in compiled.units] == [
        ("fused", "expert", "ff_dispatch_matmul"),
        ("node", "combine", "ff_gather")]
    assert {e.edge.label: e.mode for e in compiled.plan.edges} == {
        "dispatch->expert": "fused", "expert->combine": "staged"}
    assert compiled.report["fused_equals_staged"]


def test_moe_staged_is_three_launches():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("moe_dispatch_ffn"),
                                           prefer="staged")
    assert [u.kind for u in compiled.units] == ["node"] * 3


def test_gather_edge_never_fuses():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("moe_dispatch_ffn"))
    staged = [e for e in compiled.plan.edges if e.mode == "staged"]
    assert len(staged) == 1
    assert "gather" in staged[0].rationale


@pytest.mark.parametrize("name", GRAPHS)
def test_registered_graph_compiles_to_what_its_op_computes(name):
    """At the port's registered shapes, the compiled graph equals the
    op (the graph spec's entry point) and its staged composition bit for
    bit on the CPU, fused and staged."""
    spec = TR.get_graph(name)
    for prefer in (None, "staged"):
        out, ref, err, compiled = TR.run_graph_smoke(spec, prefer=prefer)
        assert err <= spec.tol, (name, prefer, err)
        assert compiled.report["fused_equals_staged"], (name, prefer)
        gen = torch.Generator().manual_seed(0)
        args = spec.make_inputs(gen, torch.device("cpu"))
        assert torch.equal(out, spec.op(*args))


def test_decode_layer_mlp_tail_is_single_launch():
    _, _, err, compiled = TR.run_graph_smoke(TR.get_graph("decode_layer"))
    assert [(u.kind, u.out_node) for u in compiled.units] == [
        ("node", "qproj"), ("node", "attn"), ("fused", "down")]
    assert compiled.units[-1].launch == "ff_layer_mlp_tail"
    modes = {e.edge.label: e.mode for e in compiled.plan.edges}
    assert modes == {"qproj->attn": "staged", "attn->oproj": "staged",
                     "oproj->gateup": "fused", "oproj->down": "fused",
                     "gateup->down": "fused"}
    for e in compiled.plan.edges:
        assert e.rationale, e.edge.label


def test_decode_layer_multi_consumer_edge_ring_serves_residual():
    _, _, _, compiled = TR.run_graph_smoke(TR.get_graph("decode_layer"))
    by_label = {e.edge.label: e for e in compiled.plan.edges}
    assert by_label["oproj->down"].mode == "fused"
    assert "ring" in by_label["oproj->down"].rationale
    saved = {e.edge: e.hbm_bytes_saved for e in compiled.plan.estimate.edges}
    assert saved["oproj->down"] > 0 and saved["oproj->gateup"] > 0


def test_decode_layer_multi_consumer_edges_stage_on_request():
    _, _, err, staged = TR.run_graph_smoke(TR.get_graph("decode_layer"),
                                           prefer="staged")
    assert err <= 5e-4
    assert [u.kind for u in staged.units] == ["node"] * 5
    by_label = {e.edge.label: e for e in staged.plan.edges}
    assert by_label["oproj->gateup"].mode == "staged"
    assert by_label["oproj->down"].mode == "staged"


def test_decode_layer_forced_fusion_lists_every_rejection():
    with pytest.raises(PlanError) as ei:
        TR.run_graph_smoke(TR.get_graph("decode_layer"), prefer="fused")
    msg = str(ei.value)
    assert "qproj->attn" in msg and "attn->oproj" in msg
    assert "BlockIn" in msg and "mismatched block schedules" in msg
    assert len(ei.value.rejected) == 2


# ---------------------------------------------------------------------------
# Epilogues
# ---------------------------------------------------------------------------


def _ep_node(name):
    m, n, k = 32, 128, 64
    return GraphNode("mm", t_lmm(m, n, k), epilogue=Epilogue(name, inputs=(
        BlockIn("res", (8, n), lambda g: (g, 0), dtype=torch.float32),)))


def test_epilogue_matches_plain_reference():
    compiled = compile_graph(StreamGraph("ep", (_ep_node("residual"),), ()))
    g = torch.Generator().manual_seed(7)
    a, w = torch.randn(32, 64, generator=g), torch.randn(64, 128,
                                                         generator=g) / 8
    res = torch.randn(32, 128, generator=g)
    np.testing.assert_allclose(compiled(a, w, res).numpy(),
                               (a @ w + res).numpy(), atol=1e-4)


def test_epilogue_a_kernel_lacks_is_refused():
    with pytest.raises(NotImplementedError, match="epilogue 'gelu'"):
        compile_graph(StreamGraph("ep", (_ep_node("gelu"),), ()))
    node = GraphNode("mm", t_mm(64, 128, 128, block=(8, 128, 128)),
                     epilogue=Epilogue("residual", inputs=(
                         BlockIn("res", (8, 128), lambda g: (g, 0)),)))
    with pytest.raises(NotImplementedError, match="ff_matmul"):
        compile_graph(StreamGraph("ep", (node,), ()))
