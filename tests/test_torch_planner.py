"""The port's pipe model and planner (``repro_torch.core.pipe``,
``pipeline_model``, ``planner``) against the reference's
(``repro.core``) on the same inputs.

The model and the planner are pure arithmetic, so the port must give the
reference's numbers *exactly* on the reference's two hardware models
(``TPU_V5E``, ``ARRIA_CX``), for hypothesis-drawn workloads and for
seeded numpy draws (which run wherever hypothesis is missing). The only
difference allowed is a word: the port's budget is shared memory, so a
rejection line says "smem" where the reference's says "vmem" (normalized
below), and its estimate's field is ``smem_bytes``. Both sides are given
the same budget explicitly (the port's default is one block's 227 KB,
the reference's 96 MB of VMEM).

The port's own kernels' workloads are pinned here too: equal to the
reference's where the port streams the same word (gather rows, the scan's
chunks, decode tiles at ``block_kv`` == the port's word, non-causal
attention at 64-row tiles, the product at the port's tile), and by their
own count where the word differs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core.pipe as jpipe
import repro.core.pipeline_model as jpm
import repro.core.planner as jplanner
import repro_torch.core.pipe as tpipe
import repro_torch.core.pipeline_model as tpm
import repro_torch.core.planner as tplanner
from repro_torch.core.program import PipePolicy

BUDGET = 96 * 1024 * 1024
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HWS = {"tpu-v5e": (jpm.TPU_V5E, tpm.TPU_V5E),
       "arria": (jpm.ARRIA_CX, tpm.ARRIA_CX)}


def _wl(mod, **kw):
    return mod.Workload(**kw)


def _est_equal(j, t):
    assert (j.total_s, j.t_mem_word_s, j.t_comp_word_s, j.achieved_bw,
            j.bottleneck, j.vmem_bytes) == (
        t.total_s, t.t_mem_word_s, t.t_comp_word_s, t.achieved_bw,
        t.bottleneck, t.smem_bytes)


def _plan_equal(j, t):
    norm = (lambda x: x.replace("smem", "vmem"))
    assert (j.pipe.tile, j.pipe.depth, j.pipe.streams, j.consumers,
            j.predicted_s, j.predicted_bw) == (
        t.pipe.tile, t.pipe.depth, t.pipe.streams, t.consumers,
        t.predicted_s, t.predicted_bw)
    assert j.rationale == norm(t.rationale)
    assert j.skipped == tuple(norm(x) for x in t.skipped)
    assert dataclasses.asdict(j.workload) == dataclasses.asdict(t.workload)


def _check_point(w, hw, tile, dtype, depth, streams, options, cap):
    jw, tw = _wl(jpm, **w), _wl(tpm, **w)
    jhw, thw = HWS[hw]
    jdt, tdt = _DT[dtype]
    _est_equal(jpm.estimate_baseline(jw, jhw), tpm.estimate_baseline(tw, thw))
    if tile[0] % streams == 0:
        jp = jpipe.Pipe(tile=tile, dtype=jdt, depth=depth, streams=streams)
        tp = tpipe.Pipe(tile=tile, dtype=tdt, depth=depth, streams=streams)
        assert jp.vmem_bytes == tp.smem_bytes
        _est_equal(jpm.estimate_feedforward(jw, jhw, jp),
                   tpm.estimate_feedforward(tw, thw, tp))
        assert jpm.speedup(jw, jhw, jp) == tpm.speedup(tw, thw, tp)
    _plan_equal(
        jplanner.plan_pipe(jw, tile, jdt, jhw, stream_options=options,
                           depth_cap=cap, vmem_budget_bytes=BUDGET),
        tplanner.plan_pipe(tw, tile, tdt, thw, stream_options=options,
                           depth_cap=cap, smem_budget_bytes=BUDGET))


workloads = st.fixed_dictionaries({
    "n_words": st.integers(1, 1 << 20),
    "word_bytes": st.floats(8.0, 4e6),
    "flops_per_word": st.floats(0.0, 1e9),
    "regular": st.booleans(),
    "divergence": st.floats(0.0, 2.0),
    "dlcd_cycles": st.floats(0.0, 1e4),
    "false_mlcd_ii": st.floats(0.0, 500.0),
    "store_bytes_per_word": st.floats(0.0, 1e6),
})


@settings(max_examples=200, deadline=None)
@given(w=workloads, hw=st.sampled_from(sorted(HWS)),
       rows=st.sampled_from([8, 16, 64, 128, 256]),
       cols=st.sampled_from([8, 64, 128, 512]),
       dtype=st.sampled_from(sorted(_DT)), depth=st.integers(1, 17),
       streams=st.sampled_from([1, 2, 4, 8]),
       options=st.sampled_from([(1, 2, 4), (1, 2), (1,), (1, 2, 3, 4)]),
       cap=st.integers(2, 17))
def test_model_and_plan_equal_the_reference_hypothesis(
        w, hw, rows, cols, dtype, depth, streams, options, cap):
    _check_point(w, hw, (rows, cols), dtype, depth, streams, options, cap)


@pytest.mark.parametrize("seed", range(24))
def test_model_and_plan_equal_the_reference_numpy(seed):
    rng = np.random.default_rng(seed)
    w = {"n_words": int(rng.integers(1, 1 << 20)),
         "word_bytes": float(rng.uniform(8, 4e6)),
         "flops_per_word": float(rng.choice([0.0, rng.uniform(0, 1e9)])),
         "regular": bool(rng.integers(2)),
         "divergence": float(rng.choice([0.0, rng.uniform(0, 2)])),
         "dlcd_cycles": float(rng.choice([0.0, rng.uniform(0, 1e4)])),
         "false_mlcd_ii": float(rng.choice([0.0, rng.uniform(0, 500)])),
         "store_bytes_per_word": float(rng.uniform(0, 1e6))}
    _check_point(w, sorted(HWS)[seed % 2],
                 (int(rng.choice([8, 64, 128, 256])),
                  int(rng.choice([8, 128, 512]))),
                 sorted(_DT)[seed % 3 % 2], int(rng.integers(1, 17)),
                 int(rng.choice([1, 2, 4])), (1, 2, 4),
                 int(rng.integers(2, 18)))


@pytest.mark.parametrize("hw", sorted(HWS))
def test_graph_estimate_equals_the_reference(hw):
    jhw, thw = HWS[hw]
    rng = np.random.default_rng(7)
    stages = []
    for mod, pipe_mod, dt in ((jpm, jpipe, jnp.float32),
                              (tpm, tpipe, torch.float32)):
        rs = np.random.default_rng(7)
        st_ = []
        for i in range(4):
            w = mod.Workload(
                n_words=int(rs.integers(64, 4096)),
                word_bytes=float(rs.uniform(1e3, 1e5)),
                flops_per_word=float(rs.uniform(0, 1e7)),
                regular=bool(i % 2),
                store_bytes_per_word=float(rs.uniform(0, 1e4)))
            st_.append(mod.GraphStage(
                name=f"s{i}", workload=w,
                pipe=pipe_mod.Pipe(tile=(8, 128), dtype=dt, depth=2 + i % 2,
                                   streams=1),
                fused_with_prev=i in (1, 3),
                saved_load_bytes=float(rs.uniform(0, 1e6)),
                saved_store_bytes=float(rs.uniform(0, 1e6)),
                rationale=f"edge {i}"))
        stages.append(tuple(st_))
    del rng
    j = jpm.estimate_graph(stages[0], jhw)
    t = tpm.estimate_graph(stages[1], thw)
    assert (j.total_s, j.unfused_s, j.hbm_bytes_saved, j.skipped) == (
        t.total_s, t.unfused_s, t.hbm_bytes_saved, t.skipped)
    for (jn, je), (tn, te) in zip(j.per_stage, t.per_stage):
        assert jn == tn
        _est_equal(je, te)
    assert [dataclasses.astuple(e) for e in j.edges] == \
        [dataclasses.astuple(e) for e in t.edges]


def test_required_depth_and_budget_equal_the_reference():
    for lat in (0.0, 1e-9, 14.3e-9, 2e-6):
        for svc in (0.0, 1e-9, 5e-9, 1e-6):
            for cap in (2, 4, 8, 17):
                assert jpipe.required_depth(lat, svc, cap) == \
                    tpipe.required_depth(lat, svc, cap)
    assert tpipe.DEFAULT_SMEM_BUDGET_BYTES == 232448
    big = tpipe.Pipe(tile=(64, 1024), dtype=torch.float32, depth=1)
    assert big.smem_bytes == 262144
    assert not tpipe.smem_budget_ok([big])
    assert tpipe.smem_budget_ok([big.with_depth(1).with_streams(2)],
                                budget_bytes=262144)


def test_pipe_has_no_sublane_granule():
    """Shared memory has no (8, 128) tiling: a 4-column word is a legal
    pipe in the port (the reference's TPU pipe refuses it)."""
    assert tpipe.Pipe(tile=(16, 4), dtype=torch.bfloat16).word_bytes == 128
    with pytest.raises(ValueError):
        jpipe.Pipe(tile=(16, 4), dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.Pipe(tile=(6, 4), streams=4)


def test_h100_descriptor():
    h = tpm.H100_SXM
    assert (h.name, h.hbm_bw, h.flops, h.clock_hz) == (
        "h100-sxm", 3.35e12, 989e12, 1.98e9)
    assert 0 < h.irregular_eff <= 1 and 0 < h.stream_bw_frac <= 1
    assert h.dma_latency_s > 0 and h.max_streams >= 1
    # the port plans for its card by default
    assert PipePolicy().hw is h


def test_plan_error_names_the_budget():
    w = tpm.Workload(n_words=8, word_bytes=4096.0, flops_per_word=0.0)
    with pytest.raises(tplanner.PlanError) as ei:
        tplanner.plan_pipe(w, (128, 128), torch.float32,
                           smem_budget_bytes=64)
    assert ei.value.smem_budget_bytes == 64
    assert ei.value.rejected and all("smem" in r for r in ei.value.rejected)
    assert "shared-memory" in str(ei.value)


def test_plan_cache_hits_last_plan_and_generation():
    w = tpm.Workload(n_words=64, word_bytes=16384.0, flops_per_word=1e6)
    gen = tplanner.generation()
    tplanner.plan_cache_clear()
    assert tplanner.generation() == gen + 1
    p1 = tplanner.planned_pipe("t_op", w, (64, 64), torch.bfloat16,
                               depth_cap=5)
    p2 = tplanner.planned_pipe("t_op", w, (64, 64), "bfloat16", depth_cap=5)
    info = tplanner.plan_cache_info()
    assert p1 == p2 and (info.hits, info.misses) == (1, 1)
    assert tplanner.last_plan("t_op") is p2
    assert p1.pipe.depth <= 5
    tplanner.plan_cache_clear()
    assert tplanner.last_plan("t_op") is None


@pytest.mark.parametrize("mode", ["ff", "baseline", "autotune"])
def test_resolve_policy_caps_depth_and_streams(mode):
    # a word whose copy latency wants a deep ring on the port's card
    w = tpm.Workload(n_words=4096, word_bytes=1024.0, flops_per_word=0.0,
                     regular=False)
    pol = PipePolicy(mode=mode)
    d, s = tplanner.resolve_policy("t_cap", pol, workload=w, tile=(8, 64),
                                   dtype=torch.float32, depth_cap=3,
                                   stream_options=(1, 2))
    assert s in (1, 2)
    assert d == (1 if mode == "baseline" else 3)
    d, s = tplanner.resolve_policy("t_cap", pol.replace(depth=7, streams=4),
                                   workload=w, tile=(8, 64),
                                   dtype=torch.float32, depth_cap=3)
    assert (d, s) == (1 if mode == "baseline" else 7, 4)   # ints pass


def test_split_graph_budget():
    assert tplanner.split_graph_budget(["a", "b", "c"]) == {
        n: 232448 // 3 for n in "abc"}
    assert tplanner.split_graph_budget([]) == {}


# ---------------------------------------------------------------------------
# the port's kernels' workloads, pinned
# ---------------------------------------------------------------------------


def _asdict(w):
    return dataclasses.asdict(w)


@pytest.mark.parametrize("n,cols,dtype", [(52, 128, "float32"),
                                          (1 << 20, 512, "float32"),
                                          (1024, 1024, "bfloat16"),
                                          (0, 64, "bfloat16")])
def test_gather_workload_is_the_reference(n, cols, dtype):
    from repro.kernels.ff_gather.ops import gather_workload as jw
    from repro_torch.kernels.ff_gather.ops import gather_workload as tw
    a, ta = jw(n, cols, dtype=_DT[dtype][0])
    b, tb = tw(n, cols, dtype=_DT[dtype][1])
    assert _asdict(a) == _asdict(b) and ta == tb


@pytest.mark.parametrize("bh,s,n,p,chunk", [(2, 128, 16, 32, 64),
                                            (256, 256, 64, 64, 64),
                                            (320, 256, 64, 64, 256),
                                            (3, 100, 32, 48, 32)])
def test_chunk_scan_workload_is_the_reference(bh, s, n, p, chunk):
    from repro.kernels.ff_chunk_scan.ops import chunk_scan_workload as jw
    from repro_torch.kernels.ff_chunk_scan.ops import \
        chunk_scan_workload as tw
    a, ta = jw(bh, s, n, p, chunk=chunk, dtype=jnp.bfloat16)
    b, tb = tw(bh, s, n, p, chunk=chunk, dtype=torch.bfloat16)
    assert _asdict(a) == _asdict(b) and ta == tb


@pytest.mark.parametrize("b,h,kvh,s,d,dtype", [
    (4, 16, 16, 48 * 4, 64, "bfloat16"), (4, 14, 2, 256, 64, "float32"),
    (2, 48, 4, 512, 128, "bfloat16"), (1, 8, 8, 64, 256, "bfloat16")])
def test_decode_workload_is_the_reference_at_its_word(b, h, kvh, s, d, dtype):
    """The port's word is R cache rows (_word_rows); at block_kv == R the
    two workloads are one."""
    from repro.kernels.ff_decode_attention.ops import \
        decode_attention_workload as jw
    from repro_torch.kernels.ff_decode_attention import ops as D
    rows = D._word_rows(d, _DT[dtype][1])
    a, ta = jw(b, h, kvh, s, d, block_kv=rows, dtype=_DT[dtype][0])
    w, tb = D.decode_attention_workload(b, h, kvh, s, d,
                                        dtype=_DT[dtype][1])
    assert _asdict(a) == _asdict(w) and ta == tb
    # the serve page (16) is not the port's word at head dim 64 in bf16
    if d == 64 and dtype == "bfloat16":
        a16, _ = jw(b, h, kvh, s, d, block_kv=16, dtype=_DT[dtype][0])
        assert a16.n_words == 4 * w.n_words


@pytest.mark.parametrize("bh,s,d", [(2, 192, 64), (64, 256, 64),
                                    (6, 128, 128)])
def test_attention_workload(bh, s, d):
    """Non-causal at the port's 64-row bf16 tiles equals the reference at
    64 x 64 blocks; causal counts only the live tiles the port's kernel
    streams (the reference counts every pair and halves the flops)."""
    from repro.kernels.ff_attention.ops import attention_workload as jw
    from repro_torch.kernels.ff_attention.ops import \
        attention_workload as tw
    a, ta = jw(bh, s, d, causal=False, block_q=64, block_kv=64,
               dtype=jnp.bfloat16)
    b, tb = tw(bh, s, d, causal=False, dtype=torch.bfloat16)
    assert _asdict(a) == _asdict(b) and ta == tb
    c, _ = tw(bh, s, d, causal=True, dtype=torch.bfloat16)
    nt = -(-s // 64)
    assert c.n_words == bh * nt * (nt + 1) // 2
    assert c.flops_per_word == b.flops_per_word
    assert c.store_bytes_per_word * c.n_words == pytest.approx(
        bh * s * d * 2)


@pytest.mark.parametrize("m,n,k", [(192, 160, 136), (4096, 4096, 4096),
                                   (64, 1408, 2048)])
def test_matmul_workload_at_the_ports_tile(m, n, k):
    from repro.kernels.ff_matmul.ops import matmul_workload as jw
    from repro_torch.kernels.ff_matmul.ops import matmul_workload as tw
    a, ta = jw(m, n, k, block=(128, 128, 64), dtype=jnp.bfloat16)
    b, tb = tw(m, n, k, dtype=torch.bfloat16)
    assert _asdict(a) == _asdict(b) and ta == tb
    a, ta = jw(m, n, k, block=(128, 128, 32), dtype=jnp.float32)
    b, tb = tw(m, n, k, dtype=torch.float32)
    assert _asdict(a) == _asdict(b) and ta == tb


def test_ff_layer_workload():
    """The decode layer's products stream 16 KB weight stages: 128 rows of
    a 64-column tile in bf16 (64 for SwiGLU, which carries wg and wu)."""
    from repro_torch.kernels.ff_layer.ops import (ff_layer_workload,
                                                  mlp_tail_nodes)
    w, tile = ff_layer_workload(4, 1024, 1024, dtype=torch.bfloat16)
    assert tile == (128, 64) and w.word_bytes == 16384
    assert w.n_words == 16 * 8 and w.flops_per_word == 2 * 4 * 128 * 64
    g, tile = ff_layer_workload(4, 1024, 2816, dtype=torch.bfloat16,
                                gated=True)
    assert tile == (64, 64) and g.n_words == 44 * 16
    names = [n for n, _, _ in mlp_tail_nodes(4, 1024, 1024, 2816)]
    assert names == ["oproj", "gateup", "down"]


@pytest.mark.parametrize("case", ["scan_f32_chunk256", "gather_wide_rows",
                                  "attention_hd256"])
def test_kernel_cap_replaces_the_tile_budget(case):
    """The planning tile is the reference's word, which can be larger than
    any ring stage the port's kernel holds (a f32 chunk of 256 x 128, a
    30001-column gather row cut into slabs): the kernel's own deepest ring
    bounds the plan, and the call resolves."""
    from repro_torch import ops
    from repro_torch.core import planner as P
    g = torch.Generator().manual_seed(0)
    if case == "scan_f32_chunk256":
        x = torch.randn(2, 256, 128, generator=g)
        ops.chunk_scan(x, x, x, -x.abs(), chunk=256)
        op = "ff_chunk_scan"
    elif case == "gather_wide_rows":
        ops.gather(torch.randn(40, 30001, generator=g),
                   torch.randint(0, 40, (37,), generator=g))
        op = "ff_gather"
    else:
        q = torch.randn(2, 32, 256, generator=g, dtype=torch.float32)
        ops.attention(q, q, q)
        op = "ff_attention"
    plan = P.last_plan(op)
    assert plan is not None and plan.pipe.depth >= 2


@pytest.mark.parametrize("b,h,kvh,n_pages,page,d,dtype", [
    (4, 16, 16, 3, 16, 64, "bfloat16"), (4, 16, 16, 256, 16, 64, "bfloat16"),
    (2, 14, 2, 8, 16, 64, "float32"), (2, 48, 4, 4, 32, 128, "bfloat16")])
def test_paged_decode_workload_is_the_decode_over_its_rows(
        b, h, kvh, n_pages, page, d, dtype):
    """The paged graph is one launch that reads the pages through the
    table in the decode's own R-row words: its workload is the contiguous
    decode's over ``n_pages * page`` rows (regular, the K tile of a word),
    not the reference's gather node of 8-row irregular words beside it."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ff_decode_attention import ops as D
    from repro_torch.runtime.paged_kv import paged_decode_nodes
    dt = _DT[dtype][1]
    nodes = paged_decode_nodes(b, h, kvh, n_pages, page, d, dtype=dt)
    want, tile = D.decode_attention_workload(b, h, kvh, n_pages * page, d,
                                             dtype=dt)
    assert [name for name, _, _ in nodes] == ["decode"]
    got, got_tile = autotune.graph_workload(nodes)
    assert _asdict(got) == _asdict(want) and got_tile == tile
    assert got.regular and tile == (D._word_rows(d, dt), d)


def test_decode_depth_keeps_the_grid_in_one_wave():
    """Decode attention's ring runs a block at a time, about 4 blocks an
    SM: at ``decode_long`` (4 x 16 KV heads, 4096 rows, head dim 64, bf16)
    the grid is 576 blocks, 5 an SM on 132 SMs; depth 2 leaves room for 6,
    depth 3 for 4, so the planned depth is 2 for the contiguous and the
    paged launch alike. Grids within one block an SM keep the deepest
    ring as their cap and plan as before."""
    from repro_torch.kernels.ff_decode_attention import ops as D
    from repro_torch.runtime.paged_kv import paged_decode_nodes
    bf = torch.bfloat16
    assert [D.resident_blocks(x, 64, bf) for x in (1, 2, 3, 4)] == [
        12, 6, 4, 3]
    assert D._plan(4, 16, 64, bf, 4096, 132).split == 9
    assert D.wave_depth(4, 16, 64, bf, 4096, 132) == 2
    for s in (48, 240):
        assert D.wave_depth(4, 16, 64, bf, s, 132) == D.max_depth(64, bf)
    q = torch.zeros(4, 16, 64, dtype=bf)
    pol = PipePolicy()
    assert pol.hw.sms == 132
    for s, want in ((4096, 2), (240, None)):
        contiguous = D.resolve_pipe("ff_decode_attention", pol, q, 16, s, 64,
                                    16, None, extra_key="block_kv=16")
        paged = D.resolve_pipe(
            "paged_decode_attention", pol, q, 16, s, 64, 32, None,
            nodes=paged_decode_nodes(4, 16, 16, s // 16, 16, 64, dtype=bf))
        assert paged == contiguous
        if want is not None:
            assert contiguous == (want, 1)
    # explicit depths pass the cap: the sweep times every ring that fits
    assert D.resolve_pipe("ff_decode_attention", pol.replace(depth=6), q,
                          16, 4096, 64, 16, None)[0] == 6
