"""The port's plan service (``repro_torch.plans``) against the reference's
(``repro.plans``): the same recorded call sites give the same
TrafficProfile JSON, and the same tuned records the same PlanDB JSON,
apart from the namespace; merge semantics; the hardware fingerprint
(``cpu`` without a card); and record -> ``python -m repro_torch.plans
sweep --device cpu`` -> a fresh lookup served from the PlanDB, end to end
on the port's registry kernels.
"""

import os

import numpy as np
import pytest
import torch

import repro.core.pipeline_model as jpm
import repro.core.profiling as jprof
import repro.plans as jplans
import repro_torch.core.pipeline_model as tpm
import repro_torch.core.profiling as tprof
from repro_torch import plans as tplans
from repro_torch.core import autotune
from repro_torch.core.autotune import tuned_cache_clear, tuning_config
from repro_torch.core.program import PipePolicy
from repro_torch.plans import plandb as plandb_lib
from repro_torch.plans import registry as plan_registry
from repro_torch.plans.__main__ import main as plans_main

REC_A = {"op": "ff_synth", "depth": 3, "streams": 2, "tile_kwargs": {},
         "measured_s": 1e-3}
REC_B = {"op": "ff_synth", "depth": 5, "streams": 1, "tile_kwargs": {},
         "measured_s": 2e-3}


@pytest.fixture
def plan_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       os.path.join(tmp_path, "host.json"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_DB", raising=False)
    monkeypatch.delenv("REPRO_TORCH_PLAN_NAMESPACE", raising=False)
    tuned_cache_clear()
    plandb_lib.clear_cache()
    autotune.plan_stats_clear()
    yield tmp_path
    tuned_cache_clear()
    plandb_lib.clear_cache()


def _call_sites(seed):
    """The same call sites built in both packages from one numpy draw."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(4, 12))):
        w = dict(n_words=int(rng.integers(1, 5000)),
                 word_bytes=float(rng.choice([4096.0, 16384.0, 1024.5])),
                 flops_per_word=float(rng.choice([0.0, 1e6])),
                 regular=bool(rng.integers(2)))
        op = str(rng.choice(["ff_attention", "ff_gather",
                             "graph:decode_layer"]))
        site = None if op.startswith("graph") and i % 2 else {
            "bh": int(rng.integers(1, 64)), "s": int(rng.integers(1, 300)),
            "d": 64, "causal": True}
        pol = {"mode": str(rng.choice(["ff", "autotune"])),
               "depth": "auto" if i % 3 else 2, "streams": "auto",
               "stream_options": (1, 2, 4), "interpret": False}
        common = dict(origin=str(rng.choice(["autotune", "planner"])), op=op,
                      tile=(64, 64), dtype=str(rng.choice(["float32",
                                                           "bfloat16"])),
                      hw="tpu-v5e", mesh_axes=(), policy=pol,
                      extra_key=f"skv={i % 3}", site=site,
                      site_dynamic=("bh", "s") if site else ())
        out.append((w, common))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_traffic_profile_json_is_the_references(seed, tmp_path):
    jp, tp = jplans.TrafficProfile(), tplans.TrafficProfile()
    for w, common in _call_sites(seed):
        jp.observe(jprof.CallSite(workload=jpm.Workload(**w), **common))
        tp.observe(tprof.CallSite(workload=tpm.Workload(**w), **common))
    assert tp.to_payload() == jp.to_payload()
    jp.save(tmp_path / "j.json")
    tp.save(tmp_path / "t.json")
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    back = tplans.TrafficProfile.load(tmp_path / "t.json")
    assert back.to_payload() == tp.to_payload()
    assert tp.total_count == jp.total_count and len(tp) == len(jp)


@pytest.mark.parametrize("v", [0, 1, 2, 3, 5, 17, 64, 65, 1000])
def test_bucketing_is_the_references(v):
    assert tplans.bucket_value(v) == jplans.bucket_value(v)
    site = {"s": v, "d": 64, "causal": True}
    assert tplans.bucket_site(site, ("s",)) == jplans.bucket_site(
        site, ("s",))


def test_plandb_json_is_the_references_apart_from_namespace(tmp_path):
    recs = [dict(REC_A, workload={"n_words": i}) for i in range(5)]
    jdb, tdb = jplans.PlanDB(), tplans.PlanDB()
    for i, rec in enumerate(recs):
        jdb.put("tpu.tpu-v5e", f"k{i}", rec, tuned_at=float(i))
        tdb.put("cuda.nvidia-h100-80gb-hbm3", f"k{i}", rec,
                tuned_at=float(i))
    jpay, tpay = jdb.to_payload(), tdb.to_payload()
    assert jpay["format"] == tpay["format"]
    assert jpay["plan_format"] == tpay["plan_format"]
    assert list(jpay["namespaces"].values()) == \
        list(tpay["namespaces"].values())
    assert tplans.content_hash(REC_A) == jplans.content_hash(REC_A)
    tdb.save(tmp_path / "db.json")
    assert tplans.PlanDB.load(tmp_path / "db.json").to_payload() == tpay


def test_merge_newer_wins_and_is_reported():
    a, b = tplans.PlanDB(), tplans.PlanDB()
    a.put("ns", "k", REC_A, tuned_at=1.0)
    b.put("ns", "k", REC_B, tuned_at=2.0)
    b.put("other", "k2", REC_A, tuned_at=1.0)
    report = a.merge(b)
    assert (report.replaced, report.added, len(report.conflicts)) == (1, 1, 1)
    assert a.get("ns", "k")["depth"] == 5
    with pytest.raises(tplans.PlanDBError):
        a.merge(tplans.PlanDB(plan_format=99))


def test_fingerprint_without_a_card_is_cpu(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PLAN_NAMESPACE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fp = plan_registry.hardware_fingerprint()
    assert fp == {"platform": "cpu", "device_kind": "cpu",
                  "device_count": 1}
    assert plan_registry.plan_namespace(fp) == "cpu.cpu"
    monkeypatch.setenv("REPRO_TORCH_PLAN_NAMESPACE", "mine")
    assert plan_registry.plan_namespace(fp) == "mine"
    gpu = {"platform": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
           "capability": "9.0", "device_count": 1}
    monkeypatch.delenv("REPRO_TORCH_PLAN_NAMESPACE")
    assert plan_registry.plan_namespace(gpu) == \
        "cuda.nvidia-h100-80gb-hbm3"


def test_corrupt_db_reads_as_empty_for_serving(plan_env):
    path = plan_env / "bad.json"
    path.write_text("{nope")
    with pytest.warns(RuntimeWarning, match="unusable PlanDB"):
        assert plandb_lib.lookup("k", path=str(path)) is None
    assert plandb_lib.prewarm(str(path))["usable"] is False
    with pytest.raises(tplans.PlanDBError):
        tplans.PlanDB.load(str(path))


def test_record_sweep_lookup_end_to_end(plan_env, capsys):
    """Record a few real call sites, sweep them on the CPU through the
    CLI, then a fresh process's measured lookup is a PlanDB hit."""
    from repro_torch import ops
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, 32, generator=gen)
    kv = torch.randn(2, 64, 32, generator=gen)
    tab = torch.randn(64, 32, generator=gen)
    idx = torch.randint(0, 64, (24,), generator=gen)
    prof_path = str(plan_env / "traffic.json")
    with tplans.record_traffic(prof_path) as prof:
        ops.attention(q, kv, kv, kv_groups=2)
        ops.gather(tab, idx)
        ops.gather(tab, idx)
    assert prof.total_count == 3 and len(prof) == 2
    db_path = str(plan_env / "db.json")
    rc = plans_main(["sweep", "--profile", prof_path, "--db", db_path,
                     "--device", "cpu", "--iters", "1", "--top-k", "2",
                     "--scratch-cache", str(plan_env / "scratch.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tuned_buckets" in out and f"wrote {db_path}" in out
    db = tplans.PlanDB.load(db_path)
    ns = plan_registry.plan_namespace()
    assert db.stats()["records"] == 2 and ns in db.namespaces
    # a fresh process: cold caches, the DB shipped
    tuned_cache_clear()
    plandb_lib.clear_cache()
    autotune.plan_stats_clear()
    pol = PipePolicy(mode="autotune")
    with tuning_config(plan_db=db_path):
        ops.attention(q, kv, kv, kv_groups=2, policy=pol)
        ops.gather(tab, idx, policy=pol)
    stats = autotune.plan_stats_snapshot()
    assert stats["plandb"] == 2 and stats.get("measured", 0) == 0
    assert plans_main(["show", db_path]) == 0
    assert plans_main(["show", prof_path]) == 0
    merged = str(plan_env / "merged.json")
    assert plans_main(["merge", "--out", merged, db_path, db_path]) == 0
    assert tplans.PlanDB.load(merged).stats()["records"] == 2


def test_sweep_refuses_cuda_without_a_card(plan_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplans.sweep_profile(tplans.TrafficProfile(), device="cuda")


def test_planner_origin_records_are_suppressed_inside_resolve_call():
    seen = []
    prev = tprof.set_recorder(seen.append)
    try:
        from repro_torch import ops
        ops.matmul(torch.ones(8, 8), torch.ones(8, 8))
    finally:
        tprof.set_recorder(prev)
    assert [cs.origin for cs in seen] == ["autotune"]
    assert seen[0].op == "ff_matmul" and seen[0].hw == "h100-sxm"
    assert seen[0].policy["interpret"] is False


KERNELS = ("ff_attention", "ff_chunk_scan", "ff_decode_attention",
           "ff_gather", "ff_matmul")
GRAPHS = ("attention_proj", "decode_layer", "moe_dispatch_ffn",
          "paged_decode_attention")


def test_registry_names_are_the_references():
    from repro.kernels import registry as jreg
    from repro_torch.kernels import registry as treg
    assert treg.kernel_names() == KERNELS == jreg.kernel_names()
    assert treg.graph_names() == GRAPHS == jreg.graph_names()
    assert {s.alias for s in treg.all_kernels()} == {
        s.alias for s in jreg.all_kernels()}


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("mode", ["ff", "baseline", "autotune"])
def test_registry_smoke_every_kernel(name, mode, plan_env):
    from repro_torch.kernels import registry as treg
    spec = treg.get_kernel(name)
    out, ref, err = treg.run_smoke(spec, policy=PipePolicy(mode=mode))
    assert out.shape == ref.shape and err <= spec.tol
    w, tile = spec.workload(**spec.bench_kwargs)
    cost = spec.cost(**spec.bench_kwargs)
    assert w.n_words > 0 and len(tile) == 2
    assert cost.hbm_bytes > 0 and cost.flops >= 0


@pytest.mark.parametrize("name", GRAPHS)
def test_registry_graphs_run_against_their_plain_version(name):
    from repro_torch.kernels import registry as treg
    spec = treg.get_graph(name)
    args = spec.make_inputs(torch.Generator().manual_seed(1),
                            torch.device("cpu"))
    out = treg.run_graph(spec, args)
    ref = treg.run_graph(spec, args, policy=PipePolicy(mode="ref"))
    assert (out.float() - spec.ref(*args).float()).abs().max() <= spec.tol
    assert torch.equal(ref, spec.ref(*args))
    if spec.unfused is not None:
        assert (spec.unfused(*args).float() - out.float()).abs().max() \
            <= spec.tol
