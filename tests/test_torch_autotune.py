"""The port's measured lookup chain (``repro_torch.core.autotune``):
memory -> per-host disk cache -> release PlanDB -> measure and persist ->
analytic fallback, mirroring the reference's ``tests/test_autotune.py``
with a faked ``measure`` and ``tmp_path`` caches, plus what is the port's
own: a measured policy inside a compiled step's capture never measures,
the kernels' depth caps bound every candidate, and the plan keys are the
reference's for the same inputs.
"""

import json
import os
import warnings

import jax.numpy as jnp
import pytest
import torch

import repro.core.autotune as jautotune
import repro.core.pipeline_model as jpm
from repro.core.program import PipePolicy as JPolicy
from repro_torch import obs, ops
from repro_torch.core import autotune, planner
from repro_torch.core.autotune import (PLAN_FORMAT_VERSION, resolve_call,
                                       tuned_cache_clear, tuning_config)
from repro_torch.core.pipeline_model import TPU_V5E, Workload
from repro_torch.core.program import PipePolicy
from repro_torch.launch import steps as t_steps

W_REGULAR = Workload(n_words=512, word_bytes=128 * 128 * 4.0,
                     flops_per_word=2.0 * 128 * 128 * 128, regular=True)
TILE = (128, 128)


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """Point the persistent plan cache at a tmpdir and start cold."""
    path = os.path.join(tmp_path, "plans.json")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", path)
    monkeypatch.delenv("REPRO_TORCH_PLAN_DB", raising=False)
    tuned_cache_clear()
    autotune.plan_stats_clear()
    yield path
    tuned_cache_clear()


def _synthetic_runner(best=(3, 2)):
    def runner(tile_kwargs, depth, streams):
        cost = abs(depth - best[0]) + abs(streams - best[1])
        return lambda: float(cost)
    return runner


def _fake_measure(monkeypatch):
    def measure(fn, *, warmup=1, iters=3):
        return 1e-3 * (1.0 + float(fn()))
    monkeypatch.setattr(autotune, "measure", measure)


def _resolve(policy=None, runner="default", **kw):
    policy = policy or PipePolicy(mode="autotune")
    if runner == "default":
        runner = _synthetic_runner()
    return resolve_call(
        "ff_synth", policy, workload=W_REGULAR, tile=TILE,
        dtype=torch.float32,
        workload_fn=lambda tk: (W_REGULAR, TILE), runner=runner, **kw)


def test_tuned_plan_is_measured_and_persisted(plan_cache, monkeypatch):
    _fake_measure(monkeypatch)
    choice = _resolve()
    assert choice.source == "measured"
    assert (choice.depth, choice.streams) == (3, 2)
    plans = json.load(open(plan_cache))
    assert plans["format"] == PLAN_FORMAT_VERSION
    (rec,) = plans["plans"].values()
    assert (rec["depth"], rec["streams"], rec["hw"]) == (3, 2, "h100-sxm")
    assert rec["measured_s"] <= rec["analytic"]["measured_s"]


def test_disk_cache_roundtrip_without_remeasuring(plan_cache, monkeypatch):
    _fake_measure(monkeypatch)
    tuned = _resolve()
    tuned_cache_clear()

    def exploding(*a, **k):
        raise AssertionError("must not re-measure on a cache hit")

    monkeypatch.setattr(autotune, "measure", exploding)
    again = _resolve(runner=exploding)
    assert again.source == "disk"
    assert (again.depth, again.streams) == (tuned.depth, tuned.streams)
    mem = _resolve(runner=exploding)
    assert (mem.source, mem.origin) == ("memory", "disk")


def test_corrupt_cache_falls_back_to_analytic_with_warning(plan_cache):
    with open(plan_cache, "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt plan cache"):
        choice = _resolve(runner=None)
    assert choice.source == "analytic-fallback"
    plan = planner.plan_pipe(W_REGULAR, TILE, torch.float32)
    assert (choice.depth, choice.streams) == (plan.pipe.depth,
                                              plan.pipe.streams)


def test_unmeasurable_call_site_warns_and_uses_analytic(plan_cache):
    autotune._warned_fallback_ops.clear()
    with pytest.warns(RuntimeWarning, match="not measurable"):
        choice = _resolve(runner=None)
    assert choice.source == "analytic-fallback"
    assert not os.path.exists(plan_cache)


def test_analytic_policies_bypass_the_tuner(plan_cache):
    assert _resolve(policy=PipePolicy()).source == "analytic"
    assert _resolve(policy=PipePolicy(mode="baseline")).depth == 1
    assert not os.path.exists(plan_cache)


def test_pinned_ints_survive_tuning(plan_cache, monkeypatch):
    _fake_measure(monkeypatch)
    choice = _resolve(policy=PipePolicy(mode="autotune", streams=1))
    assert (choice.streams, choice.depth) == (1, 3)


def test_auto_fields_stay_planner_sized_under_measured(plan_cache,
                                                       monkeypatch):
    def runner(tile_kwargs, depth, streams):
        return lambda: float(abs(depth - 3) + abs(streams - 4))

    _fake_measure(monkeypatch)
    choice = _resolve(policy=PipePolicy(depth="measured", streams="auto"),
                      runner=runner)
    plan = planner.plan_pipe(W_REGULAR, TILE, torch.float32)
    assert choice.source == "measured"
    assert choice.streams == plan.pipe.streams
    assert choice.depth == 3


def test_depth_cap_bounds_every_candidate(plan_cache, monkeypatch):
    _fake_measure(monkeypatch)
    choice = _resolve(runner=_synthetic_runner(best=(9, 1)), depth_cap=4)
    rec = autotune.last_record("ff_synth")
    assert max(c["depth"] for c in rec["candidates"]) <= 4
    assert choice.depth <= 4


def test_memory_cache_keyed_by_cache_path(tmp_path, monkeypatch):
    _fake_measure(monkeypatch)
    tuned_cache_clear()
    try:
        with tuning_config(cache_path=os.path.join(tmp_path, "a.json")):
            assert _resolve().source == "measured"
            assert _resolve().source == "memory"
        with tuning_config(cache_path=os.path.join(tmp_path, "b.json")):
            assert _resolve().source == "measured"
    finally:
        tuned_cache_clear()


def test_plandb_tier_between_disk_and_measure(plan_cache, tmp_path,
                                              monkeypatch):
    """A record the release PlanDB holds is served without measuring, and
    later hits from memory keep its origin."""
    from repro_torch.plans import plandb, registry
    _fake_measure(monkeypatch)
    with tuning_config(cache_path=os.path.join(tmp_path, "scratch.json")):
        rec = dict(_resolve().__dict__)     # measured into a scratch cache
    record = autotune.last_record("ff_synth")
    key = autotune.plan_key(
        "ff_synth", W_REGULAR, torch.float32, PipePolicy().hw,
        autotune._policy_constraints(PipePolicy(mode="autotune")))
    db = plandb.PlanDB()
    db.put(registry.plan_namespace(), key, record)
    db_path = os.path.join(tmp_path, "db.json")
    db.save(db_path)
    tuned_cache_clear()
    plandb.clear_cache()
    monkeypatch.setattr(autotune, "measure", lambda *a, **k: 1 / 0)
    with tuning_config(plan_db=db_path):
        hit = _resolve()
        again = _resolve()
    assert hit.source == "plandb" and (hit.depth, hit.streams) == (
        rec["depth"], rec["streams"])
    assert (again.source, again.origin) == ("memory", "plandb")
    stats = autotune.plan_stats_snapshot()
    assert stats["plandb"] == 1 and stats["memory.plandb"] == 1
    snap = obs.metrics_snapshot()["counters"]
    assert snap["plan_resolutions_total{origin=plandb,source=plandb}"] >= 1


def test_wants_measured_semantics():
    assert autotune.wants_measured(PipePolicy(mode="autotune"))
    assert autotune.wants_measured(PipePolicy(depth="measured"))
    assert not autotune.wants_measured(PipePolicy())
    assert not autotune.wants_measured(
        PipePolicy(mode="baseline", depth="measured"))


@pytest.mark.parametrize("extra", ["", "skv=64|groups=2"])
@pytest.mark.parametrize("pol", [dict(mode="autotune"),
                                 dict(mode="ff", depth="measured"),
                                 dict(mode="autotune", streams=2,
                                      stream_options=(1, 2))])
def test_plan_key_is_the_references(pol, extra):
    """The same call site on the same hardware model keys the same
    record in both packages (the port's ``interp0`` is the reference's
    ``interpret=False``)."""
    jw = jpm.Workload(**W_REGULAR.__dict__)
    jk = jautotune.plan_key(
        "ff_matmul", jw, jnp.bfloat16, jpm.TPU_V5E,
        jautotune._policy_constraints(JPolicy(interpret=False, **pol),
                                      extra))
    tk = autotune.plan_key(
        "ff_matmul", W_REGULAR, torch.bfloat16, TPU_V5E,
        autotune._policy_constraints(PipePolicy(**pol), extra))
    assert jk == tk


def test_generation_moves_with_clears_and_paths(tmp_path):
    g0 = autotune.plans_generation()
    tuned_cache_clear()
    g1 = autotune.plans_generation()
    planner.plan_cache_clear()
    g2 = autotune.plans_generation()
    with tuning_config(plan_db=os.path.join(tmp_path, "x.json")):
        g3 = autotune.plans_generation()
    assert len({g0, g1, g2, g3}) == 4


def test_measure_is_a_median_of_timed_runs():
    calls = []
    t = autotune.measure(lambda: calls.append(1), warmup=2, iters=5)
    assert len(calls) == 7 and t >= 0.0


def test_measured_policy_under_capture_never_measures(plan_cache,
                                                      monkeypatch):
    """A compiled step's warm-up and capture (here the CPU stand-in
    capture) resolve a measured policy without measuring: the kernel gets
    no runner, and the analytic plan stands in."""
    def exploding(*a, **k):
        raise AssertionError("measured inside a capture")

    monkeypatch.setattr(autotune, "measure", exploding)
    q = torch.randn(2, 40, 32)
    kv = torch.randn(1, 40, 32)
    want = ops.attention(q, kv, kv, kv_groups=2,
                         policy=PipePolicy(mode="ref"))

    def fn(params, x):
        return ops.attention(x, kv, kv, kv_groups=2)

    captured = {}

    def capture(run, reload, device):
        captured["in_capture"] = autotune.in_capture()
        out = run()
        return (lambda: None), out, []

    step = t_steps.CompiledStep(fn, capture=capture, devices=("cpu",))
    autotune.plan_stats_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        from repro_torch.core.program import policy
        with policy(mode="autotune"):
            out = step({"w": torch.zeros(1)}, q)
    assert captured["in_capture"] and not autotune.in_capture()
    assert torch.equal(out, want)
    stats = autotune.plan_stats_snapshot()
    assert stats.get("measured", 0) == 0
    assert stats["analytic-fallback"] == 1
    assert not os.path.exists(plan_cache)


def test_eager_measured_policy_measures_the_plain_version(plan_cache):
    """Outside a capture an eager CPU call is measurable: the tuner times
    the plain version (what runs on the CPU) and persists the plan."""
    q = torch.randn(2, 16, 32)
    out = ops.attention(q, q[:1], q[:1], kv_groups=2,
                        policy=PipePolicy(mode="autotune"))
    assert out.shape == q.shape
    rec = autotune.last_record("ff_attention")
    assert rec["source"] == "measured" and rec["hw"] == "h100-sxm"
    assert os.path.exists(plan_cache)


def test_compiled_step_keys_graphs_by_policy_and_generation():
    """One compiled step, three policies: three captures; the same policy
    again replays; clearing the plan cache captures anew."""
    calls = {"capture": 0}

    def capture(run, reload, device):
        calls["capture"] += 1
        out = run()
        return (lambda: None), out, []

    step = t_steps.CompiledStep(lambda p, x: x + 1, capture=capture,
                                devices=("cpu",))
    x, params = torch.zeros(3), {"w": torch.zeros(1)}
    from repro_torch.core.program import policy
    for mode in ("ff", "baseline", "ff", "autotune"):
        with policy(mode=mode):
            step(params, x)
    assert calls["capture"] == 3 and len(step.graphs) == 3
    planner.plan_cache_clear()
    step(params, x)
    assert calls["capture"] == 4
