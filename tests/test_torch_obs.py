"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``): the same observations give the same metric snapshots,
the same Prometheus-style text and the same parse of it; spans nest and
record as the reference's, to their own sink (``REPRO_TORCH_TRACE``); the
bandwidth joins give the reference's numbers on the same estimates.
Observations are drawn from a seeded numpy generator.
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.core.pipeline_model as jpm
import repro.obs as jobs
import repro_torch.core.pipeline_model as tpm
from repro_torch import obs as tobs


@pytest.fixture
def clean():
    jobs.metrics_clear()
    tobs.metrics_clear()
    yield
    jobs.metrics_clear()
    tobs.metrics_clear()


def _observe(mod, seed):
    rng = np.random.default_rng(seed)
    for src in ("analytic", "memory", "plandb", "measured"):
        mod.counter("plan_resolutions_total", "plan resolutions by source",
                    source=src, origin="" if src == "analytic" else "disk"
                    ).inc(int(rng.integers(1, 50)))
    mod.gauge("serve_kv_utilization", "kv util").set(float(rng.uniform()))
    for sched in ("lockstep", "paged"):
        h = mod.histogram("serve_token_latency_seconds", "latency",
                          scheduler=sched)
        for v in rng.lognormal(-4.0, 1.5, size=int(rng.integers(1, 400))):
            h.observe(float(v))
    mod.histogram("empty_seconds", "never observed")


@pytest.mark.parametrize("seed", range(6))
def test_snapshot_and_text_equal_the_reference(clean, seed):
    _observe(jobs, seed)
    _observe(tobs, seed)
    assert tobs.metrics_snapshot() == jobs.metrics_snapshot()
    text = tobs.render_text()
    assert text == jobs.render_text()
    assert tobs.parse_text(text) == jobs.parse_text(text)
    parsed = tobs.parse_text(text)
    assert any(k.startswith("serve_token_latency_seconds_count") for k in
               parsed)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_equal_the_reference(clean, q):
    rng = np.random.default_rng(11)
    jh, th = jobs.Histogram(), tobs.Histogram()
    for v in rng.exponential(0.01, size=1000):
        jh.observe(float(v))
        th.observe(float(v))
    assert th.quantile(q) == jh.quantile(q)
    assert th.summary() == jh.summary()


def test_metric_kind_conflict_raises(clean):
    tobs.counter("x_total").inc()
    with pytest.raises(ValueError, match="already registered"):
        tobs.gauge("x_total")
    tobs.metrics_clear("x_")
    assert tobs.metrics_snapshot() == {"counters": {}, "gauges": {},
                                       "histograms": {}}


def test_spans_nest_and_record():
    state = tobs.enable()
    try:
        tobs.drain()
        with tobs.span("outer", op="a") as outer:
            with tobs.span("inner") as inner:
                inner.set(depth=2, t=torch.tensor([1, 2]))
            assert tobs.current_span() is outer
        with pytest.raises(KeyError):
            with tobs.span("bad"):
                raise KeyError("x")
        recs = {r["name"]: r for r in tobs.drain()}
    finally:
        tobs.restore(state)
    assert recs["inner"]["parent"] == recs["outer"]["id"]
    assert recs["outer"]["parent"] is None
    assert recs["inner"]["attrs"]["depth"] == 2
    assert recs["bad"]["status"] == "error" and recs["bad"]["error"] == \
        "KeyError"
    assert all(r["dur_s"] >= 0 for r in recs.values())


def test_disabled_spans_are_the_shared_noop():
    state = tobs.disable()
    try:
        assert tobs.span("x", a=1) is tobs.NOOP_SPAN
        assert tobs.span("x").set(b=2) is tobs.NOOP_SPAN
        assert not tobs.enabled() and tobs.trace_path() is None
    finally:
        tobs.restore(state)


def test_file_sink_and_env_name(tmp_path):
    assert tobs.TRACE_ENV == "REPRO_TORCH_TRACE" != jobs.TRACE_ENV
    path = tmp_path / "trace.jsonl"
    state = tobs.enable(str(path))
    try:
        assert tobs.trace_path() == str(path)
        for i in range(5):
            with tobs.span("step", i=i, x=torch.ones(2, 2)):
                pass
    finally:
        tobs.restore(state)       # drains the writer
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["attrs"]["i"] for r in lines] == list(range(5))


def test_jsonable_takes_tensors():
    from repro_torch.obs.tracing import _jsonable
    assert _jsonable({"t": torch.tensor([1.5, 2.0]), 3: (1, "a")}) == {
        "t": [1.5, 2.0], "3": [1, "a"]}
    assert _jsonable(torch.zeros(100, 100)) == "(100, 100)"


def test_kernel_utilization_equals_the_reference():
    kw = dict(n_words=4096, word_bytes=16384.0, flops_per_word=1e6,
              store_bytes_per_word=128.0)
    for measured in (1e-6, 3.3e-5, 2.0):
        assert tobs.kernel_utilization(
            tpm.Workload(**kw), tpm.H100_SXM, measured) == \
            jobs.kernel_utilization(
                jpm.Workload(**kw), jpm.HardwareModel(
                    # the port's own field, which no estimate reads
                    **{k: v for k, v in tpm.H100_SXM.__dict__.items()
                       if k != "sms"}), measured)


def test_graph_utilization_equals_the_reference():
    import repro.core.pipe as jpipe
    import repro_torch.core.pipe as tpipe
    import jax.numpy as jnp
    ests = []
    for mod, pipe_mod, dt in ((jpm, jpipe, jnp.float32),
                              (tpm, tpipe, torch.float32)):
        stages = tuple(mod.GraphStage(
            name=f"s{i}", workload=mod.Workload(
                n_words=100 * (i + 1), word_bytes=4096.0 * (i + 1),
                flops_per_word=1e5, regular=True),
            pipe=pipe_mod.Pipe(tile=(8, 128), dtype=dt, depth=2),
            fused_with_prev=i == 1, saved_load_bytes=1e4,
            saved_store_bytes=2e4, rationale=f"r{i}") for i in range(3))
        ests.append(mod.estimate_graph(stages, mod.TPU_V5E))
    a = jobs.graph_utilization(ests[0], jpm.TPU_V5E, 1e-3)
    b = tobs.graph_utilization(ests[1], tpm.TPU_V5E, 1e-3)
    assert a == b
    assert math.isclose(sum(e["hbm_bytes"] for e in b["edges"]),
                        b["graph"]["hbm_bytes"])
