"""The serve path under the pipe policy: ``--policy-mode``,
``--plan-db``, ``--record-profile`` and ``--metrics-json`` on the port's
CPU serve, against the reference's schedulers.

Smoke qwen1.5-0.5B, rate 0, 3 requests, 2 slots, page 8, the reference's
parameters carried across; the reference runs in interpret mode outside
``use_sharding`` (its meshes refuse ``constrain`` under jax 0.9). With the
EOS set to the first token the reference emits for request 0, retirement
(and so every count) depends on the greedy token values, so equal counts
under each policy mode mean equal tokens. The metrics JSON must carry the
reference's metric names and label keys.
"""

import argparse
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.obs as jobs
from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy as JPolicy
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro_torch import obs as tobs
from repro_torch import plans as tplans
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.core import autotune
from repro_torch.core.program import PipePolicy
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax

ARCH = "qwen1_5_0p5b"
PAGE, SLOTS = 8, 2
MODES = ("ff", "baseline", "autotune")
KEYS = ("tokens", "decode_steps")


def _first_token(jmodel, jparams, prompt):
    pol = JPolicy(mode="ff", interpret=True)
    pre = jax.jit(j_steps.make_prefill_step(jmodel, policy=pol))
    dec = jax.jit(j_steps.make_decode_step(jmodel, policy=pol))
    n = len(prompt)
    toks = np.zeros((1, j_serve._bucket(n)), np.int32)
    toks[0, :n] = prompt
    _, cache = pre(jparams, {"tokens": jnp.asarray(toks)})
    cache = j_serve.pad_cache_to(cache, toks.shape[1], 2 * toks.shape[1], 2)
    nxt, _, _ = dec(jparams, {"token": jnp.asarray([prompt[-1]]),
                              "lengths": jnp.asarray([n - 1])}, cache)
    return int(np.asarray(nxt)[0])


def _label_keys(snapshot):
    """{metric name: sorted label keys} of an obs snapshot."""
    out = {}
    for kind in ("counters", "gauges", "histograms"):
        for label in snapshot[kind]:
            name, _, rest = label.partition("{")
            keys = tuple(sorted(kv.split("=")[0]
                                for kv in rest.rstrip("}").split(",")
                                if kv)) if rest else ()
            out.setdefault(name, set()).add(keys)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_smoke(ARCH).replace(attn_impl="ff", decode_block_kv=PAGE,
                                 remat="none")
    tcfg = t_smoke(ARCH).replace(decode_block_kv=PAGE)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    reqs = j_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=jcfg.vocab, seed=0)
    eos = _first_token(jmodel, jparams, reqs[0].prompt)
    ref, metrics = {}, None
    jobs.metrics_clear()
    state = jobs.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for mode in MODES:
                kw = dict(n_slots=SLOTS, page=PAGE, eos_id=eos,
                          policy=JPolicy(mode=mode, interpret=True))
                if mode == "ff":
                    j_serve.run_lockstep(jmodel, jparams, jcfg, reqs, **kw)
                ref[mode] = j_serve.run_continuous(jmodel, jparams, jcfg,
                                                   reqs, **kw)
                if mode == "ff":
                    metrics = jobs.metrics_snapshot()
    finally:
        jobs.restore(state)
        jobs.drain()
    return dict(tcfg=tcfg, tmodel=t_build(tcfg), tparams=tparams,
                reqs=reqs, eos=eos, ref=ref, ref_metrics=metrics,
                tmp=tmp_path_factory.mktemp("policy_serve"))


@pytest.fixture
def plan_env(setup, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       str(setup["tmp"] / "host.json"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_DB", raising=False)
    autotune.tuned_cache_clear()
    yield setup["tmp"]
    autotune.tuned_cache_clear()


def _port_requests(setup):
    return t_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=setup["tcfg"].vocab, seed=0)


@pytest.mark.parametrize("mode", MODES)
def test_tokens_equal_the_reference_under_each_mode(setup, plan_env, mode):
    args = (setup["tmodel"], setup["tparams"], setup["tcfg"],
            _port_requests(setup))
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=setup["eos"],
              policy=PipePolicy(mode=mode))
    cont = t_serve.run_continuous(*args, **kw)
    lock = t_serve.run_lockstep(*args, **kw)
    ref = setup["ref"][mode]
    assert {k: cont[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert lock["tokens"] == cont["tokens"]
    # the EOS bites: without it every request would emit its budget
    assert cont["tokens"] < 3 * 4


def test_outputs_are_each_requests_tokens_under_every_mode(setup,
                                                           plan_env):
    """Both schedulers return each request's greedy tokens by rid: as
    many as they count, the same under every mode, and the same request
    by request in both schedulers (the smoke model's prefill rounds alike
    at either batch)."""
    args = (setup["tmodel"], setup["tparams"], setup["tcfg"],
            _port_requests(setup))
    seen = []
    for mode in MODES:
        kw = dict(n_slots=SLOTS, page=PAGE, eos_id=setup["eos"],
                  policy=PipePolicy(mode=mode))
        for run in (t_serve.run_continuous, t_serve.run_lockstep):
            out = run(*args, **kw)
            assert sum(map(len, out["outputs"].values())) == out["tokens"]
            assert sorted(out["outputs"]) == [0, 1, 2]
            seen.append(out["outputs"])
    assert all(o == seen[0] for o in seen)
    # the EOS retires request 0 at its first token
    assert seen[0][0] == [setup["eos"]]


def test_probe_is_bitwise_under_each_mode(setup, plan_env):
    for mode in MODES:
        assert t_serve.decode_parity_probe(
            setup["tmodel"], setup["tparams"], setup["tcfg"], page=PAGE,
            policy=PipePolicy(mode=mode)) == 0.0


def test_baseline_runs_every_ring_at_depth_one(setup, monkeypatch):
    seen = []
    real = autotune.resolve_call

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((op, policy.mode, choice.depth))
        return choice

    monkeypatch.setattr(autotune, "resolve_call", spy)
    t_serve.run_continuous(setup["tmodel"], setup["tparams"], setup["tcfg"],
                           _port_requests(setup), n_slots=SLOTS, page=PAGE,
                           eos_id=None, policy=PipePolicy(mode="baseline"))
    ops = {op for op, _, _ in seen}
    assert {"ff_attention", "graph:paged_decode_attention"} <= ops
    assert all(mode == "baseline" and depth == 1
               for _, mode, depth in seen)


def test_ff_plans_every_call_within_its_kernel(setup, monkeypatch):
    from repro_torch.kernels.ff_attention import max_depth as att_max
    seen = []
    real = autotune.resolve_call

    def spy(op, policy, **kw):
        choice = real(op, policy, **kw)
        seen.append((op, choice, kw["depth_cap"], policy.stream_options,
                     kw["dtype"]))
        return choice

    monkeypatch.setattr(autotune, "resolve_call", spy)
    t_serve.run_lockstep(setup["tmodel"], setup["tparams"], setup["tcfg"],
                         _port_requests(setup), n_slots=SLOTS, page=PAGE,
                         eos_id=None, policy=PipePolicy())
    assert seen
    for op, choice, cap, so, dtype in seen:
        assert choice.source == "analytic"
        assert 2 <= choice.depth <= cap and choice.streams in so
        if op == "ff_attention":
            assert cap == att_max(setup["tcfg"].hd, dtype)


def _serve_args(*extra):
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    return ap.parse_args(["--smoke", "--device", "cpu", "--requests", "3",
                          "--max-new", "3", "--prompt-len", "10",
                          "--page", str(PAGE), "--slots", str(SLOTS),
                          *extra])


def test_metrics_json_carries_the_references_names(setup, plan_env):
    path = plan_env / "metrics.json"
    tobs.metrics_clear()
    out = t_serve.serve_bench(_serve_args("--metrics-json", str(path)))
    assert out["metrics_json"] == str(path)
    snap = json.loads(path.read_text())
    ours, theirs = _label_keys(snap), _label_keys(setup["ref_metrics"])
    assert set(ours) == set(theirs) == {"plan_resolutions_total",
                                        "serve_token_latency_seconds",
                                        "serve_kv_utilization"}
    for name in theirs:
        assert ours[name] == theirs[name], name
    hist = snap["histograms"]
    lock = hist["serve_token_latency_seconds{scheduler=lockstep}"]
    assert lock["count"] == out["lockstep"]["tokens"]
    assert not tobs.enabled()        # restored after the run


@pytest.mark.parametrize("mode", MODES)
def test_cli_flags_profile_and_plan_db(setup, plan_env, mode, monkeypatch):
    """Record a profile under ``mode``, sweep it on the CPU, serve again
    under autotune with ``--plan-db``: the PlanDB serves every resolution
    of the recorded traffic and the tokens do not move."""
    prof = plan_env / f"traffic_{mode}.json"
    first = t_serve.serve_bench(_serve_args(
        "--policy-mode", mode, "--record-profile", str(prof)))
    assert first["policy_mode"] == mode
    rec = first["plan_service"]["recorded"]
    assert rec["observations"] > 0 and prof.exists()
    profile = tplans.TrafficProfile.load(str(prof))
    assert profile.total_count == rec["observations"]
    db = str(plan_env / f"db_{mode}.json")
    from repro_torch.plans.__main__ import main as plans_main
    assert plans_main(["sweep", "--profile", str(prof), "--db", db,
                       "--device", "cpu", "--iters", "1", "--top-k", "2",
                       "--scratch-cache",
                       str(plan_env / f"scratch_{mode}.json")]) == 0
    # a fresh host: an empty per-host cache (the first run under autotune
    # measured into the shared one), the release DB shipped
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE",
                       str(plan_env / f"fresh_{mode}.json"))
    autotune.tuned_cache_clear()
    autotune.plan_stats_clear()
    second = t_serve.serve_bench(_serve_args(
        "--policy-mode", "autotune", "--plan-db", db))
    ps = second["plan_service"]
    assert ps["prewarm"]["usable"] and ps["prewarm"]["records_in_namespace"]
    assert ps["stats"]["plandb"] > 0
    for k in ("lockstep", "paged"):
        assert second[k]["tokens"] == first[k]["tokens"]
    assert second["bitwise_identical"]
