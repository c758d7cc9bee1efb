"""Chaos harness: fault injection against the resilience and plan stack
(the port of ``repro/runtime/chaos.py``).

Each scenario is an orchestrated subprocess experiment (the injected fault
kills, signals, or degrades a *real* training process built on the
autotuned kernel stack) with a machine-checkable outcome:

* ``kill-restart``: SIGKILL mid-run (uncatchable, between checkpoints).
  The restart runs with a **cold plan cache** and must (a) resume from the
  newest checkpoint, (b) pre-warm the tuned-plan chain from the
  checkpoint's plan snapshot (zero re-measurements, every call site a
  memory hit) and (c) finish with a final state bitwise identical to an
  uninterrupted control run.
* ``sigterm-drain``: a preemption notice landing exactly on a
  ``ckpt_every`` boundary: the supervisor drains the step, saves exactly
  once (no double checkpoint), exits 0; resuming completes bitwise
  identically to the control run.
* ``evict-remesh``: a 2-pod job of 8 ranks loses a pod. ``replace_host``
  (the watchdog's "replace" action, end to end) must restore shard-exact
  state onto the survivable mesh of the 4 survivors, drop every
  stale-mesh plan, and serve the first post-remesh call site from the
  swept PlanDB for the *new* topology: never the 2-pod plan, and without
  re-measuring.
* ``slow-host``: an injected straggler trips the MAD outlier model; the
  watchdog's "rebalance" action shrinks the slow host's data share via
  :class:`~repro_torch.runtime.stragglers.BatchRebalancer` and re-plans its
  local pipes through ``shard_streams`` at the shrunk shard shape, on 2
  ranks.

``run_scenarios`` drives all four and returns the metrics dict (recovery
seconds, bitwise flags, plan-stat breakdowns, each worker's ``ff_matmul``
launches), gating on ``ok``.

Workers run as ``python -m repro_torch.runtime.chaos <scenario> ...
--device D`` so the orchestrator controls their plan caches per process
(the restart legitimately starts cold); ``--device`` defaults to
``cuda``, where the state update's product is the ``ff_matmul`` kernel.
The reference's 8- and 2-device host meshes become ranks started by
``launch/mesh.py:spawn_ranks`` (gloo on the CPU, ``gloo_staged`` on the
card: several ranks share the one card and NCCL refuses that); rank 0
writes the report. The orchestrator imports no torch and so starts no CUDA
context.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

# one matmul call site: (DIM, DIM) @ (DIM, DIM)
DIM = 128

# generous wall bound for "restart -> first productive step" (includes
# process start, torch import, restore, prewarm, and on the card the
# kernel's build when the build directory is cold)
RECOVERY_BOUND_S = 300.0

# each remesh / slow-host rank's join and work, seconds
RANK_TIMEOUT_S = 240.0


def _write_report(path: Optional[str], report: Dict[str, Any]) -> None:
    print("REPORT " + json.dumps(report, sort_keys=True), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chaos check failed: {what}")


# ---------------------------------------------------------------------------
# Workers (run in subprocesses; heavy imports stay function-local)
# ---------------------------------------------------------------------------


def step_input(step: int):
    """The step's ``x`` [DIM, DIM] f32: a CPU ``torch.Generator`` seeded by
    the step, so the data are a pure function of the step on any device."""
    import torch
    gen = torch.Generator().manual_seed(step)
    return torch.randn((DIM, DIM), generator=gen, dtype=torch.float32)


def train_update(w, x, policy):
    """The state update ``w <- 0.99 w + 0.01 tanh(x @ w)`` with the product
    through ``repro_torch.ops.matmul`` under ``policy``."""
    import torch

    from repro_torch import ops
    return 0.99 * w + 0.01 * torch.tanh(ops.matmul(x, w, policy=policy))


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible")
        torch.cuda.set_device(dev.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def _matmul_launches() -> int:
    from repro_torch.kernels.ff_matmul import matmul
    return matmul.launches


def _worker_train(args) -> None:
    """Deterministic supervised loop on the autotuned matmul kernel.

    State evolves as ``w <- 0.99*w + 0.01*tanh(x_step @ w)`` with ``x_step``
    derived from the step index: a pure function of (step, state), so a
    killed-and-resumed run is bitwise identical to an uninterrupted one.
    ``--kill-at`` SIGKILLs after that step completes (before its boundary
    checkpoint); ``--sigterm-at`` delivers a real SIGTERM the supervisor
    must drain."""
    import hashlib

    import torch

    from repro_torch.core import autotune
    from repro_torch.core.program import PipePolicy
    from repro_torch.runtime.fault_tolerance import FTConfig, Supervisor

    t_start = time.perf_counter()
    dev = _device(args.device)
    pol = PipePolicy(mode="autotune")
    with autotune.tuning_config(cache_path=args.plan_cache, warmup=0,
                                iters=1, top_k=2):
        cfg = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       keep_last=8)
        like = {"w": torch.zeros((DIM, DIM), dtype=torch.float32,
                                 device=dev)}
        with Supervisor(cfg, like) as sup:
            t0 = time.perf_counter()
            state, start = sup.resume()
            resume_s = time.perf_counter() - t0
            autotune.plan_stats_clear()     # count post-resume resolutions

            def step_fn(state, step):
                x = step_input(step).to(dev)
                return {"w": train_update(state["w"], x, pol)}

            progress = {"step": start, "first_step_s": None}

            def on_step(step, _state):
                if progress["first_step_s"] is None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    progress["first_step_s"] = time.perf_counter() - t_start
                progress["step"] = step
                print(f"step {step}", flush=True)
                if args.kill_at is not None and step == args.kill_at:
                    os.kill(os.getpid(), signal.SIGKILL)
                if args.sigterm_at is not None and step == args.sigterm_at:
                    os.kill(os.getpid(), signal.SIGTERM)

            state = sup.run(state, start, args.steps, step_fn,
                            on_step=on_step)
            w = state["w"].detach().cpu().contiguous()
            report = {
                "scenario": "train",
                "device": str(dev),
                "resumed_from": start,
                "final_step": progress["step"],
                "preempted": sup.preempted,
                "save_count": sup.save_count,
                "prewarmed": sup.resume_prewarmed,
                "plan_stats": autotune.plan_stats_snapshot(),
                "ff_matmul_launches": _matmul_launches(),
                "resume_s": resume_s,
                "first_step_s": progress["first_step_s"],
                "total_s": time.perf_counter() - t_start,
                "state_sha256": hashlib.sha256(
                    w.numpy().tobytes()).hexdigest(),
            }
    _write_report(args.report, report)


def _normal(seed: int, shape):
    import torch
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float32)


def _remesh_rank(rank: int, world: int, base: str, device: str):
    """One of the 8 ranks of the 2-pod job (pod 2, data 2, model 2). Ranks
    4-7 are the lost pod: they take part in building the meshes (a
    collective of the whole group) and restore nothing of their own.
    Rank 0 returns the report; the survivors check their state and the
    post-remesh call site."""
    import torch

    from repro_torch import ops
    from repro_torch.checkpoint import save
    from repro_torch.core import autotune, planner
    from repro_torch.core.meshspec import MeshSpec
    from repro_torch.core.program import PipePolicy
    from repro_torch.plans import PlanDB
    from repro_torch.plans.registry import plan_namespace
    from repro_torch.runtime import sharding as shlib
    from repro_torch.runtime.elastic import (last_remesh, replace_host,
                                             survivable_mesh)

    dev = _device(device)
    # per-rank plan files: each process has its own plan stack
    host_cache = os.path.join(base, f"host_cache_r{rank}.json")
    sweep_cache = os.path.join(base, f"sweep_cache_r{rank}.json")
    db_path = os.path.join(base, f"plandb_r{rank}.json")
    ckpt = os.path.join(base, "ckpt")

    old_spec = MeshSpec((("pod", 2), ("data", 2), ("model", 2)))
    new_spec = MeshSpec((("data", 2), ("model", 2)))
    a, b = _normal(1, (DIM, DIM)).to(dev), _normal(2, (DIM, DIM)).to(dev)

    def pol(spec):
        return PipePolicy(mode="autotune", mesh=spec)

    # offline sweep for the topology we will *fail over to* -> PlanDB
    with autotune.tuning_config(cache_path=sweep_cache, warmup=0, iters=1,
                                top_k=2):
        ops.matmul(a, b, policy=pol(new_spec))
        db = PlanDB()
        ns = plan_namespace()
        for key, rec in autotune.load_plans(sweep_cache).items():
            db.put(ns, key, rec)
        db.save(db_path)
    autotune.tuned_cache_clear()

    survivors = list(range(world // 2))
    with autotune.tuning_config(cache_path=host_cache, warmup=0, iters=1,
                                top_k=2, plan_db=db_path):
        # phase 1: healthy 2-pod job: tune and checkpoint
        old_mesh = survivable_mesh(range(world), model_axis=2, pod_axis=2,
                                   device_type=dev.type)
        params = {"w": _normal(0, (2 * DIM, DIM))}
        with shlib.use_sharding(old_mesh):
            save(ckpt, 3, params)
            ops.matmul(a, b, policy=pol(old_spec))
        _require(planner.last_plan("ff_matmul").mesh == old_spec,
                 "the 2-pod call site is planned for the 2-pod mesh")

        # pod loss -> the watchdog's "replace" action, end to end
        autotune.plan_stats_clear()
        t_fail = time.perf_counter()
        like = {"w": torch.empty((2 * DIM, DIM), dtype=torch.float32,
                                 device="meta")}
        axes = {"w": ("batch", None)}
        state, step, new_mesh = replace_host(
            ckpt, like, axes, survivors, model_axis=2, plan_db=db_path,
            device_type=dev.type)
        rep = last_remesh()
        _require(step == 3, f"restored step {step} == 3")
        _require(rep.mesh == new_spec, f"remesh onto {rep.mesh}")
        _require(rep.planner_dropped >= 1, f"planner dropped {rep}")
        _require(rep.autotune_dropped >= 1, f"autotune dropped {rep}")
        _require(rep.plan_db_records >= 1, f"PlanDB records {rep}")
        if rank not in survivors:
            return None
        restored = shlib.full_tensor(state["w"]).cpu()
        _require(torch.equal(restored, params["w"]),
                 "restored state == the checkpointed state bit for bit")

        # first call site under the new topology: swept plan, never the
        # stale 2-pod plan, no measurement
        with shlib.use_sharding(new_mesh):
            ops.matmul(a, b, policy=pol(new_spec))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        recovery_s = time.perf_counter() - t_fail
        rec = autotune.last_record("ff_matmul")
        _require(rec is not None and rec.get("mesh") == new_spec.token,
                 f"post-remesh record {rec} is keyed by {new_spec.token}")
        _require(rec.get("source") == "plandb",
                 f"post-remesh record {rec} served from the PlanDB")
        stale = planner.last_plan("ff_matmul")
        _require(stale is None or stale.mesh != old_spec,
                 f"the stale 2-pod plan is gone: {stale}")
        stats = autotune.plan_stats_snapshot()
        _require(stats.get("plandb", 0) >= 1, f"plandb hits {stats}")
        _require(stats.get("measured", 0) == 0, f"no measurement {stats}")

    if rank:
        return None
    return {
        "scenario": "remesh",
        "ok": True,
        "device": str(dev),
        "ranks": world,
        "old_mesh": old_spec.token,
        "new_mesh": rep.mesh.token,
        "planner_dropped": rep.planner_dropped,
        "autotune_dropped": rep.autotune_dropped,
        "plan_db_records": rep.plan_db_records,
        "post_remesh_source": rec.get("source"),
        "post_remesh_mesh": rec.get("mesh"),
        "post_remesh_stats": stats,
        "ff_matmul_launches": _matmul_launches(),
        "recovery_s": recovery_s,
    }


def _slowhost_rank(rank: int, world: int, device: str):
    """One of the 2 hosts sharing a data batch (a 1-D "data" mesh). Both
    ranks run the same watchdog on the same injected step times; each
    re-plans its local pipes through ``shard_streams`` at its shard's
    shape. Rank 0 returns the report."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import ops
    from repro_torch.core import planner
    from repro_torch.runtime import sharding as shlib
    from repro_torch.runtime.streams import shard_streams
    from repro_torch.runtime.stragglers import (BatchRebalancer,
                                                StragglerConfig,
                                                StragglerWatchdog)

    dev = _device(device)
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    b = _normal(2, (DIM, DIM)).to(dev)

    def plan_local():
        # re-plan the local pipes at the current global share total:
        # shard_streams runs the kernel at the shard-local shape
        m_global = rb.total() * DIM
        a = torch.zeros((m_global, DIM), dtype=torch.float32, device=dev)
        with shlib.use_sharding(mesh):
            f = shard_streams(ops.matmul,
                              in_specs=((Shard(0),), (Replicate(),)),
                              out_specs=(Shard(0),))
            f(a, b)
        plan = planner.last_plan("ff_matmul")
        return {"mesh": plan.mesh.token, "n_words": plan.workload.n_words}

    def replan(host, share):
        out = plan_local()
        out.update(host=host, share=share)
        return out

    rb = BatchRebalancer({"h0": 4, "h1": 4}, replan=replan)
    before = plan_local()
    cfg = StragglerConfig(window=16, tolerate=3, evict_after=64,
                          slow_factor=1.5, mad_factor=5.0)
    wd = StragglerWatchdog(cfg, hosts=["h0", "h1"], rebalancer=rb)

    slow_from = 3
    for i in range(10):
        jitter = 0.005 * ((i * 7) % 5 - 2)      # MAD > 0: realistic noise
        t0 = 1.0 + jitter
        t1 = 2.0 + jitter if i >= slow_from else t0
        acts = wd.observe_step({"h0": t0, "h1": t1})
        wd.mitigate(acts)

    thr = wd._threshold()
    med = 1.0
    _require(thr < cfg.slow_factor * med, f"MAD path taken ({thr})")
    _require(any(m["action"] == "rebalance" for m in wd.mitigations),
             f"a rebalance among {wd.mitigations}")
    after = rb.last_replan["h1"]
    _require(rb.shares["h1"] < 4, f"h1's share shrank: {rb.shares}")
    _require(after["mesh"] == "data2", f"re-planned on data2: {after}")
    _require(after["n_words"] < before["n_words"],
             f"fewer words after: {before} -> {after}")
    if rank:
        return None
    return {
        "scenario": "slowhost",
        "ok": True,
        "device": str(dev),
        "ranks": world,
        "threshold": thr,
        "mad_path": thr < cfg.slow_factor * med,
        "share_before": 4,
        "share_after": rb.shares["h1"],
        "n_words_before": before["n_words"],
        "n_words_after": after["n_words"],
        "replan_mesh": after["mesh"],
        "mitigations": wd.mitigations,
        "ff_matmul_launches": _matmul_launches(),
    }


def _spawn(fn, world: int, args, rdv: str, device: str):
    """``fn`` on ``world`` ranks (``launch/mesh.py:spawn_ranks``): gloo on
    the CPU, ``gloo_staged`` on the card. Rank 0's return value."""
    from repro_torch.launch.mesh import spawn_ranks
    backend = "gloo_staged" if device.startswith("cuda") else "gloo"
    return spawn_ranks(fn, world, args, init_file=rdv, backend=backend,
                       timeout=RANK_TIMEOUT_S, threads=1)[0]


def _worker_remesh(args) -> None:
    """2-pod job loses a pod; replace_host must be plan-correct.

    A PlanDB is swept for the *surviving* topology up front (the release
    artifact a fleet would ship), the job tunes and checkpoints under the
    2-pod mesh of 8 ranks, then half the ranks "fail". Checks: shard-exact
    state on the new mesh, stale-mesh planner/autotune entries dropped, and
    the first post-remesh call site served from the PlanDB (not the stale
    plan, not a re-measurement)."""
    report = _spawn(_remesh_rank, 8, (args.dir, args.device),
                    os.path.join(args.dir, "rendezvous"), args.device)
    _write_report(args.report, report)


def _worker_slowhost(args) -> None:
    """Injected straggler -> MAD detection -> rebalance -> re-plan.

    Two hosts share a data batch; host h1 turns 2x slow with realistic
    per-step jitter (so the MAD path, not the degenerate slow_factor
    fallback, does the detecting). The watchdog's rebalance must shrink
    h1's share and the hook re-plans the local pipes through
    ``shard_streams``: checked by the planner's last plan's workload
    shrinking under the mesh-tagged key."""
    os.makedirs(args.dir, exist_ok=True)
    report = _spawn(_slowhost_rank, 2, (args.device,),
                    os.path.join(args.dir, "rendezvous"), args.device)
    _write_report(args.report, report)


# ---------------------------------------------------------------------------
# Orchestration (runs in the parent process; torch-free)
# ---------------------------------------------------------------------------


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    # several ranks' allocators share one card (as chip_smoke's phase j)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    return env


def _run_worker(cmd_args: List[str], *, device: str, timeout: int = 600):
    cmd = ([sys.executable, "-m", "repro_torch.runtime.chaos"] + cmd_args
           + ["--device", device])
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=_worker_env(), capture_output=True,
                       text=True, timeout=timeout)
    return r, time.perf_counter() - t0


def _load_report(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _train_args(ckpt: str, cache: str, report: str, *, steps: int,
                ckpt_every: int, kill_at: Optional[int] = None,
                sigterm_at: Optional[int] = None) -> List[str]:
    out = ["train", "--ckpt-dir", ckpt, "--plan-cache", cache,
           "--report", report, "--steps", str(steps),
           "--ckpt-every", str(ckpt_every)]
    if kill_at is not None:
        out += ["--kill-at", str(kill_at)]
    if sigterm_at is not None:
        out += ["--sigterm-at", str(sigterm_at)]
    return out


def scenario_kill_restart(workdir: str, *, steps: int = 10, kill_at: int = 7,
                          ckpt_every: int = 3, device: str = "cuda",
                          timeout: int = 600) -> Dict[str, Any]:
    """SIGKILL mid-run; cold-cache restart must be bitwise + pre-warmed."""
    base = os.path.join(workdir, "kill")
    os.makedirs(base, exist_ok=True)
    ckpt = os.path.join(base, "ckpt")
    reports = {k: os.path.join(base, f"report_{k}.json") for k in "abc"}

    rA, _ = _run_worker(_train_args(
        ckpt, os.path.join(base, "cache_a.json"), reports["a"],
        steps=steps, ckpt_every=ckpt_every, kill_at=kill_at),
        device=device, timeout=timeout)
    killed = rA.returncode == -signal.SIGKILL

    # restart with a COLD plan cache: the checkpoint snapshot is the only
    # warm source; measured must stay 0
    rB, wall_b = _run_worker(_train_args(
        ckpt, os.path.join(base, "cache_b.json"), reports["b"],
        steps=steps, ckpt_every=ckpt_every), device=device, timeout=timeout)
    # uninterrupted control run (own checkpoint dir and cache)
    rC, _ = _run_worker(_train_args(
        os.path.join(base, "ckpt_control"),
        os.path.join(base, "cache_c.json"), reports["c"],
        steps=steps, ckpt_every=ckpt_every), device=device, timeout=timeout)

    out: Dict[str, Any] = {"killed": killed, "kill_rc": rA.returncode,
                           "restart_rc": rB.returncode,
                           "control_rc": rC.returncode}
    if rB.returncode != 0 or rC.returncode != 0:
        out.update(ok=False, stderr=(rB.stderr + rC.stderr)[-2000:])
        return out
    rb, rc = _load_report(reports["b"]), _load_report(reports["c"])
    expect_resume = kill_at - (kill_at % ckpt_every)
    recovery_s = rb["first_step_s"]
    stats = rb["plan_stats"]
    out.update(
        ok=(killed
            and rb["resumed_from"] == expect_resume
            and rb["prewarmed"] >= 1
            and stats.get("measured", 0) == 0
            and stats.get("hits", 0) >= steps - expect_resume
            and rb["state_sha256"] == rc["state_sha256"]
            and recovery_s <= RECOVERY_BOUND_S),
        bitwise_identical=rb["state_sha256"] == rc["state_sha256"],
        resume_step=rb["resumed_from"], expect_resume=expect_resume,
        prewarmed=rb["prewarmed"], restart_plan_stats=stats,
        recovery_s=recovery_s, recovery_bound_s=RECOVERY_BOUND_S,
        restart_wall_s=wall_b,
        ff_matmul_launches={"restart": rb["ff_matmul_launches"],
                            "control": rc["ff_matmul_launches"]})
    return out


def scenario_sigterm_drain(workdir: str, *, steps: int = 12,
                           sigterm_at: int = 6, ckpt_every: int = 3,
                           device: str = "cuda",
                           timeout: int = 600) -> Dict[str, Any]:
    """Preemption on a ckpt boundary: drain, save once, resume bitwise."""
    if sigterm_at % ckpt_every:
        raise ValueError("the scenario targets the boundary-coincident "
                         "preemption: sigterm_at must be a multiple of "
                         "ckpt_every")
    base = os.path.join(workdir, "sigterm")
    os.makedirs(base, exist_ok=True)
    ckpt = os.path.join(base, "ckpt")
    reports = {k: os.path.join(base, f"report_{k}.json") for k in "abc"}

    rA, _ = _run_worker(_train_args(
        ckpt, os.path.join(base, "cache_a.json"), reports["a"],
        steps=steps, ckpt_every=ckpt_every, sigterm_at=sigterm_at),
        device=device, timeout=timeout)
    rB, _ = _run_worker(_train_args(
        ckpt, os.path.join(base, "cache_b.json"), reports["b"],
        steps=steps, ckpt_every=ckpt_every), device=device, timeout=timeout)
    rC, _ = _run_worker(_train_args(
        os.path.join(base, "ckpt_control"),
        os.path.join(base, "cache_c.json"), reports["c"],
        steps=steps, ckpt_every=ckpt_every), device=device, timeout=timeout)

    out: Dict[str, Any] = {"drain_rc": rA.returncode,
                           "resume_rc": rB.returncode,
                           "control_rc": rC.returncode}
    if rA.returncode != 0 or rB.returncode != 0 or rC.returncode != 0:
        out.update(ok=False,
                   stderr=(rA.stderr + rB.stderr + rC.stderr)[-2000:])
        return out
    ra, rb, rc = (_load_report(reports[k]) for k in "abc")
    expected_saves = sigterm_at // ckpt_every   # drain save deduplicated
    out.update(
        ok=(ra["preempted"]
            and ra["final_step"] == sigterm_at
            and ra["save_count"] == expected_saves
            and rb["resumed_from"] == sigterm_at
            and rb["state_sha256"] == rc["state_sha256"]),
        preempted=ra["preempted"], drained_at=ra["final_step"],
        save_count=ra["save_count"], expected_saves=expected_saves,
        resume_step=rb["resumed_from"],
        bitwise_identical=rb["state_sha256"] == rc["state_sha256"],
        ff_matmul_launches={k: r["ff_matmul_launches"] for k, r in
                            (("drain", ra), ("resume", rb),
                             ("control", rc))})
    return out


def scenario_evict_remesh(workdir: str, *, device: str = "cuda",
                          timeout: int = 600) -> Dict[str, Any]:
    """Pod loss: replace_host keeps plans correct for the new topology."""
    base = os.path.join(workdir, "remesh")
    os.makedirs(base, exist_ok=True)
    report = os.path.join(base, "report.json")
    r, wall = _run_worker(["remesh", "--dir", base, "--report", report],
                          device=device, timeout=timeout)
    if r.returncode != 0:
        return {"ok": False, "rc": r.returncode, "stderr": r.stderr[-2000:]}
    out = _load_report(report)
    out["ok"] = bool(out.get("ok")) and out["recovery_s"] <= RECOVERY_BOUND_S
    out["recovery_bound_s"] = RECOVERY_BOUND_S
    out["wall_s"] = wall
    return out


def scenario_slow_host(workdir: str, *, device: str = "cuda",
                       timeout: int = 600) -> Dict[str, Any]:
    """Straggler: MAD detection -> rebalance -> shrunk-shard re-plan."""
    base = os.path.join(workdir, "slowhost")
    os.makedirs(base, exist_ok=True)
    report = os.path.join(base, "report.json")
    r, wall = _run_worker(["slowhost", "--dir", base, "--report", report],
                          device=device, timeout=timeout)
    if r.returncode != 0:
        return {"ok": False, "rc": r.returncode, "stderr": r.stderr[-2000:]}
    out = _load_report(report)
    out["wall_s"] = wall
    return out


def run_scenarios(workdir: Optional[str] = None, *, smoke: bool = True,
                  device: str = "cuda", timeout: int = 600
                  ) -> Dict[str, Any]:
    """Run the full chaos suite; returns its metrics dict. The four
    scenarios are independent (each its own directory, processes and plan
    caches) and run at the same time, each its own workers in order: a
    worker spends most of its wall starting torch and its device."""
    from concurrent.futures import ThreadPoolExecutor
    workdir = workdir or tempfile.mkdtemp(prefix="repro_torch_chaos_")
    steps = 10 if smoke else 24
    t0 = time.perf_counter()
    runs = {
        "kill_restart": lambda: scenario_kill_restart(
            workdir, steps=steps, kill_at=7, ckpt_every=3, device=device,
            timeout=timeout),
        "sigterm_drain": lambda: scenario_sigterm_drain(
            workdir, steps=steps + 2, sigterm_at=6, ckpt_every=3,
            device=device, timeout=timeout),
        "evict_remesh": lambda: scenario_evict_remesh(
            workdir, device=device, timeout=timeout),
        "slow_host": lambda: scenario_slow_host(workdir, device=device,
                                                timeout=timeout),
    }
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        futures = {name: pool.submit(run) for name, run in runs.items()}
        scenarios = {name: f.result() for name, f in futures.items()}
    return {"suite": "chaos", "smoke": smoke, "device": device,
            "workdir": workdir, "wall_s": time.perf_counter() - t0,
            "scenarios": scenarios,
            "ok": all(s.get("ok") for s in scenarios.values())}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add(name, help_):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--device", default="cuda",
                       help="cuda (default: the kernels on the card) or "
                       "cpu (their plain versions)")
        return p

    p = add("train", "deterministic supervised worker")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--plan-cache", required=True)
    p.add_argument("--report", default="")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=3)
    p.add_argument("--kill-at", type=int, default=None)
    p.add_argument("--sigterm-at", type=int, default=None)

    p = add("remesh", "pod-loss replace_host worker (8 ranks)")
    p.add_argument("--dir", required=True)
    p.add_argument("--report", default="")

    p = add("slowhost", "straggler rebalance worker (2 ranks)")
    p.add_argument("--dir", required=True)
    p.add_argument("--report", default="")

    p = add("suite", "orchestrate all scenarios")
    p.add_argument("--workdir", default=None)
    p.add_argument("--full", action="store_true")
    p.add_argument("--json", default="")

    args = parser.parse_args(argv)
    if args.cmd == "train":
        _worker_train(args)
    elif args.cmd == "remesh":
        _worker_remesh(args)
    elif args.cmd == "slowhost":
        _worker_slowhost(args)
    else:
        result = run_scenarios(args.workdir, smoke=not args.full,
                               device=args.device)
        _write_report(args.json, result)
        return 0 if result["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
