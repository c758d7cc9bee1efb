"""End-to-end training driver (the port of ``repro/launch/train.py``) on one
device.

Wires together the model registry, the host data pipe, the optimizer, the
fault-tolerant supervisor (checkpoint, resume, preemption) and the
straggler watchdog. Every flag of the reference's parser is taken, plus
``--device``: the card unless asked for the CPU. ``--mesh host`` (one
device) is the only mesh; ``pod`` and ``pod2`` wait for the distributed
runtime. The model trains on the reference's default path, ``attn_impl``
and ``scan_impl`` "xla" (plain PyTorch, differentiable): no kernel of the
port has a backward, and neither has any Pallas kernel of the reference.
The parameters stay f32 and each use casts to ``cfg.compute_dtype``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --smoke --device cpu --steps 300 --batch 8 --seq 128
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.data import HostPipeline, SyntheticSpec, batch_at
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adafactor, adamw
from repro_torch.runtime.fault_tolerance import FTConfig, Supervisor
from repro_torch.runtime.stragglers import (BatchRebalancer, StragglerConfig,
                                            StragglerWatchdog)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3_2_1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--quantized-accum", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=("host", "pod", "pod2"), default="host",
                    help="host: this one device (the only mesh of the "
                         "port so far)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (tests)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--policy-mode", choices=("ff", "baseline", "autotune"),
                    default=None,
                    help="install a session PipePolicy of this mode around "
                         "the train-step body (the stream-kernel call sites "
                         "plan under it; the 'xla' training path has none)")
    ap.add_argument("--record-profile", default=None, metavar="PATH",
                    help="record every plan resolution into a "
                         "TrafficProfile JSON at PATH (the input of "
                         "`python -m repro_torch.plans sweep`)")
    ap.add_argument("--plan-db", default=None, metavar="PATH",
                    help="release PlanDB consulted after the per-host plan "
                         "cache and before measuring (pre-warmed at "
                         "startup; overrides $REPRO_TORCH_PLAN_DB)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable live telemetry and write "
                         "obs.metrics_snapshot() to PATH at exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def _opt_cfg(optimizer: str, args):
    """The optimizer's config at ``--lr``, 20 warm-up steps, decayed over
    ``--steps`` (the reference passes AdamW's config whatever the
    optimizer; Adafactor takes its own)."""
    if optimizer == "adafactor":
        return adafactor.AdafactorConfig(lr_peak=args.lr, warmup_steps=20,
                                         total_steps=args.steps)
    return adamw.AdamWConfig(lr_peak=args.lr, warmup_steps=20,
                             total_steps=args.steps)


def _plan_hooks(stack: contextlib.ExitStack, args):
    """--metrics-json, --plan-db and --record-profile, as the serve driver
    wires them; returns the recording profile or None."""
    if args.metrics_json:
        if not obs.enabled():
            stack.callback(obs.restore, obs.enable())   # in-memory ring

        def dump(path=args.metrics_json):
            with open(path, "w") as f:
                json.dump(obs.metrics_snapshot(), f, indent=2,
                          sort_keys=True)
            print(f"# wrote live metrics snapshot -> {path}")
        stack.callback(dump)
    if args.plan_db:
        from repro_torch.core import autotune
        from repro_torch.plans import plandb as plandb_lib
        stack.enter_context(autotune.tuning_config(plan_db=args.plan_db))
        pre = plandb_lib.prewarm(args.plan_db)
        print(f"# plan-db {args.plan_db}: {pre['records_in_namespace']} "
              f"records for namespace {pre['namespace']}")
    if args.record_profile:
        from repro_torch.plans import record_traffic
        return stack.enter_context(record_traffic(args.record_profile))
    return None


def run(args) -> Dict[str, Any]:
    """Train as ``args`` say (see :func:`build_parser`). Returns the final
    state ({"params", "opt", "data_step"}), the seconds and the metrics
    (floats) of each step this run took (``step_s``, ``metrics``), the
    step it started from and the newest checkpoint's step, path, bytes
    and write seconds (``checkpoint``)."""
    if args.mesh != "host":
        raise SystemExit(
            f"--mesh {args.mesh}: the port has one mesh so far, 'host' (this "
            f"device); multi-device meshes come with the distributed "
            f"runtime (ROADMAP A.3)")
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # the reference's default path: no kernel of either package has a
    # backward, and the port's kernel entry points refuse autograd
    cfg = cfg.replace(attn_impl="xla", scan_impl="xla")
    model = build_model(cfg)
    opt_cfg = _opt_cfg(cfg.optimizer, args)
    spec = SyntheticSpec(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        n_frames=cfg.n_frames if cfg.family == "encdec" else 0,
        n_patches=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    policy = None
    if args.policy_mode is not None:
        from repro_torch.core.program import PipePolicy
        policy = PipePolicy(mode=args.policy_mode)

    with contextlib.ExitStack() as stack:
        profile = _plan_hooks(stack, args)
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device)
        opt_init, _ = steps_lib.opt_init_and_update(cfg.optimizer, opt_cfg)
        opt_state = opt_init(params)
        train_step = steps_lib.make_train_step(
            model, optimizer=cfg.optimizer, opt_cfg=opt_cfg,
            accum_steps=args.accum, quantized_accum=args.quantized_accum,
            policy=policy)

        sup = stack.enter_context(
            Supervisor(FTConfig(ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every),
                       state_like={"params": params, "opt": opt_state,
                                   "data_step": np.zeros((), np.int64)},
                       fail_at_step=args.fail_at))
        state, start = sup.resume()
        if start:
            print(f"resumed from checkpoint at step {start}"
                  + (f" ({sup.resume_prewarmed} tuned plans pre-warmed)"
                     if sup.resume_prewarmed else ""))
        # the restored state replaces the fresh one: free it
        sup.state_like = None
        del params, opt_state

        pipe = HostPipeline(lambda s: batch_at(spec, s), depth=2,
                            producers=2, start_step=start)

        # the watchdog's actions: "rebalance" shrinks this host's batch
        # share and re-plans at the shrunk shape; "replace" can only be
        # logged on one host
        def replan(host, share):
            from repro_torch.core import planner
            print(f"# straggler {host}: share -> {share}; re-planning "
                  f"local pipes ({planner.plan_cache_info().currsize} "
                  f"cached plans)", flush=True)
            return share

        rebalancer = BatchRebalancer({"host0": max(args.batch, 1)},
                                     replan=replan)
        watchdog = StragglerWatchdog(
            StragglerConfig(), hosts=["host0"], rebalancer=rebalancer,
            on_replace=lambda h: print(f"# straggler {h}: replace "
                                       f"requested (needs a multi-host "
                                       f"mesh)", flush=True))
        t_hist, history = [], []

        def step_fn(state, step):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.get().items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(
                state["params"], state["opt"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            t_hist.append(dt)
            history.append(metrics)
            watchdog.step({"host0": dt})
            if step % args.log_every == 0:
                print(f"step {step:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics.get('grad_norm', 0):.3f} "
                      f"lr={metrics.get('lr', 0):.2e} {dt*1e3:.0f}ms",
                      flush=True)
            return {"params": params, "opt": opt_state,
                    "data_step": np.asarray(step + 1, np.int64)}

        try:
            state = sup.run({**state, "data_step": np.asarray(start,
                                                              np.int64)},
                            start, args.steps, step_fn)
        finally:
            pipe.stop()
        median = np.median(t_hist) * 1e3 if t_hist else float("nan")
        print(f"done at step {args.steps}; median step {median:.0f} ms")
        if sup.last_save:
            ck = sup.last_save
            print(f"# checkpoint {os.path.basename(ck['path'])}: "
                  f"{ck['bytes'] / 1e9:.3f} GB written in "
                  f"{ck['seconds']:.2f} s")
        if profile is not None:
            print(f"# recorded traffic profile: {len(profile)} buckets -> "
                  f"{args.record_profile}")
        return {"state": state, "step_s": t_hist, "metrics": history,
                "start": start, "checkpoint": sup.last_save}


def main(argv=None):
    """Parse ``argv`` and train; returns the final state."""
    return run(build_parser().parse_args(argv))["state"]


if __name__ == "__main__":
    main()
