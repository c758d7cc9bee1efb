"""End-to-end training driver (the port of ``repro/launch/train.py``).

Wires together the model registry, logical sharding, the host data pipe,
the optimizer, the fault-tolerant supervisor (checkpoint, resume,
preemption) and the straggler watchdog. Every flag of the reference's
parser is taken, plus ``--device`` (the card unless asked for the CPU) and
``--dist-backend``. The model trains on the reference's default path,
``attn_impl`` and ``scan_impl`` "xla" (plain PyTorch, differentiable): no
kernel of the port has a backward, and neither has any Pallas kernel of
the reference. The parameters stay f32 and each use casts to
``cfg.compute_dtype``.

One process is one rank. Under ``torchrun`` (``RANK``/``WORLD_SIZE``) the
ranks join one process group and ``--mesh host`` is the ``(world // 2,
2)`` ("data", "model") mesh; ``pod`` / ``pod2`` the 16 x 16 / 2 x 16 x 16
production meshes, refused unless the world has 256 / 512 ranks. The
parameters, the AdamW state and the batch are DTensors placed by the
config's logical rules; each rank draws the same seeded parameters and the
same global batch and keeps its shards. Rank 0 alone logs and writes
checkpoints (every rank gathers them). At one rank the mesh shards
nothing: the step runs on plain tensors.

On one rank the train step is compiled, as the reference jits it
(``launch/steps.py`` ``make_train_step``): on the card one CUDA graph a
signature, replayed every step, with each step's batch written into one
set of device tensors the graph reads (a resume brings new parameter and
optimizer buffers, so the step captures again); on the CPU it runs
eagerly. Under a mesh the step runs eagerly on DTensors.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --smoke --device cpu --steps 300 --batch 8 --seq 128
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --mesh host --dist-backend gloo ...

NCCL refuses two ranks on one card, so ranks sharing a card take
``--dist-backend gloo`` (the compute stays on the card, the collectives go
through the host).
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
from repro_torch.configs.base import (ARCH_IDS, ShapeConfig, get_config,
                                      smoke_config)
from repro_torch.data import HostPipeline, SyntheticSpec, batch_at
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adafactor, adamw
from repro_torch.runtime import gloo_staged
from repro_torch.runtime import sharding as shlib
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
                    help="host: (world // 2, 2) data x model over the "
                         "torchrun world; pod / pod2: the 256 / 512-rank "
                         "production meshes")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="write a checkpoint every N steps and after the "
                         "last; 0: none (but on preemption)")
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
    ap.add_argument("--dist-backend", choices=mesh_lib.BACKENDS,
                    default=None,
                    help="process-group backend of a multi-rank run "
                         "(default nccl with a card a rank, gloo_staged "
                         "for ranks sharing a card, gloo on cpu)")
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
    and write seconds (``checkpoint``), the mesh's axis sizes (``mesh``)
    and, by rank, the peak device bytes, the parameter bytes held and the
    collective payload bytes of each step under ``gloo_staged``
    (``ranks``). Every rank returns its own state; rank 0 logs."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh != "host":
        try:
            mesh_lib.check_production_world(world, args.mesh == "pod2")
        except ValueError as e:
            raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
    rank = 0
    if world > 1:
        rank, world, device = mesh_lib.init_distributed(
            device, args.dist_backend)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # the reference's default path: no kernel of either package has a
    # backward, and the port's kernel entry points refuse autograd
    cfg = cfg.replace(attn_impl="xla", scan_impl="xla")
    model = build_model(cfg)
    log = print if rank == 0 else (lambda *a, **k: None)
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
        if world > 1:
            stack.callback(torch.distributed.destroy_process_group)
            mesh = (mesh_lib.make_production_mesh(
                multi_pod=args.mesh == "pod2", device_type=device.type)
                if args.mesh != "host" else
                mesh_lib.make_host_mesh(device_type=device.type))
            stack.enter_context(shlib.use_sharding(
                mesh, overrides=cfg.rule_overrides))
            mesh_shape = shlib.mesh_shape(mesh)
        else:
            shape, names = mesh_lib.host_mesh_shape(1)
            mesh_shape = dict(zip(names, shape))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        profile = _plan_hooks(stack, args) if rank == 0 else None
        params = steps_lib.init_params(
            model, torch.Generator(device=device).manual_seed(0), device)
        input_axes = model.input_axes(
            ShapeConfig("train", args.seq, args.batch, "train"))
        opt_init, _ = steps_lib.opt_init_and_update(cfg.optimizer, opt_cfg)
        opt_state = opt_init(params)
        train_step = steps_lib.make_train_step(
            model, optimizer=cfg.optimizer, opt_cfg=opt_cfg,
            accum_steps=args.accum, quantized_accum=args.quantized_accum,
            compiled=world == 1, policy=policy)

        sup = stack.enter_context(
            Supervisor(FTConfig(ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every),
                       state_like={"params": params, "opt": opt_state,
                                   "data_step": np.zeros((), np.int64)},
                       fail_at_step=args.fail_at))
        state, start = sup.resume()
        if start:
            log(f"resumed from checkpoint at step {start}"
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
            log(f"# straggler {host}: share -> {share}; re-planning "
                f"local pipes ({planner.plan_cache_info().currsize} "
                f"cached plans)", flush=True)
            return share

        rebalancer = BatchRebalancer({"host0": max(args.batch, 1)},
                                     replan=replan)
        watchdog = StragglerWatchdog(
            StragglerConfig(), hosts=["host0"], rebalancer=rebalancer,
            on_replace=lambda h: log(f"# straggler {h}: replace "
                                     f"requested (a relaunch on the "
                                     f"surviving ranks, "
                                     f"elastic.replace_host)", flush=True))
        t_hist, history, comm = [], [], []
        batch_buffers: Dict[str, torch.Tensor] = {}

        def load_batch():
            """The next batch on the device: under a mesh each rank's
            shards of the same global batch; on one rank written into the
            same tensors every step (the compiled step reads it there)."""
            host = {k: torch.from_numpy(v) for k, v in pipe.get().items()}
            if world > 1:
                return shlib.place_tree({k: v.to(device)
                                         for k, v in host.items()},
                                        input_axes)
            if not batch_buffers:
                batch_buffers.update({k: torch.empty_like(v, device=device)
                                      for k, v in host.items()})
            for k, v in host.items():
                batch_buffers[k].copy_(v)
            return batch_buffers

        def step_fn(state, step):
            batch = load_batch()
            sent = gloo_staged.traffic()
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(
                state["params"], state["opt"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            t_hist.append(dt)
            history.append(metrics)
            comm.append(sum(gloo_staged.traffic().values())
                        - sum(sent.values()))
            watchdog.step({"host0": dt})
            if step % args.log_every == 0:
                log(f"step {step:5d} loss={metrics['loss']:.4f} "
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
        log(f"done at step {args.steps}; median step {median:.0f} ms")
        ranks = _rank_report(state["params"], device, comm, world)
        log("# train_result " + json.dumps({
            "mesh": mesh_shape, "loss": [m["loss"] for m in history],
            "step_ms": [t * 1e3 for t in t_hist], "ranks": ranks}))
        if sup.last_save:
            ck = sup.last_save
            log(f"# checkpoint {os.path.basename(ck['path'])}: "
                f"{ck['bytes'] / 1e9:.3f} GB written in "
                f"{ck['seconds']:.2f} s")
        if profile is not None:
            log(f"# recorded traffic profile: {len(profile)} buckets -> "
                f"{args.record_profile}")
        return {"state": state, "step_s": t_hist, "metrics": history,
                "start": start, "checkpoint": sup.last_save,
                "mesh": mesh_shape, "ranks": ranks}


def _rank_report(params, device, comm, world):
    """Per rank (gathered on every rank): peak device bytes since the
    run's start (None on the CPU), the parameter bytes the rank holds,
    the collective payload bytes of each step (``gloo_staged`` counts
    them; zeros under another backend) and the process's kernel launches
    by op (``kernel_launches``; none on the CPU)."""
    from repro_torch.kernels import launch_counters
    mine = {"peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "param_bytes": shlib.local_bytes(params),
            "comm_bytes": comm,
            "kernel_launches": {w.op_name: w.launches
                                for w in launch_counters() if w.launches}}
    if world == 1:
        return [mine]
    out = [None] * world
    torch.distributed.all_gather_object(out, mine)
    return out


def main(argv=None):
    """Parse ``argv`` and train; returns the final state."""
    return run(build_parser().parse_args(argv))["state"]


if __name__ == "__main__":
    main()
