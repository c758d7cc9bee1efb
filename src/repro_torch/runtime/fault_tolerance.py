"""Fault tolerance: checkpoint/restart supervision and preemption handling
(the port of ``repro/runtime/fault_tolerance.py``).

* periodic atomic checkpoints (every ``ckpt_every`` steps, and the last);
* SIGTERM (a scheduler's notice before eviction) -> finish the current
  step, write a final checkpoint, stop; the supervisor saves the previous
  SIGTERM handler and restores it on ``close()`` (it is a context
  manager), and a preemption landing on a ``ckpt_every`` boundary saves
  once, not twice;
* checkpoints carry a tuned-plan snapshot (``autotune.snapshot_plans``,
  keyed by ``PLAN_FORMAT_VERSION``): ``resume()`` pre-warms the autotune
  lookup chain from it, so a restarted job serves every previously tuned
  call site from memory, even on a host with a cold plan cache;
* on start, resume from the newest complete checkpoint: a killed job
  restarted with the same command continues bit for bit (the data are a
  pure function of the step);
* a failure injected at a chosen step, for tests.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.checkpoint import latest_step, restore, save


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50        # and after the last step; 0: only on
                                # preemption
    keep_last: int = 3
    handle_sigterm: bool = True
    # embed autotune.snapshot_plans() in every checkpoint's extra (and
    # pre-warm from it on resume) so restarts skip plan re-measurement
    plan_snapshot: bool = True


class Supervisor:
    """Wraps a step function with checkpoint/restart semantics.

    Use as a context manager (or call :meth:`close`) so the SIGTERM
    handler installed before it is restored when supervision ends.
    ``last_save`` holds the newest checkpoint's step, directory, bytes on
    disk and write seconds."""

    def __init__(self, cfg: FTConfig, state_like: Any,
                 fail_at_step: Optional[int] = None):
        self.cfg = cfg
        self.state_like = state_like
        self.fail_at_step = fail_at_step
        self._preempted = threading.Event()
        self._prev_sigterm = None
        self._sigterm_installed = False
        self._last_saved_step: Optional[int] = None
        self.save_count = 0
        self.resume_prewarmed = 0    # plan records installed by resume()
        self.last_save: Optional[dict] = None
        if cfg.handle_sigterm:
            try:
                self._prev_sigterm = signal.getsignal(signal.SIGTERM)
                signal.signal(signal.SIGTERM, self._on_sigterm)
                self._sigterm_installed = True
            except ValueError:
                pass    # not on the main thread

    def _on_sigterm(self, *_):
        self._preempted.set()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def close(self) -> None:
        """Restore the SIGTERM handler installed before this supervisor
        (idempotent)."""
        if self._sigterm_installed:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._sigterm_installed = False

    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def resume(self) -> tuple[Any, int]:
        """(state, start_step); ``state_like`` itself if no checkpoint
        exists. A checkpoint's plan snapshot pre-warms the autotune chain
        (``resume_prewarmed`` counts the records installed) before any
        kernel call site resolves."""
        with obs.span("supervisor_resume", ckpt_dir=self.cfg.ckpt_dir) as sp:
            step = latest_step(self.cfg.ckpt_dir)
            if step is None:
                sp.set(found=False, step=0)
                return self.state_like, 0
            state, step, extra = restore(self.cfg.ckpt_dir, self.state_like,
                                         step=step)
            if self.cfg.plan_snapshot:
                from repro_torch.core import autotune
                self.resume_prewarmed = autotune.restore_snapshot(
                    (extra or {}).get("plan_snapshot"))
            sp.set(found=True, step=step, prewarmed=self.resume_prewarmed)
        obs.counter("supervisor_resumes_total",
                    "checkpoint resumes (fault_tolerance.Supervisor)").inc()
        obs.counter("supervisor_plans_prewarmed_total",
                    "tuned plans installed from checkpoint snapshots"
                    ).inc(self.resume_prewarmed)
        return state, step

    def _save(self, step: int, state: Any) -> None:
        # a preemption on a ckpt_every boundary (or the final step) must
        # not write the same checkpoint twice
        if step == self._last_saved_step:
            return
        t0 = time.perf_counter()
        with obs.span("supervisor_save", step=step,
                      ckpt_dir=self.cfg.ckpt_dir):
            extra = None
            if self.cfg.plan_snapshot:
                from repro_torch.core import autotune
                extra = {"plan_snapshot": autotune.snapshot_plans()}
            path = save(self.cfg.ckpt_dir, step, state, extra=extra,
                        keep_last=self.cfg.keep_last)
        seconds = time.perf_counter() - t0
        self.last_save = {
            "step": step, "path": path, "seconds": seconds,
            "bytes": sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))}
        self._last_saved_step = step
        self.save_count += 1
        obs.counter("supervisor_saves_total",
                    "checkpoints written (fault_tolerance.Supervisor)").inc()

    def run(self, state: Any, start_step: int, n_steps: int,
            step_fn: Callable[[Any, int], Any],
            on_step: Optional[Callable[[int, Any], None]] = None) -> Any:
        step = start_step
        while step < n_steps:
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            state = step_fn(state, step)
            step += 1
            if on_step:
                on_step(step, state)
            if self.cfg.ckpt_every and (step % self.cfg.ckpt_every == 0
                                        or step == n_steps):
                self._save(step, state)
            if self._preempted.is_set():
                # drain: the step above finished; write the final
                # checkpoint (once, if it is also a boundary)
                self._save(step, state)
                break
        return state
