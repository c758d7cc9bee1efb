"""Host-side feed-forward data pipeline (the port of
``repro/data/pipeline.py``): producer threads -> bounded queue (the pipe)
-> consumer.

This is the paper's design at the host level: N producer threads (the
"memory kernels") make batches; the bounded queue is the pipe (its
``depth`` is the channel depth); the training loop is the consumer. Steps
are assigned to producers round-robin (the paper's static load
balancing), which makes the delivery order deterministic whatever the
producers' timing.

The state is one integer (the next step), because batches are pure
functions of the step index: checkpoint and resume are exact.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import numpy as np


class HostPipeline:
    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 *, depth: int = 2, producers: int = 1, start_step: int = 0):
        self.batch_fn = batch_fn
        self.depth = depth
        self.producers = producers
        self._next_emit = start_step
        self._stop = threading.Event()
        self._ready: Dict[int, Dict[str, np.ndarray]] = {}
        self._lock = threading.Condition()
        self._threads = []
        for p in range(producers):
            t = threading.Thread(target=self._produce, args=(start_step + p,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _produce(self, first: int) -> None:
        step = first
        while not self._stop.is_set():
            batch = self.batch_fn(step)
            with self._lock:
                # back-pressure: only steps inside the window [next_emit,
                # next_emit + depth) may sit in the pipe, so a fast producer
                # never crowds out the word the consumer needs next
                while step - self._next_emit >= self.depth:
                    if self._stop.is_set():
                        return
                    self._lock.wait(timeout=0.1)
                self._ready[step] = batch
                self._lock.notify_all()
            step += self.producers

    def get(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        """Blocking read from the pipe, in step order."""
        with self._lock:
            want = self._next_emit
            if not self._lock.wait_for(lambda: want in self._ready,
                                       timeout=timeout):
                raise TimeoutError(f"pipe starved at step {want}")
            batch = self._ready.pop(want)
            self._next_emit += 1
            self._lock.notify_all()
            return batch

    @property
    def state(self) -> int:
        """Checkpointable pipeline state: the next step to be consumed."""
        with self._lock:
            return self._next_emit

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._lock.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
