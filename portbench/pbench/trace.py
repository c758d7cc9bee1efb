"""The traced run: the program's spans, and ``torch.profiler`` over a
bounded slice of the window.

The window's call cannot be cut into pieces, and a whole window holds
millions of device events, so the profiler is started and stopped from
the program's own span boundaries: :class:`Tracer` wraps ``obs.span`` for
the window's call. It starts the profiler at the first admission that
follows a decode step (the first refill of a freed slot, where the
window's prefill and decode interleave), or at the opening of decode step
``start`` if that comes first; what runs until the next decode step
opens is the profiler's warm-up and is not counted. The slice then runs
from the opening of that decode step to the opening of the decode step at
which it stops: after ``steps`` counted decode steps, and once the slice
holds at least one admission, or after ``4 * steps`` when no admission
comes. Each span of the slice also opens a
``record_function`` range of its name, so the host's spans and the
device's kernels lie on one clock in the trace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

PREFIX = "portbench."


@dataclasses.dataclass
class Slice:
    """What the profiler saw, on its clock (microseconds)."""
    t0: float
    t1: float
    kernels: List[Tuple[str, float, float]]          # name, start, end
    spans: List[Tuple[str, float, float]]            # host spans
    decode_steps: List[int]                          # indices counted
    admitted: List[int]                              # rids admitted

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class _Wrapped:
    def __init__(self, tracer, name, inner, attrs):
        self.tracer, self.name, self.inner, self.attrs = \
            tracer, name, inner, attrs
        self.rf = None

    def set(self, **attrs):
        self.inner.set(**attrs)
        return self

    def __enter__(self):
        self.rf = self.tracer.opened(self.name, self.attrs)
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.inner.__exit__(*exc)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return out


class Tracer:
    """Spans on, and the profiler over a slice of decode steps from
    ``start`` (see the module's docstring)."""

    def __init__(self, *, start: int, steps: int, device_type: str):
        self.start, self.steps = start, steps
        self.device_type = device_type
        self.decode_seen = 0
        self.prof = None
        self.counting = False
        self.done = False
        self.counted: List[int] = []
        self.admitted: List[int] = []
        self.records: List[dict] = []     # the spans, after the window
        self._obs = None
        self._real_span = None
        self._prev_state = None

    def __enter__(self):
        from repro_torch import obs
        self._obs = obs
        self._real_span = obs.span
        self._prev_state = obs.enable()
        obs.drain()
        tracer = self

        def span(name, **attrs):
            return _Wrapped(tracer, name, tracer._real_span(name, **attrs),
                            attrs)
        obs.span = span
        return self

    def __exit__(self, *exc):
        self._stop()
        self._obs.span = self._real_span
        self.records = self._obs.drain()
        self._obs.restore(self._prev_state)
        return False

    # -- called at each span's opening -------------------------------------
    def opened(self, name: str, attrs: Dict):
        if name == "serve_decode_step":
            self._decode_opened()
        elif name == "serve_admit" and self.decode_seen and \
                self.prof is None:
            self._start()
        if self.prof is None or self.done:
            return None
        if self.counting:
            if name == "serve_decode_step":
                self.counted.append(self.decode_seen - 1)
            elif name == "serve_admit":
                self.admitted.append(int(attrs["rid"]))
        import torch
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        return rf

    def _decode_opened(self):
        n = self.decode_seen
        self.decode_seen += 1
        if self.done:
            return
        if self.prof is None:
            if n == self.start:
                self._start()
        elif not self.counting:
            self.counting = True          # the warm-up step has ended
        elif self.counting:
            k = len(self.counted)
            if (k >= self.steps and self.admitted) or k >= 4 * self.steps:
                self._stop()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def _stop(self):
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    # -- after the window ---------------------------------------------------
    def span_ms(self, name: str) -> List[float]:
        return [r["dur_s"] * 1e3 for r in self.records if r["name"] == name]

    def slice(self) -> Optional[Slice]:
        """The slice's kernels and host spans, from the first counted
        decode step's opening to the profiler's stop."""
        if self.prof is None or not self.counted:
            return None
        from torch.autograd import DeviceType
        kernels, spans = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith(PREFIX):
                # a host span, or its annotation on the device's timeline
                # (which covers the span's kernels and is no kernel)
                if e.device_type != DeviceType.CUDA:
                    spans.append((e.name[len(PREFIX):], tr.start, tr.end))
            elif e.device_type == DeviceType.CUDA:
                kernels.append((e.name, tr.start, tr.end))
        spans.sort(key=lambda s: s[1])
        steps = [s for s in spans if s[0] == "serve_decode_step"]
        # the counted decode steps are the last ones the profiler saw (a
        # profiler started at a decode step saw one more before them)
        if len(steps) < len(self.counted):
            return None
        t0 = steps[len(steps) - len(self.counted)][1]
        t1 = max([s[2] for s in spans] + [k[2] for k in kernels])
        kernels = sorted(k for k in kernels if k[1] >= t0)
        spans = [s for s in spans if s[1] >= t0]
        return Slice(t0, t1, kernels, spans, list(self.counted),
                     list(self.admitted))


# -- reductions of a slice ----------------------------------------------------


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of ``merged`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def busy_us(sl: Slice) -> float:
    return covered(union([(a, b) for _, a, b in sl.kernels]), sl.t0, sl.t1)


def kernel_us(sl: Slice, match) -> Tuple[float, int]:
    """Summed device time and launches of the kernels whose name
    ``match`` accepts."""
    hits = [b - a for name, a, b in sl.kernels if match(name)]
    return sum(hits), len(hits)


def breakdown(sl: Slice, n: int = 10) -> Dict[str, list]:
    """The device ops that took most time, and the longest idle gaps
    with the host span open at each gap's middle ("scheduler": none)."""
    by_name: Dict[str, float] = {}
    for name, a, b in sl.kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    merged = union([(a, b) for _, a, b in sl.kernels])
    edges = [sl.t0] + [x for ab in merged for x in ab] + [sl.t1]
    gaps = []
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            mid = (lo + hi) / 2
            host = next((s[0] for s in sl.spans if s[1] <= mid <= s[2]),
                        "scheduler")
            gaps.append((host, (hi - lo) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": [[h, s] for h, s in gaps[:n]]}
