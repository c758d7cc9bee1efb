"""Metrics registry: counters, gauges, and exponential-bucket histograms.

One process-global registry replaces the ad-hoc stat scatter
(``autotune.plan_stats()``, ``elastic.last_remesh()``,
``Supervisor.save_count``): every subsystem increments named families
here and :func:`metrics_snapshot` / :func:`render_text` read them all
through one surface.

Two cost tiers, by design:

* **structural** counters (plan resolutions, checkpoint saves, remesh
  drops) are always on — they sit on cold control paths and existing
  APIs like ``plan_stats()`` are required to work without opt-in;
* **hot-path** instrumentation (serve per-step latency observes, span
  timing) is guarded by the caller behind ``obs.enabled()`` so the
  default serve loop pays one bool check and nothing else.

Histograms use exponential buckets at 16 per octave (factor
``2**0.0625``) from 100 ns up. Quantiles follow ``np.percentile``'s
linear-interpolation rank semantics (interpolating between the bucketed
values at the two neighbouring integer ranks), so the only error left is
bucket quantization: ~±2.2% worst case — well inside the 10%
live-vs-post-hoc tolerance the serve telemetry gate checks.

Families are named ``subsystem_noun[_unit]`` (``plan_resolutions_total``,
``serve_token_latency_seconds``) with optional labels; the text exporter
renders Prometheus-style lines (``name{k="v"} value``).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_LOCK = threading.Lock()

# exponential histogram geometry: 16 buckets per octave starting at 100ns
_HIST_LO = 1e-7
_HIST_FACTOR = 2.0 ** 0.0625
_LOG_FACTOR = math.log(_HIST_FACTOR)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic count. ``inc`` only; reset via :func:`metrics_clear`."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n


class Gauge:
    """Point-in-time value (``set``), with ``inc`` for up/down counts."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n


class Histogram:
    """Exponential-bucket histogram over positive values (latencies,
    bytes). Bucket ``i`` covers ``[_HIST_LO * f**i, _HIST_LO * f**(i+1))``;
    values below ``_HIST_LO`` land in bucket 0. Tracks count/sum/min/max
    so quantile endpoints are exact."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        if v <= _HIST_LO:
            i = 0
        else:
            i = int(math.log(v / _HIST_LO) / _LOG_FACTOR) + 1
        with _LOCK:
            self.buckets[i] = self.buckets.get(i, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def _value_at(self, k: int) -> float:
        """Bucket-quantized value of the k-th (0-based) ordered sample:
        the geometric midpoint of its bucket, clamped to [min, max]."""
        seen = 0
        for i in sorted(self.buckets):
            n = self.buckets[i]
            if seen + n > k:
                lo = _HIST_LO * (_HIST_FACTOR ** max(i - 1, 0))
                hi = _HIST_LO * (_HIST_FACTOR ** i)
                return min(max((lo * hi) ** 0.5, self.min), self.max)
            seen += n
        return self.max

    def quantile(self, q: float) -> float:
        """Approximate q-quantile with ``np.percentile``'s linear rank
        semantics: rank ``q * (count - 1)``, interpolating between the
        (bucket-quantized) values at the two neighbouring integer ranks —
        so live quantiles track a post-hoc percentile of the same samples
        to within bucket resolution even on stretched tails."""
        if self.count == 0:
            return float("nan")
        q = min(max(q, 0.0), 1.0)
        rank = q * (self.count - 1)
        k = int(rank)
        frac = rank - k
        v = self._value_at(k)
        if frac > 0.0:
            v += (self._value_at(k + 1) - v) * frac
        return min(max(v, self.min), self.max)

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: Dict[LabelKey, object] = {}

    def child(self, labels: Dict[str, str]):
        key = _label_key(labels)
        c = self.children.get(key)
        if c is None:
            with _LOCK:
                c = self.children.get(key)
                if c is None:
                    c = {"counter": Counter, "gauge": Gauge,
                         "histogram": Histogram}[self.kind]()
                    self.children[key] = c
        return c


_REG: Dict[str, _Family] = {}


def _family(name: str, kind: str, help: str) -> _Family:
    fam = _REG.get(name)
    if fam is None:
        with _LOCK:
            fam = _REG.get(name)
            if fam is None:
                fam = _Family(name, kind, help)
                _REG[name] = fam
    if fam.kind != kind:
        raise ValueError(
            f"metric {name!r} already registered as {fam.kind}, not {kind}")
    return fam


def counter(name: str, help: str = "", **labels) -> Counter:
    """The label-bound counter child for ``name``; created on first use."""
    return _family(name, "counter", help).child(labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _family(name, "gauge", help).child(labels)


def histogram(name: str, help: str = "", **labels) -> Histogram:
    return _family(name, "histogram", help).child(labels)


def metrics_clear(prefix: Optional[str] = None) -> None:
    """Drop all families, or only those whose name starts with ``prefix``
    (e.g. ``metrics_clear("plan_")`` between bench phases)."""
    with _LOCK:
        if prefix is None:
            _REG.clear()
        else:
            for name in [n for n in _REG if n.startswith(prefix)]:
                del _REG[name]


def _labels_dict(key: LabelKey) -> Dict[str, str]:
    return dict(key)


def metrics_snapshot() -> Dict[str, object]:
    """Everything the registry holds, as plain JSON-ready dicts:
    ``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` keyed by
    ``name`` or ``name{k=v,...}`` when labelled."""
    out: Dict[str, Dict[str, object]] = {
        "counters": {}, "gauges": {}, "histograms": {}}
    for fam in sorted(_REG.values(), key=lambda f: f.name):
        for key, child in sorted(fam.children.items()):
            label = fam.name
            if key:
                label += "{" + ",".join(f"{k}={v}" for k, v in key) + "}"
            if fam.kind == "counter":
                out["counters"][label] = child.value
            elif fam.kind == "gauge":
                out["gauges"][label] = child.value
            else:
                out["histograms"][label] = child.summary()
    return out


def _fmt_labels(key: LabelKey, extra: Iterable[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def render_text() -> str:
    """Prometheus-style exposition text for every family: ``# HELP`` /
    ``# TYPE`` headers, one sample line per child (histograms render
    ``_count``/``_sum`` plus ``quantile=`` samples)."""
    lines: List[str] = []
    for fam in sorted(_REG.values(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in sorted(fam.children.items()):
            if fam.kind in ("counter", "gauge"):
                lines.append(f"{fam.name}{_fmt_labels(key)} {child.value:.17g}")
            else:
                lines.append(f"{fam.name}_count{_fmt_labels(key)} {child.count}")
                lines.append(f"{fam.name}_sum{_fmt_labels(key)} {child.sum:.17g}")
                if child.count:
                    for q in (0.5, 0.9, 0.99):
                        v = child.quantile(q)
                        lines.append(
                            f"{fam.name}{_fmt_labels(key, [('quantile', f'{q:g}')])}"
                            f" {v:.17g}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_text(text: str) -> Dict[str, float]:
    """Parse exposition text back to ``{sample_name: value}`` (labels
    folded into the key verbatim) — the round-trip check used by tests."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out
