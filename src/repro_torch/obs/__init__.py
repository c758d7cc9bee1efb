"""Unified telemetry: tracing spans, live metrics, bandwidth accounting
(the port of ``repro.obs``; its sink is ``REPRO_TORCH_TRACE``, never the
reference's, so the two packages never share one).

Three layers, one import (``from repro_torch import obs``):

* :mod:`repro_torch.obs.tracing` — ``obs.span("compile_graph", ...)`` context
  managers with thread-local nesting and a JSONL sink
  (``REPRO_TORCH_TRACE=/path`` or ``tuning_config(trace_path=...)``);
* :mod:`repro_torch.obs.metrics` — process-global counters / gauges /
  exponential-bucket histograms behind ``obs.metrics_snapshot()`` and a
  Prometheus-style ``obs.render_text()`` exporter;
* :mod:`repro_torch.obs.bandwidth` — achieved-GB/s and roofline-utilization
  joins of modeled bytes with measured wall time, per kernel and per
  graph edge.

stdlib-only on purpose: ``repro_torch.core`` imports ``repro_torch.obs``, never the
reverse, so instrumentation can sit in the lowest layers. Everything is
zero-cost when disabled — ``obs.span`` returns a shared no-op behind one
``obs.enabled()`` check, and only cold structural counters are always on.
"""

from repro_torch.obs.tracing import (   # noqa: F401
    NOOP_SPAN,
    Span,
    TRACE_ENV,
    current_span,
    disable,
    drain,
    enable,
    enabled,
    restore,
    span,
    trace_path,
)
from repro_torch.obs.metrics import (   # noqa: F401
    Counter,
    Gauge,
    Histogram,
    counter,
    gauge,
    histogram,
    metrics_clear,
    metrics_snapshot,
    parse_text,
    render_text,
)
from repro_torch.obs.bandwidth import (   # noqa: F401
    graph_utilization,
    kernel_utilization,
)

__all__ = [
    "NOOP_SPAN", "Span", "TRACE_ENV", "current_span", "disable", "drain",
    "enable", "enabled", "restore", "span", "trace_path",
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "metrics_clear", "metrics_snapshot", "parse_text", "render_text",
    "graph_utilization", "kernel_utilization",
]
