"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration and traffic files, and the reader of each of its metrics
(``metrics/<name>.py``, a function ``read(run)`` returning a number or
None when it finds nothing to read). Nothing here names a cell: adding
one is adding files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from pbench.model import Model


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    metrics: List[Dict]        # end-to-end, then per-layer entries

    @property
    def model(self) -> Model:
        return Model.from_config(self.config)

    def metrics_of(self, trace: bool) -> List[Dict]:
        """``--trace 0``: the end-to-end metrics this cell reports;
        ``--trace 1``: its per-layer metrics."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m["_kind"] == kind
                and self.name in m.get("workloads", [self.name])]


def _bench_dir(root: Path) -> Path:
    return root / "portbench"


def load(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (_bench_dir(root) / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = ([dict(m, _kind="end_to_end") for m in bench["end_to_end"]]
               + [dict(m, _kind="per_layer") for m in bench["per_layer"]])
    return Cell(name, int(w["chips"]), config, traffic, metrics)


def reader(root: Path, metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = _bench_dir(root) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a metric reader may read."""
    model: Model
    window_s: float
    setup_s: float
    sched: object                     # pbench.counts.Schedule
    tracer: Optional[object] = None   # pbench.trace.Tracer (--trace 1)
    slice: Optional[object] = None    # pbench.trace.Slice, or None
