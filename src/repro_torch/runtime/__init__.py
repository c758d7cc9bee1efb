"""repro_torch.runtime: the distributed substrate (sharding rules, overlap
collectives, pipeline parallelism, fault tolerance, elastic remesh,
straggler mitigation) and the chaos harness."""

from repro_torch.runtime import (
    collectives,
    elastic,
    fault_tolerance,
    pipeline_parallel,
    sharding,
    stragglers,
)

__all__ = [
    "chaos", "collectives", "elastic", "fault_tolerance",
    "pipeline_parallel", "sharding", "stragglers",
]


def __getattr__(name):
    # lazy: chaos is also an entry point (python -m repro_torch.runtime.chaos);
    # importing it eagerly here would shadow the runpy execution
    if name == "chaos":
        import importlib
        return importlib.import_module("repro_torch.runtime.chaos")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
