"""repro_torch.data: deterministic synthetic data and the host
producer/consumer pipe (the port of ``repro.data``)."""

from repro_torch.data.pipeline import HostPipeline
from repro_torch.data.synthetic import SyntheticSpec, batch_at

__all__ = ["HostPipeline", "SyntheticSpec", "batch_at"]
