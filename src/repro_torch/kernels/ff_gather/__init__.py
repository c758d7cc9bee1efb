from repro_torch.kernels.ff_gather.ops import (DEFAULT_DEPTH, DEFAULT_STREAMS,
                                               gather, gather_ref, max_depth)

__all__ = ["DEFAULT_DEPTH", "DEFAULT_STREAMS", "gather", "gather_ref",
           "max_depth"]
