from repro_torch.kernels.ff_gather.ops import gather, gather_ref, max_depth

__all__ = ["gather", "gather_ref", "max_depth"]
