from repro_torch.kernels.adamw.ops import MAX_LEAVES, adamw_ref, adamw_update

__all__ = ["MAX_LEAVES", "adamw_ref", "adamw_update"]
