from repro_torch.models.registry import build_model

__all__ = ["build_model"]
