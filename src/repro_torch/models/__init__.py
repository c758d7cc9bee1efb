from repro_torch.models.registry import build_model, build_model_by_id

__all__ = ["build_model", "build_model_by_id"]
