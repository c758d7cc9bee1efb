"""repro_torch.checkpoint: atomic, resumable checkpoints (the port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (
    latest_step,
    restore,
    save,
    save_async,
)

__all__ = ["latest_step", "restore", "save", "save_async"]
