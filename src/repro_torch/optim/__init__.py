"""repro_torch.optim: AdamW, Adafactor and int8 gradient accumulation
(the port of ``repro.optim``)."""

from repro_torch.optim import adafactor, adamw, compression

__all__ = ["adafactor", "adamw", "compression"]
