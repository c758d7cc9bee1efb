"""Step builders for serving (the port of ``make_prefill_step`` and
``make_decode_step`` in ``repro/launch/steps.py``). PyTorch runs eagerly,
so a step is the model call under ``torch.no_grad``."""

from __future__ import annotations

import torch


def make_prefill_step(model):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    """decode_step(params, batch, cache) -> (greedy next token [B] int32,
    logits [B, V], cache). ``argmax`` takes the first index on ties, as
    ``jnp.argmax`` does."""
    @torch.no_grad()
    def decode_step(params, batch, cache):
        logits, new_cache = model.decode_step(params, batch, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache
    return decode_step
