"""Stateless synthetic LM data (the port of ``repro/data/synthetic.py``,
numpy as there): batch(step) is a pure function of (seed, step), so a
restarted job regenerates the identical stream, which makes a resumed run
equal an uninterrupted one bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality stubs
    n_frames: int = 0
    n_patches: int = 0
    d_model: int = 0


def _rng(spec: SyntheticSpec, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([spec.seed, step, 0xF0D]))


def batch_at(spec: SyntheticSpec, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish token stream (so the loss is learnable, not pure noise)."""
    rng = _rng(spec, step)
    b, s = spec.global_batch, spec.seq_len
    base = rng.integers(0, spec.vocab, size=(b, 1), dtype=np.int32)
    drift = rng.integers(0, 7, size=(b, s), dtype=np.int32).cumsum(axis=1)
    tokens = ((base + drift) % spec.vocab).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    out = {"tokens": tokens, "labels": labels}
    if spec.n_frames:
        out["frames"] = rng.standard_normal(
            (b, spec.n_frames, spec.d_model)).astype(np.float32)
    if spec.n_patches:
        out["image_embeds"] = rng.standard_normal(
            (b, spec.n_patches, spec.d_model)).astype(np.float32)
    return out
