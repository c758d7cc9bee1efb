"""llama3.2-1b [dense] — small llama3, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]  16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3_2_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
    rule_overrides={"kv_heads": None},   # 8 kv heads vs 16-way model axis
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    compute_dtype="float32",
)
