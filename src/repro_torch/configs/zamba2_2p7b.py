"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Shared transformer block applied every 6 Mamba2
layers (9 applications, one weight set)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2_2p7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every_n=6,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_head_dim=16,
    attn_every_n=2,
    compute_dtype="float32",
)
