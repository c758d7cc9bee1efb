"""qwen1.5-0.5b [dense] — MHA (kv=16H=16), QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]  24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1_5_0p5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    compute_dtype="float32",
)
