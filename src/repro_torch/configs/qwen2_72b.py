"""qwen2-72b [dense] — GQA, QKV bias, SwiGLU, RMSNorm.
[arXiv:2407.10671; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2_72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    rule_overrides={"kv_heads": None},   # 8 kv heads vs 16-way model axis
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    compute_dtype="float32",
)
