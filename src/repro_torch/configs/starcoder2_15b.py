"""starcoder2-15b [dense] — GQA, RoPE, layernorm+gelu, learned biases.
[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2_15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    rope_theta=100000.0,
    rule_overrides={"kv_heads": None},   # 4 kv heads vs 16-way model axis
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab=256,
    compute_dtype="float32",
)
