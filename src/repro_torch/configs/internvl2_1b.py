"""internvl2-1b [vlm] — InternViT frontend STUBBED to precomputed patch
embeddings; qwen2-0.5b-style LM backbone.
[arXiv:2404.16821; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2_1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    rope_theta=1000000.0,
    n_patches=256,
    rule_overrides={"heads": None, "kv_heads": None,   # 14 heads vs 16-way axis
                    "seq": "model"},                   # shard attention by seq instead
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    n_patches=8,
    compute_dtype="float32",
)
