"""rwkv6-7b [ssm] "Finch" — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536;
64 wkv heads of dim 64."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6_7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv heads (d_model / 64)
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    norm="layernorm",
    ssm_head_dim=64,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_head_dim=16,
    compute_dtype="float32",
)
