"""grok-1-314b [moe] — 8 experts, top-2.
[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, MoE 8e top-2.

8 experts do not divide the 16-way model axis, so experts stay replicated
and tensor parallelism runs *inside* each expert (rule override)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="grok1_314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    rope_theta=10000.0,
    optimizer="adafactor",
    rule_overrides={"expert": None, "exp_cap": "data", "kv_heads": None},
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    capacity_factor=8.0,   # smoke: no token drops (decode-consistency tests)
    compute_dtype="float32",
    rule_overrides=None,
)
