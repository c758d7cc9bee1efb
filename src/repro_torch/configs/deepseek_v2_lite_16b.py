"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 2 shared / 64 routed
top-6 experts.  [arXiv:2405.04434; hf]  27L d_model=2048 16H (kv=16)
d_ff=1408 (per-expert) vocab=102400.

``attn_impl`` is pinned to ``"xla"``: the reference's default, and the
only path its MLA prefill runs under (v's head dim 128 is not q's 192)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
    attn_impl="xla",
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    n_experts=8,
    n_shared_experts=1,
    top_k=2,
    moe_d_ff=64,
    kv_lora_rank=32,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
    capacity_factor=8.0,   # smoke: no token drops (decode-consistency tests)
    compute_dtype="float32",
)
