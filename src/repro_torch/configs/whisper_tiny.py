"""whisper-tiny [audio] — encoder-decoder; conv frontend STUBBED to
precomputed frame embeddings per the assignment.
[arXiv:2212.04356; unverified]  4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper_tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    n_frames=1500,
    rule_overrides={"heads": None, "kv_heads": None,   # 6 heads vs 16-way axis
                    "seq": "model"},                   # shard attention by seq instead
)

SMOKE = CONFIG.replace(
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    n_frames=16,
    compute_dtype="float32",
)
