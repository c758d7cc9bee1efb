"""Architecture configuration schema (the port's copy of
``repro.configs.base``).

``ArchConfig`` keeps the reference's fields so configs read the same in
both packages; ``cdtype``/``pdtype`` return torch dtypes. ``attn_impl``
and ``scan_impl`` take the reference's values: ``"ff"`` the CUDA kernels
(with their plain PyTorch versions on the CPU), ``"xla"`` (and for the
scan ``"xla_tiled"``) the reference's unfused formulations in plain
PyTorch. The port's kernels are its point, so both default to ``"ff"``
(the reference's default is ``"xla"``); a config whose model cannot run
under ``"ff"`` pins ``"xla"`` (deepseek-v2-lite's MLA). Each config's
``rule_overrides`` are the reference's (its logical-axis sharding
presets, read by ``runtime.sharding.use_sharding``); :data:`SHAPES` and
:func:`shape_applicable` are the reference's shape cells. The reference's
hillclimb presets (``OPTIMIZED``) are not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

ARCH_IDS = (
    "qwen1_5_0p5b",
    "llama3_2_1b",
    "starcoder2_15b",
    "qwen2_72b",
    "grok1_314b",
    "deepseek_v2_lite_16b",
    "rwkv6_7b",
    "zamba2_2p7b",
    "internvl2_1b",
    "whisper_tiny",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"                       # swiglu | gelu
    norm: str = "rmsnorm"                     # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every_n: int = 0
    conv_width: int = 4

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500

    # VLM
    n_patches: int = 256

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"
    optimizer: str = "adamw"

    rule_overrides: Optional[Dict[str, object]] = None

    # implementation switches
    attn_impl: str = "ff"                     # ff (the CUDA kernels) | xla
    decode_block_kv: Optional[int] = None     # pin the decode-attention KV
                                              # tile (None = heuristic);
                                              # serving pins it to the page
                                              # size so the contiguous path
                                              # is bitwise-equal to the
                                              # paged path
    layer_graph: bool = False
    scan_impl: str = "ff"                     # ff (the CUDA chunk-scan
                                              # kernel) | xla | xla_tiled
    scan_layers: bool = True
    loss_chunk: int = 0
    scan_chunk: int = 64
    moe_local_dispatch: bool = False
    bf16_grads: bool = False
    unroll_layers: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 128 (padded ids are never labels)."""
        return -(-self.vocab // 128) * 128

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    # rule overrides applied when this shape is lowered (e.g. batch=1 decode
    # cannot shard batch; shard the KV-cache sequence instead)
    rule_overrides: Optional[Dict[str, object]] = None


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    # prefill emits a cache: shard its seq ("kv") over model so no device
    # holds a replicated 32k cache
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill",
                               rule_overrides={"kv": "model"}),
    # decode: cache seq sharded over model (kv head counts rarely divide 16)
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode",
                              rule_overrides={"kv": "model", "seq": None,
                                              "kv_heads": None}),
    # batch=1: nothing to DP; shard the long cache seq over data instead
    "long_500k": ShapeConfig(
        "long_500k", 524288, 1, "decode",
        rule_overrides={"batch": None, "kv": "data", "seq": None,
                        "state": None}),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (arch x shape) cells run: long_500k only on sub-quadratic
    (recurrent) families."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(see DESIGN.md)")
    return True, ""


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE
