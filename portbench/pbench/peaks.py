"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity), at its full power limit of 700 W."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
F32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def flops(dtype: str) -> float:
    """The peak that bounds a model served in ``dtype``."""
    return BF16_FLOPS if dtype in ("bfloat16", "float16") else F32_FLOPS
