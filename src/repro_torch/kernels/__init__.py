"""Hand-written CUDA kernels of the port and their wrappers.

Each kernel module holds, side by side: the wrapper (checks its inputs,
runs the plain PyTorch version for CPU tensors, launches the kernel for
CUDA tensors and counts the launch in ``<wrapper>.launches``), the plain
version, and a note on which TPU kernel it replaces. The CUDA sources are
in ``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first
use.
"""


def launch_counters():
    """Every kernel wrapper that counts its launches in ``.launches`` (a
    compiled step adds what its capture counted at each replay)."""
    from repro_torch.kernels.ff_attention import attention, attention_proj
    from repro_torch.kernels.ff_chunk_scan import chunk_scan
    from repro_torch.kernels.ff_decode_attention import decode_attention
    from repro_torch.kernels.ff_gather import gather
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_mlp_tail,
                                              ff_layer_swiglu)
    from repro_torch.kernels.ff_matmul import dispatch_matmul, matmul
    from repro_torch.runtime.paged_kv import paged_decode_attention
    return (attention, attention_proj, chunk_scan, decode_attention, gather,
            ff_layer_matmul, ff_layer_mlp_tail, ff_layer_swiglu,
            dispatch_matmul, matmul, paged_decode_attention)
