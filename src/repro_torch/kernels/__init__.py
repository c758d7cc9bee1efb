"""Hand-written CUDA kernels of the port and their wrappers.

Each kernel module holds, side by side: the wrapper (checks its inputs,
runs the plain PyTorch version for CPU tensors, launches the kernel for
CUDA tensors and counts the launch in ``<wrapper>.launches``), the plain
version, and a note on which TPU kernel it replaces. The CUDA sources are
in ``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first
use.
"""

import functools


def device_table(fn):
    """``fn`` (hashable arguments, a device among them -> a small tensor
    made there) cached by its arguments for real calls only. Under a fake
    mode (the dry run's ``FakeTensorMode``) the table is made afresh and
    never cached: a fake table never reaches a real call, nor a real one
    a traced call. A compiled step's capture reads the real entry its
    eager warm-up made (a copy from host memory cannot be captured)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def table(*args):
        from torch._guards import detect_fake_mode
        if detect_fake_mode() is not None:
            return fn(*args)
        return cached(*args)
    table.cache_clear = cached.cache_clear
    table.cache_info = cached.cache_info
    return table


def launch_counters():
    """Every kernel wrapper that counts its launches in ``.launches`` (a
    compiled step adds what its capture counted at each replay)."""
    from repro_torch.kernels.adamw import adamw_update
    from repro_torch.kernels.ff_attention import attention, attention_proj
    from repro_torch.kernels.ff_chunk_scan import chunk_scan
    from repro_torch.kernels.ff_decode_attention import decode_attention
    from repro_torch.kernels.ff_gather import gather
    from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                              ff_layer_mlp_tail,
                                              ff_layer_swiglu)
    from repro_torch.kernels.ff_matmul import dispatch_matmul, matmul
    from repro_torch.runtime.paged_kv import paged_decode_attention
    return (adamw_update, attention, attention_proj, chunk_scan,
            decode_attention, gather, ff_layer_matmul, ff_layer_mlp_tail, ff_layer_swiglu,
            dispatch_matmul, matmul, paged_decode_attention)
