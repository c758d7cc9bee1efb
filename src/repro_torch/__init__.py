"""repro_torch — the PyTorch / CUDA (H100) port of ``repro``.

The package mirrors ``repro``'s module names so each counterpart is easy
to find, and imports neither JAX nor anything of ``repro``. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a hand-written
CUDA kernel for ``sm_90a`` (``repro_torch/kernels/csrc``), built with
``nvcc`` at first use. Each kernel wrapper runs its plain PyTorch version
for CPU tensors (the CPU tests) and launches the kernel for CUDA tensors.

Ported so far: the serving path of ``launch/serve.py`` for the dense
decoder family (qwen1.5-0.5B): prefill flash attention, contiguous and
paged decode attention, the paged KV runtime and both schedulers; the
whole-layer decode graph (``--layer-graph``); the library entry points of
``ops`` (``matmul``, ``gather``, ``attention``, ``decode_attention``) and
the ``attention_proj`` and ``moe_dispatch_ffn`` graphs.
"""
