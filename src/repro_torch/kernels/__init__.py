"""Hand-written CUDA kernels of the port and their wrappers.

Each kernel module holds, side by side: the wrapper (checks its inputs,
runs the plain PyTorch version for CPU tensors, launches the kernel for
CUDA tensors and counts the launch in ``<wrapper>.launches``), the plain
version, and a note on which TPU kernel it replaces. The CUDA sources are
in ``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first
use.
"""
