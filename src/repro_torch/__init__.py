"""repro_torch — the PyTorch / CUDA (H100) port of ``repro``.

The package mirrors ``repro``'s module names so each counterpart is easy
to find, and imports neither JAX nor anything of ``repro``. Plain tensor
code is PyTorch; every Pallas kernel of the reference is a hand-written
CUDA kernel for ``sm_90a`` (``repro_torch/kernels/csrc``), built with
``nvcc`` at first use. Each kernel entry point runs its plain PyTorch
version for CPU tensors (the CPU tests) and launches the kernel for CUDA
tensors, its ring sized by the pipe policy.

Public API surface (lazily imported, so ``import repro_torch`` stays
cheap):

  repro_torch.ops.<name>(...)   registry-generated kernel entry points
                                (matmul, attention, decode_attention,
                                chunk_scan, gather)
  repro_torch.PipePolicy        the pipe policy dataclass
  repro_torch.policy(...)       session-default policy context manager
  repro_torch.current_policy()  the active policy
  repro_torch.MeshSpec          the topology of plan keys
  repro_torch.plans             the plan service: traffic recording,
                                offline sweeps, mergeable PlanDB artifacts
  repro_torch.obs               spans, metrics, bandwidth accounting
"""

_LAZY = {
    "PipePolicy": ("repro_torch.core.program", "PipePolicy"),
    "policy": ("repro_torch.core.program", "policy"),
    "current_policy": ("repro_torch.core.program", "current_policy"),
    "MeshSpec": ("repro_torch.core.meshspec", "MeshSpec"),
    "ops": ("repro_torch.ops", None),
    "plans": ("repro_torch.plans", None),
    "obs": ("repro_torch.obs", None),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_name)
    return mod if attr is None else getattr(mod, attr)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
