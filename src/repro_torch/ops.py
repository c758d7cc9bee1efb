"""repro_torch.ops — kernel entry points generated from the kernel registry
(the port of ``repro.ops``).

Every registered :class:`~repro_torch.kernels.registry.KernelSpec` exposes
its public op here under its short alias (and its full ``ff_*`` name)::

    from repro_torch import ops
    import repro_torch
    c = ops.matmul(a, b)                        # planner-sized pipes
    rows = ops.gather(table, idx,
                      policy=repro_torch.PipePolicy(mode="baseline"))
    with repro_torch.policy(mode="baseline"):
        y = ops.attention(q, k, v)              # session default

CUDA tensors launch the kernel; CPU tensors run its plain version. Nothing
is defined by hand: attributes resolve against the registry.
"""

from __future__ import annotations

from typing import Tuple

_cache = (-1, {})    # (registry_version, alias -> op)


def _aliases():
    from repro_torch.kernels.registry import all_kernels, registry_version

    global _cache
    version = registry_version()
    if _cache[0] != version or not _cache[1]:
        out = {}
        for spec in all_kernels():
            out[spec.alias] = spec.op
            out[spec.name] = spec.op
        # all_kernels() may itself register (lazy import) — re-read version
        _cache = (registry_version(), out)
    return _cache[1]


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    ops = _aliases()
    if name in ops:
        return ops[name]
    raise AttributeError(
        f"repro_torch.ops has no op {name!r}; registered: "
        f"{sorted(k for k in ops if not k.startswith('ff_'))}")


def names() -> Tuple[str, ...]:
    """Short aliases of every registered op."""
    return tuple(sorted(k for k in _aliases() if not k.startswith("ff_")))


def __dir__():
    return sorted(set(list(globals()) + list(_aliases()) + ["names"]))
