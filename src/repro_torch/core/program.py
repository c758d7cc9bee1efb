"""The pipe policy of every kernel call: :class:`PipePolicy`, the session
default (:func:`policy`), and the entry-point wrapper (the policy half of
``repro/core/program.py``).

Sizing and mode selection ride one frozen :class:`PipePolicy` (``mode`` /
``depth`` / ``streams`` / ``hw`` / ``stream_options`` / ``mesh``),
threaded through the planner (:func:`repro_torch.core.planner.
resolve_policy`) and the measured tuner (:func:`repro_torch.core.autotune.
resolve_call`). Session defaults are set with :func:`policy`::

    with repro_torch.policy(mode="baseline"):   # the paper's strawman
        y = repro_torch.ops.attention(q, k, v)
    with repro_torch.policy(hw=ARRIA_CX):       # plan for the paper's board
        y = repro_torch.ops.matmul(a, b)

Per-kernel ``depth=`` / ``streams=`` / ``mode=`` keywords keep working
through :func:`resolve_call_policy`, which folds them into a PipePolicy and
warns once per op, as the reference's.

The other half of the reference's module, the StreamProgram IR and
``compile_program`` (its Pallas lowering through the ring-pipe emitter), has
no counterpart: each kernel of the port is written by hand
(``kernels/csrc``), with ``depth`` and ``streams`` as its arguments. The
reference's ``interpret`` field has no meaning here either and is left out:
which version runs is chosen by the tensors' device (CPU tensors run the
plain PyTorch version, CUDA tensors the kernel), and ``mode="ref"`` runs
the plain version on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import threading
import warnings
from typing import Any, Callable, Optional, Tuple, Union

from repro_torch.core import planner
from repro_torch.core.meshspec import MeshSpec
from repro_torch.core.pipeline_model import H100_SXM, HardwareModel


@dataclasses.dataclass(frozen=True)
class PipePolicy:
    """How to size and run the pipes of one kernel call.

    Attributes:
      mode: "ff" (planner-sized pipes), "baseline" (the synchronous depth=1
        strawman), "ref" (the plain PyTorch version), "autotune" (like "ff"
        but (depth, streams) are *measured* per call site by
        :mod:`repro_torch.core.autotune` and served from the plan cache),
        or a kernel-specific extra mode.
      depth: ring stages — int, "auto" (planned per call site), or
        "measured" (tuned at the call site).
      streams: sub-copies a word — int, "auto", or "measured".
      hw: hardware model the planner sizes against (default the port's
        card, :data:`~repro_torch.core.pipeline_model.H100_SXM`); part of
        every plan key.
      stream_options: stream counts the planner/tuner may pick from (each
        kernel keeps those it can run).
      mesh: the topology of the call sites; ``None`` is single-device.
    """

    mode: str = "ff"
    depth: Union[int, str] = "auto"
    streams: Union[int, str] = "auto"
    hw: HardwareModel = H100_SXM
    stream_options: Tuple[int, ...] = (1, 2, 4)
    mesh: Optional[MeshSpec] = None

    def __post_init__(self):
        if not isinstance(self.mode, str):
            raise TypeError(f"mode must be a str, got {self.mode!r}")
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            raise TypeError(
                f"mesh must be a MeshSpec or None, got {self.mesh!r}")
        for label, val in (("depth", self.depth), ("streams", self.streams)):
            if isinstance(val, str):
                if val not in ("auto", "measured"):
                    raise ValueError(f"{label} must be an int, 'auto', or "
                                     f"'measured', got {val!r}")
            elif int(val) < 1:
                raise ValueError(f"pipe {label} must be >= 1, got {val!r}")

    def replace(self, **fields) -> "PipePolicy":
        return dataclasses.replace(self, **fields)

    def resolve(self, op: str, *, workload, tile, dtype) -> Tuple[int, int]:
        """Resolve this policy's (depth, streams) for one call site."""
        return planner.resolve_policy(op, self, workload=workload, tile=tile,
                                      dtype=dtype)


class _PolicyStack(threading.local):
    def __init__(self):
        self.stack = [PipePolicy()]


_policies = _PolicyStack()


def current_policy() -> PipePolicy:
    """The session's active policy (innermost :func:`policy` context)."""
    return _policies.stack[-1]


@contextlib.contextmanager
def policy(base: Optional[PipePolicy] = None, **fields):
    """Set session pipe-policy defaults without touching call sites.

    ``policy(mode="baseline")`` overrides just that field of the current
    policy; ``policy(some_policy)`` installs it wholesale (plus any field
    overrides). Nests and restores on exit; thread-local.

    Kernel entry points read the session policy at every call. A compiled
    step (``launch/steps.py``) reads it when it captures, and keys its CUDA
    graphs by it, so a later policy change captures anew.
    """
    pol = current_policy() if base is None else base
    if fields:
        pol = dataclasses.replace(pol, **fields)
    _policies.stack.append(pol)
    try:
        yield pol
    finally:
        _policies.stack.pop()


# -- deprecation shim: per-kernel keywords -> PipePolicy ----------------------

_LEGACY_KWARGS = ("mode", "depth", "streams")
_warned_ops = set()


def resolve_call_policy(op: str, call_policy: Optional[PipePolicy] = None,
                        **legacy) -> PipePolicy:
    """Fold one call's (policy=, per-kernel keywords) into the effective
    policy.

    ``policy=`` overrides the session :func:`policy` context wholesale;
    the keywords override individual fields of the session policy and warn
    once per op. Mixing ``policy=`` with keywords in one call is ambiguous
    and raises TypeError.
    """
    given = {k: v for k, v in legacy.items() if v is not None}
    unknown = set(given) - set(_LEGACY_KWARGS)
    if unknown:
        raise TypeError(f"{op}: unknown policy kwargs {sorted(unknown)}")
    base = current_policy() if call_policy is None else call_policy
    if not given:
        return base
    if call_policy is not None:
        raise TypeError(
            f"{op}: pass either policy= or the deprecated "
            f"{sorted(given)} keywords, not both")
    if op not in _warned_ops:
        _warned_ops.add(op)
        warnings.warn(
            f"{op}: the {sorted(given)} keywords are deprecated; pass "
            f"policy=PipePolicy(...) or set session defaults with "
            f"`with repro_torch.policy(...)`", DeprecationWarning,
            stacklevel=3)
    return dataclasses.replace(base, **given)


def _refuse_autograd(op: str, args, kwargs) -> None:
    """Raise where a kernel call would take part in a backward: on the
    card a kernel's output has no ``grad_fn``, so a loss through it would
    silently drop the gradient of everything upstream, while on the CPU
    the plain version differentiates. Refusing on both devices keeps the
    two the same."""
    import torch
    if not torch.is_grad_enabled():
        return
    if any(isinstance(a, torch.Tensor) and a.requires_grad
           for a in (*args, *kwargs.values())):
        raise RuntimeError(
            f"{op}: no backward kernel exists, and an input requires grad; "
            f"training runs attn_impl and scan_impl 'xla', as the "
            f"reference does (call under torch.no_grad() to run the kernel "
            f"on tensors that require grad)")


def make_entrypoint(op: str, apply_fn: Callable[..., Any],
                    modes: Tuple[str, ...] = ("ff", "baseline", "ref",
                                              "autotune"),
                    name: Optional[str] = None) -> Callable[..., Any]:
    """Generate the public op wrapper from a policy-driven apply function.

    ``apply_fn(*arrays, policy: PipePolicy, **statics)`` implements the op;
    the generated entry point accepts ``policy=``, the session policy
    context, and the per-kernel keywords (``mode``/``depth``/``streams``),
    all funneled through :func:`resolve_call_policy`. ``modes`` is the op's
    supported mode set, validated here once. The entry point keeps a
    ``launches`` count, which ``apply_fn`` adds to where it launches its
    kernel. ``op_name`` is the op (plan keys, metrics); ``__name__`` is
    ``name``, the entry point's Python name, where it differs (the
    reference names it after the op).
    """

    @functools.wraps(apply_fn)
    def entrypoint(*args, policy=None, mode=None, depth=None, streams=None,
                   **kwargs):
        pol = resolve_call_policy(op, policy, mode=mode, depth=depth,
                                  streams=streams)
        if pol.mode not in modes:
            raise ValueError(
                f"{op}: unknown mode {pol.mode!r}; supported: {modes}")
        if pol.mode != "ref":
            _refuse_autograd(op, args, kwargs)
        return apply_fn(*args, policy=pol, **kwargs)

    sig = inspect.signature(apply_fn)
    params = [p for p in sig.parameters.values() if p.name != "policy"]
    params += [inspect.Parameter(name, inspect.Parameter.KEYWORD_ONLY,
                                 default=None)
               for name in ("policy", "mode", "depth", "streams")]
    entrypoint.__signature__ = sig.replace(parameters=params)
    entrypoint.op_name = op
    entrypoint.__name__ = name or op
    entrypoint.__qualname__ = name or op
    entrypoint.launches = 0
    return entrypoint
