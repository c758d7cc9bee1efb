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

The other half is the reference's StreamProgram IR on the host: a kernel
*declared* as producer stages (:class:`Stream` edges, :class:`BlockIn` and
:class:`ScalarIn` operands) feeding a consumer, with its block schedules
(``out_schedule``, ``stream_schedule``) as pure Python on ints, the same
tuples as the reference's, so the graph fuser (:mod:`repro_torch.core.
graph`) reads the same legality from them. A declaration carries no body:
``StreamProgram.kernel`` names the hand-written launch it stands for
(``kernels/csrc``), with the launch's keyword arguments, and
:func:`compile_program` binds that launch to the program's shapes. The
port has no generic emitter: a program naming a launch the port has not
written is refused. The reference's ``interpret`` field has no meaning
here either and is left out: which version runs is chosen by the tensors'
device (CPU tensors run the plain PyTorch version, CUDA tensors the
kernel), and ``mode="ref"`` runs the plain version on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect
import math
import threading
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core import planner
from repro_torch.core.meshspec import MeshSpec, resolve_sharding
from repro_torch.core.pipe import Pipe, dtype_name, itemsize
from repro_torch.core.pipeline_model import H100_SXM, HardwareModel, \
    Workload


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


# ---------------------------------------------------------------------------
# The StreamProgram IR (declarations and their block schedules)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stream:
    """A producer stage and its pipe edge: operand ``name`` streams from
    device memory into the ring ``spec`` describes.

    ``gather=True`` marks an irregular per-row stream (data-dependent
    addresses). ``index`` declares a regular stream's block schedule for
    the graph fuser: ``index(word) -> block-index tuple`` names which tile
    of the operand word ``word`` consumes, in the operand's own ``tile``
    blocking, a pure function of the word index on Python ints, exactly the
    reference's. A gather declares none, so an edge into it stages.
    """

    name: str
    spec: Pipe
    gather: bool = False
    index: Optional[Callable[..., Tuple[int, ...]]] = None


@dataclasses.dataclass(frozen=True)
class BlockIn:
    """A block-delivered (non-streamed) operand: its ``block`` shape and
    ``index_map(word, *scalars)`` block schedule; ``dtype`` sizes its ring
    where a fused graph would promote it to a stream."""

    name: str
    block: Tuple[int, ...]
    index_map: Callable[..., Any]
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class ScalarIn:
    """A scalar-prefetched operand (index and length vectors)."""

    name: str


@dataclasses.dataclass(frozen=True)
class ScratchSpec:
    """One consumer-owned carry of the declaration (accumulators etc.),
    counted in a fused chain's declared footprint."""

    name: str
    shape: Tuple[int, ...]
    dtype: Any = torch.float32


InputSpec = Union[Stream, BlockIn, ScalarIn]


class ScheduleOpaqueError(ValueError):
    """A block schedule could not be evaluated statically (an index map
    that reads a scalar operand, or a stream with no declared ``index``).
    The graph fuser stages such an edge, with this as its rationale."""


class _OpaqueScalar:
    """Stand-in for a scalar operand during static schedule evaluation:
    any attempt to *read* it proves the schedule is data-dependent."""

    def _opaque(self, *_, **__):
        raise ScheduleOpaqueError(
            "schedule depends on a scalar-prefetch operand (data-dependent)")

    __getitem__ = __getattr__ = __index__ = __int__ = _opaque
    __add__ = __radd__ = __mul__ = __rmul__ = _opaque
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _opaque


@dataclasses.dataclass(frozen=True)
class StreamProgram:
    """A kernel declared as producer stages -> pipes -> consumer.

    Attributes:
      name: op name (planner key; the reference's ``name``).
      n_words: trip count of the word schedule.
      inputs: call-ordered operand specs, ScalarIn first (the reference's
        scalar-prefetch convention).
      kernel: the hand-written launch the program stands for (a key of
        :data:`LAUNCHES`); ``kernel_kwargs`` are its keyword arguments.
      out_shape / out_dtype / out_block / out_index_map: the output block
        mapping, as the reference declares it.
      scratch: consumer-owned carries of the declaration.

    Where a hand-written kernel tiles otherwise than the reference's
    program, the declaration keeps the reference's block schedule (its
    tiles decide which graph edges are legal to fuse), and the launch
    chooses its own tiles.
    """

    name: str
    n_words: int
    inputs: Tuple[InputSpec, ...]
    kernel: str
    out_shape: Tuple[int, ...]
    out_dtype: Any
    out_block: Tuple[int, ...]
    out_index_map: Callable[..., Any]
    scratch: Tuple[ScratchSpec, ...] = ()
    kernel_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        names = [i.name for i in self.inputs] + [s.name for s in self.scratch]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate operand/scratch names "
                             f"in {names}")
        seen_tensor = False
        for i in self.inputs:
            if isinstance(i, ScalarIn):
                if seen_tensor:
                    raise ValueError(
                        f"{self.name}: ScalarIn operands must precede tensor "
                        f"operands (the scalar-prefetch convention)")
            else:
                seen_tensor = True
        if not self.streams:
            raise ValueError(f"{self.name}: a StreamProgram needs at least "
                             f"one Stream edge")
        if self.n_words < 1:
            raise ValueError(f"{self.name}: n_words must be >= 1")

    @property
    def streams(self) -> Tuple[Stream, ...]:
        return tuple(i for i in self.inputs if isinstance(i, Stream))

    @property
    def num_scalar_prefetch(self) -> int:
        return sum(isinstance(i, ScalarIn) for i in self.inputs)

    @property
    def smem_bytes(self) -> int:
        """Ring bytes of all pipe edges as declared (the reference's
        ``vmem_bytes``, on the port's shared-memory :class:`Pipe`)."""
        return sum(s.spec.smem_bytes for s in self.streams)

    def stream(self, name: str) -> Stream:
        for s in self.streams:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: no stream {name!r}; streams: "
                       f"{[s.name for s in self.streams]}")

    def out_schedule(self) -> Tuple[Tuple[int, ...], ...]:
        """The output block schedule: ``out_index_map`` evaluated per word.
        Raises :class:`ScheduleOpaqueError` when the map reads a scalar
        operand (data-dependent output placement)."""
        dummies = (_OpaqueScalar(),) * self.num_scalar_prefetch
        sched = []
        for g in range(self.n_words):
            try:
                idx = self.out_index_map(g, *dummies)
                sched.append(tuple(int(i) for i in idx))
            except ScheduleOpaqueError:
                raise
            except Exception as e:   # noqa: BLE001 — map not int-evaluable
                raise ScheduleOpaqueError(
                    f"{self.name}: out_index_map is not statically "
                    f"evaluable at word {g}: {type(e).__name__}: {e}") from e
        return tuple(sched)

    def stream_schedule(self, name: str) -> Tuple[Tuple[int, ...], ...]:
        """Stream ``name``'s declared block schedule, one tuple per word;
        :class:`ScheduleOpaqueError` for a stream declaring no ``index``."""
        st = self.stream(name)
        if st.index is None:
            raise ScheduleOpaqueError(
                f"{self.name}: stream {name!r} declares no block schedule "
                f"(Stream.index); its addresses are data-dependent")
        try:
            return tuple(tuple(int(i) for i in st.index(g))
                         for g in range(self.n_words))
        except ScheduleOpaqueError:
            raise
        except Exception as e:   # noqa: BLE001
            raise ScheduleOpaqueError(
                f"{self.name}: stream {name!r} index is not statically "
                f"evaluable: {type(e).__name__}: {e}") from e


def program_workload(program: StreamProgram) -> Workload:
    """A conservative analytic Workload from a program's streams (words,
    bytes a word, regularity, stores a word), as the reference's."""
    store = (float(math.prod(program.out_shape))
             * itemsize(program.out_dtype)) / program.n_words
    return Workload(
        n_words=program.n_words,
        word_bytes=float(sum(s.spec.word_bytes for s in program.streams)),
        flops_per_word=0.0,
        regular=not any(s.gather for s in program.streams),
        store_bytes_per_word=store,
    )


def _clamped_streams(tile0: int, streams: int) -> int:
    """Largest power-of-two-reduced stream count dividing the tile's
    leading dim (the planner's global choice refined per stream)."""
    s = max(1, int(streams))
    while s > 1 and tile0 % s:
        s //= 2
    return max(1, s)


# ---------------------------------------------------------------------------
# Binding a declaration to its hand-written launch
# ---------------------------------------------------------------------------

# kernel name -> "module:function" of its launch, imported on first use:
# ``launch(program, operands: {input name: tensor}, policy) -> tensor``
LAUNCHES: Dict[str, str] = {
    "ff_attention": "repro_torch.kernels.ff_attention.program:launch",
    "ff_decode_attention":
        "repro_torch.kernels.ff_decode_attention.program:launch",
    "ff_paged_decode_attention":
        "repro_torch.kernels.ff_decode_attention.program:launch_paged",
    "ff_gather": "repro_torch.kernels.ff_gather.program:launch",
    "ff_matmul": "repro_torch.kernels.ff_matmul.program:launch",
    "ff_layer_matmul": "repro_torch.kernels.ff_layer.program:launch_matmul",
    "ff_layer_swiglu": "repro_torch.kernels.ff_layer.program:launch_swiglu",
    "ff_chunk_scan": "repro_torch.kernels.ff_chunk_scan.program:launch",
}


# the epilogues each kernel implements (a graph node's Epilogue names one)
EPILOGUES: Dict[str, Tuple[str, ...]] = {
    "ff_layer_matmul": ("residual", "rope_bias"),
}


def launch_for(program: StreamProgram) -> Callable[..., Any]:
    """The launch ``program.kernel`` names; a clear error where the port
    has none (it has no generic emitter to lower a declaration with), or
    where the program carries an epilogue its kernel does not implement."""
    target = LAUNCHES.get(program.kernel)
    if target is None:
        raise NotImplementedError(
            f"{program.name}: the port has no hand-written kernel "
            f"{program.kernel!r} to launch this program with (it has no "
            f"generic emitter); written: {sorted(LAUNCHES)}")
    epi = program.kernel_kwargs.get("epilogue")
    if epi is not None and epi not in EPILOGUES.get(program.kernel, ()):
        raise NotImplementedError(
            f"{program.name}: kernel {program.kernel!r} implements no "
            f"epilogue {epi!r} (it implements "
            f"{EPILOGUES.get(program.kernel, ())})")
    module, fn = target.split(":")
    return getattr(importlib.import_module(module), fn)


def compile_program(program: StreamProgram, *,
                    pipe_overrides: Optional[Mapping[str, Pipe]] = None,
                    policy: Optional[PipePolicy] = None, sharding=None):
    """Bind ``program`` to its hand-written launch at its shapes.

    Returns a callable taking the program's operands in ``inputs`` order,
    which launches the kernel ``program.kernel`` names through the same
    policy-taking entry point ``repro_torch.ops`` exposes (on CPU tensors
    its plain version). ``policy`` (default: the session policy) sizes the
    ring as the entry point sizes it; ``sharding`` (a ShardingContext or a
    MeshSpec; None: the ambient one) tags it with the mesh, so its plan is
    keyed by the topology. ``pipe_overrides`` pins the ring instead: the
    port's kernels run one ring a launch, so every override must name the
    same ``depth`` and ``streams``, and keep its stream's tile and type
    (a different tile is a different program)."""
    run = launch_for(program)
    if policy is not None and pipe_overrides is not None:
        raise TypeError(f"{program.name}: pass either policy= or "
                        f"pipe_overrides=, not both")
    pol = current_policy() if policy is None else policy
    if pipe_overrides:
        specs = {s.name: s.spec for s in program.streams}
        rings = set()
        for name, pipe in pipe_overrides.items():
            if name not in specs:
                raise KeyError(f"{program.name}: pipe override for unknown "
                               f"stream {name!r}; streams: {sorted(specs)}")
            old = specs[name]
            if tuple(pipe.tile) != tuple(old.tile) or \
                    dtype_name(pipe.dtype) != dtype_name(old.dtype):
                raise ValueError(
                    f"{program.name}: pipe override for {name!r} must keep "
                    f"tile/dtype ({old.tile}, {dtype_name(old.dtype)}); "
                    f"rebuild the program for a different tile")
            rings.add((pipe.depth, pipe.streams))
        if len(rings) != 1:
            raise ValueError(f"{program.name}: the port's kernels run one "
                             f"ring a launch; overrides ask for {rings}")
        (depth, streams), = rings
        pol = pol.replace(mode="ff" if pol.mode == "autotune" else pol.mode,
                          depth=depth, streams=streams)
    if sharding is not None or pol.mesh is None:
        mesh, _ = resolve_sharding(sharding if sharding is not None
                                   else pol.mesh)
        if mesh.device_count > 1:
            pol = pol.replace(mesh=mesh)
    names = tuple(i.name for i in program.inputs)

    def call(*operands):
        if len(operands) != len(names):
            raise TypeError(f"{program.name}: expected {len(names)} "
                            f"operands {list(names)}, got {len(operands)}")
        return run(program, dict(zip(names, operands)), pol)

    call.policy = pol
    return call
