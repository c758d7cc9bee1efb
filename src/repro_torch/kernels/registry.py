"""Kernel registry: one KernelSpec per ff_* op, a single interface for the
planner, the generated ``repro_torch.ops`` namespace, the plan sweep and the
tests (the port of ``repro/kernels/registry.py``).

Each kernel package registers itself at import time with
:func:`register_kernel` under the reference's name and alias, declaring:

  op           public entry point generated by
               :func:`repro_torch.core.program.make_entrypoint` — accepts
               ``policy=PipePolicy(...)``, the session
               ``repro_torch.policy`` context, and the per-kernel
               ``mode``/``depth``/``streams`` keywords
  alias        short name exposed as ``repro_torch.ops.<alias>``
  ref          the plain PyTorch version
  cost         the port's own cost model -> KernelCost
  workload     Workload builder: call-site shapes -> (core.Workload, tile),
               the planner's input, in the port's own words
  make_inputs  tiny-input builder ``make_inputs(gen, device)``
  tile_options tile overrides the measured autotuner may search (only
               knobs the port's kernel really takes; ``()`` where none)
  sweep_inputs ``sweep_inputs(gen, site, device) -> (args, kwargs)``:
               operands at a recorded call-site shape (the plan sweep)
  shard_dims   the data-parallel decomposition: per positional operand the
               dim it shards along under a data mesh axis, or None for a
               replicated operand (weights, tables); ``shard_out_dim`` is
               the output's. :func:`run_sharded_smoke` builds on it; None
               opts the kernel out of the sharded harness

Left out of the reference's spec: ``program`` (its StreamProgram builder
hook): each kernel package's ``program.py`` declares the reference's
programs (``build_program`` and kin), which ``core/program.py``
``compile_program`` binds to the hand-written launch.

Registration is lazy: the five built-in packages are imported on first
lookup, so ``import repro_torch.kernels.registry`` alone stays cheap.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Cost of one kernel call by the kernel's own schedule: operations,
    device-memory bytes, and the shared memory of one block's ring."""

    flops: float
    hbm_bytes: float
    smem_bytes: int


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel. ``bench_kwargs`` is a shape point accepted by
    both ``cost`` and ``workload``."""

    name: str
    alias: str
    op: Callable[..., Any]
    ref: Callable[..., Any]
    cost: Callable[..., KernelCost]
    workload: Callable[..., Tuple[Any, Tuple[int, ...]]]
    make_inputs: Callable[..., Tuple[tuple, dict]]
    bench_kwargs: Mapping[str, Any]
    tile_options: Tuple[Mapping[str, Any], ...] = ()
    regular: bool = True
    tol: float = 1e-4
    doc: str = ""
    sweep_inputs: Optional[Callable[..., Tuple[tuple, dict]]] = None
    shard_dims: Optional[Tuple[Optional[int], ...]] = None
    shard_out_dim: int = 0


_REGISTRY: Dict[str, KernelSpec] = {}
_VERSION = 0    # bumped on every (re-)registration; lets caches invalidate

_BUILTIN = (
    "repro_torch.kernels.ff_matmul.ops",
    "repro_torch.kernels.ff_attention.ops",
    "repro_torch.kernels.ff_decode_attention.ops",
    "repro_torch.kernels.ff_chunk_scan.ops",
    "repro_torch.kernels.ff_gather.ops",
)


def register_kernel(**fields) -> KernelSpec:
    """Register one kernel (keyword form of KernelSpec). Re-registration
    under the same name replaces the entry (supports module reloads)."""
    global _VERSION
    spec = KernelSpec(**fields)
    _REGISTRY[spec.name] = spec
    _VERSION += 1
    return spec


def registry_version() -> int:
    """Monotonic counter of (re-)registrations, for cache invalidation."""
    return _VERSION


def _ensure_loaded() -> None:
    for mod in _BUILTIN:
        importlib.import_module(mod)


def kernel_names() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def all_kernels() -> Tuple[KernelSpec, ...]:
    _ensure_loaded()
    return tuple(_REGISTRY[n] for n in sorted(_REGISTRY))


def get_kernel(name: str) -> KernelSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# ---------------------------------------------------------------------------
# Graph registry: the port's fused launches and launch chains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """One registered multi-kernel graph.

    ``op`` is the policy-accepting entry point, which resolves its plan
    through ``autotune.resolve_graph`` at the call site's shapes;
    ``make_inputs(gen, device)`` returns its operands; ``ref`` is the plain
    version over the same operands; ``unfused`` runs the same computation
    as separate ``repro_torch.ops`` calls. ``build(**shapes)`` declares the
    graph as a StreamGraph (the reference's builder, same name and
    defaults) for :func:`~repro_torch.core.graph.compile_graph`;
    ``graph_args(*args, **kwargs)`` turns ``op``'s operands into ``(build
    keywords, the compiled graph's operands, a view of its output as
    op's)``, so the compiled graph launches what ``op`` launches.
    """

    name: str
    op: Callable[..., Any]
    make_inputs: Callable[..., tuple]
    ref: Callable[..., Any]
    unfused: Optional[Callable[..., Any]] = None
    tile_options: Tuple[Mapping[str, Any], ...] = ()
    tol: float = 1e-4
    doc: str = ""
    sweep_inputs: Optional[Callable[..., Tuple[tuple, dict]]] = None
    build: Optional[Callable[..., Any]] = None
    graph_args: Optional[Callable[..., tuple]] = None


_GRAPHS: Dict[str, GraphSpec] = {}

_BUILTIN_GRAPHS = (
    "repro_torch.models.moe",
    "repro_torch.models.layers",
    "repro_torch.runtime.paged_kv",
)


def register_graph(**fields) -> GraphSpec:
    """Register one multi-kernel graph (keyword form of GraphSpec)."""
    global _VERSION
    spec = GraphSpec(**fields)
    _GRAPHS[spec.name] = spec
    _VERSION += 1
    return spec


def _ensure_graphs_loaded() -> None:
    for mod in _BUILTIN_GRAPHS:
        importlib.import_module(mod)


def graph_names() -> Tuple[str, ...]:
    _ensure_graphs_loaded()
    return tuple(sorted(_GRAPHS))


def all_graphs() -> Tuple[GraphSpec, ...]:
    _ensure_graphs_loaded()
    return tuple(_GRAPHS[n] for n in sorted(_GRAPHS))


def get_graph(name: str) -> GraphSpec:
    _ensure_graphs_loaded()
    if name not in _GRAPHS:
        raise KeyError(
            f"unknown graph {name!r}; registered: {sorted(_GRAPHS)}")
    return _GRAPHS[name]


def run_graph(spec: GraphSpec, args: tuple, *, policy=None, **kwargs):
    """Run a registered graph under ``policy`` (default: the session's):
    mode="ref" runs the plain version, everything else the entry point,
    which resolves the joint plan (measured policies through the
    graph-keyed tuner)."""
    from repro_torch.core.program import current_policy

    policy = current_policy() if policy is None else policy
    if policy.mode == "ref":
        return spec.ref(*args, **kwargs)
    return spec.op(*args, policy=policy, **kwargs)


def compile_spec(spec: GraphSpec, args: tuple, *, policy=None,
                 prefer: Optional[str] = None, **kwargs):
    """``spec``'s StreamGraph at the shapes of ``op``'s operands ``args``,
    compiled: ``(CompiledGraph, its operands, a view of its output as
    op's)``."""
    from repro_torch.core.graph import compile_graph

    build_kw, operands, view = spec.graph_args(*args, **kwargs)
    cg = compile_graph(spec.build(**build_kw), policy=policy, prefer=prefer)
    return cg, operands, view


def run_graph_smoke(spec: GraphSpec, *, policy=None,
                    prefer: Optional[str] = None, seed: int = 0,
                    device="cpu"):
    """Compile ``spec``'s StreamGraph at its declared shapes on ``device``
    and run it against its plain version. Returns ``(out, ref,
    max_abs_err, compiled)``, as the reference's: ``compiled`` is the
    :class:`~repro_torch.core.graph.CompiledGraph` (its ``plan`` holds the
    per-edge decisions). ``compiled.report`` holds what the port checks
    beside it: the graph's name and doc, its staged composition's output
    (``unfused``: the same computation as separate ``repro_torch.ops``
    calls, None if the graph declares none), whether the compiled graph
    equals it bit for bit, and the two errors against the plain
    version."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    args = spec.make_inputs(gen, torch.device(device))
    cg, operands, view = compile_spec(spec, args, policy=policy,
                                      prefer=prefer)
    out = view(cg(*operands))
    ref = spec.ref(*args)
    staged = spec.unfused(*args) if spec.unfused is not None else None
    cg.report = {
        "graph": spec.name,
        "doc": spec.doc,
        "fused_err": _max_err(out, ref),
        "staged": staged,
        "staged_err": None if staged is None else _max_err(staged, ref),
        "fused_equals_staged": None if staged is None
        else bool(torch.equal(out, staged)),
    }
    return out, ref, cg.report["fused_err"], cg


def _max_err(out, ref) -> float:
    if not out.numel():
        return 0.0
    return float((out.float() - ref.float()).abs().max())


def run_smoke(spec: KernelSpec, *, policy=None, depth=None, streams=None,
              seed: int = 0, device="cpu"):
    """Run ``spec`` at its tiny smoke shapes against its plain version on
    ``device``. Exercises the planned path by default (depth/streams
    "auto"). Pass ``policy=PipePolicy(...)`` to pin a mode or sizing, or
    depth/streams to build one — mixing both raises, like the entry
    points. Returns (out, ref, max_abs_err)."""
    import torch

    from repro_torch.core.program import PipePolicy

    legacy = {k: v for k, v in (("depth", depth), ("streams", streams))
              if v is not None}
    if policy is None:
        policy = PipePolicy(mode="ff", depth=legacy.get("depth", "auto"),
                            streams=legacy.get("streams", "auto"))
    elif legacy:
        raise TypeError(
            f"run_smoke({spec.name}): pass either policy= or the "
            f"{sorted(legacy)} keywords, not both")
    gen = torch.Generator(device=device).manual_seed(seed)
    args, kw = spec.make_inputs(gen, torch.device(device))
    out = spec.op(*args, **kw, policy=policy)
    ref = spec.op(*args, **kw, policy=PipePolicy(mode="ref"))
    return out, ref, _max_err(out, ref)


# ---------------------------------------------------------------------------
# The sharded harness
# ---------------------------------------------------------------------------


def sharded_inputs(spec: KernelSpec, n_shards: int, seed: int = 0,
                   device="cpu") -> Tuple[tuple, dict]:
    """Global operands for an ``n_shards``-way sharded run of ``spec``.

    Shard ``i``'s slice is the kernel's smoke inputs drawn from seed
    ``seed + i``, concatenated along the declared ``shard_dims``;
    replicated operands (dim ``None``) come from shard 0. Every built-in
    kernel is row-independent along its shard dim, so the global call
    over the concatenation equals the per-shard calls."""
    import torch

    if spec.shard_dims is None:
        raise ValueError(f"{spec.name} declares no shard_dims")
    per = [spec.make_inputs(torch.Generator(device=device).manual_seed(
        seed + i), torch.device(device)) for i in range(n_shards)]
    kw = per[0][1]
    args = []
    for j, dim in enumerate(spec.shard_dims):
        if dim is None:
            args.append(per[0][0][j])
        else:
            args.append(torch.cat([p[0][j] for p in per], dim=dim))
    return tuple(args), kw


def shard_partition_specs(spec: KernelSpec, args: tuple, out_ndim: int,
                          mesh, axis_name: str = "data"):
    """(in_specs, out_spec): each operand's DTensor placements on ``mesh``
    (``Shard`` along its ``shard_dims`` entry over ``axis_name``,
    ``Replicate`` elsewhere), and the output's (along
    ``shard_out_dim``)."""
    from torch.distributed.tensor import Replicate, Shard

    if spec.shard_dims is None:
        raise ValueError(f"{spec.name} declares no shard_dims")
    names = list(mesh.mesh_dim_names)

    def placements(dim):
        out = [Replicate() for _ in names]
        if dim is not None:
            out[names.index(axis_name)] = Shard(dim)
        return tuple(out)

    return (tuple(placements(d) for d in spec.shard_dims),
            placements(spec.shard_out_dim))


def run_sharded_smoke(spec: KernelSpec, mesh, *, axis_name: str = "data",
                      policy=None, seed: int = 0):
    """Run ``spec`` on every rank of ``mesh`` against the unsharded op and
    its plain version (each rank calls it; the operands live on the mesh's
    device type).

    Each rank draws the global operands from ``seed`` (shard ``i`` from
    ``seed + i``, :func:`sharded_inputs`) and calls the op on its own
    slice along ``shard_dims`` (``runtime.streams.shard_streams``) under
    the policy tagged with ``mesh``'s topology, so the planner sizes the
    per-shard call and keys its plan by the topology. Returns ``(sharded,
    unsharded, ref, max |sharded-unsharded|, max |sharded-ref|)``: the
    whole outputs as float32 CPU tensors and two floats."""
    from repro_torch.core.meshspec import MeshSpec
    from repro_torch.core.program import PipePolicy
    from repro_torch.runtime.streams import shard_streams

    n_shards = mesh.size(list(mesh.mesh_dim_names).index(axis_name))
    args, kw = sharded_inputs(spec, n_shards, seed, mesh.device_type)
    policy = PipePolicy() if policy is None else policy
    # the explicit per-call policy bypasses the session policy the
    # shard_streams wrapper installs, so it carries the mesh tag itself
    policy = policy.replace(mesh=MeshSpec.from_mesh(mesh))

    out0 = spec.op(*args, **kw, policy=policy.replace(mesh=None))
    in_specs, out_spec = shard_partition_specs(spec, args, out0.ndim, mesh,
                                               axis_name)
    f = shard_streams(lambda *a: spec.op(*a, **kw, policy=policy),
                      in_specs=in_specs, out_specs=out_spec, mesh=mesh)
    sharded = f(*args).full_tensor()
    ref = spec.op(*args, **kw, policy=PipePolicy(mode="ref"))
    sh, un, rf = (t.float().cpu() for t in (sharded, out0, ref))
    return sh, un, rf, _max_err(sh, un), _max_err(sh, rf)
