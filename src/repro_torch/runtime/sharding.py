"""Logical-axis sharding rules on a torch ``DeviceMesh`` (the port of
``repro/runtime/sharding.py``).

Model code names axes logically ("batch", "embed", "heads", "mlp", "vocab",
"expert", ...). A rule table maps logical names to mesh axes; the trainer
installs a :class:`ShardingContext`, and model code calls :func:`constrain`
on activations. Without a context every call is a no-op, so kernels and
smoke tests run unchanged on one device.

The reference's ``PartitionSpec`` becomes one ``DTensor`` placement per
mesh dimension (:func:`spec_for`): ``Shard(d)`` where the rules send
tensor dim ``d`` to that mesh axis, ``Replicate()`` elsewhere.
:func:`partition_spec` keeps the reference's per-tensor-dim form (the
tests hold the two packages' rule tables against each other with it).
``with_sharding_constraint`` becomes ``DTensor.redistribute``.

Default rules implement DP over ("pod","data") x TP/EP over "model":

  batch   -> (pod, data)     activations' global-batch dim
  embed   -> None            residual stream stays replicated across model
  heads   -> model           attention heads (TP)
  mlp     -> model           FFN hidden (TP)
  vocab   -> model           embedding/unembedding table + logits
  expert  -> model           MoE expert dim (EP), when divisible
  seq     -> None            (sequence parallelism opt-in: -> model)
  kv      -> None
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# Data parallel spans pod x data so that the same rules serve both meshes.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": None,    # Megatron-style sequence parallelism for the residual
                       # stream / layer-boundary saves (-> "model")
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "exp_cap": None,
    "ssm_heads": "model",
    "state": None,
    "layers": None,
    "frames": None,
    "patches": None,
}


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``), in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class ShardingContext:
    mesh: Any                # torch.distributed.device_mesh.DeviceMesh
    rules: Rules

    def axis_size(self, name: str) -> int:
        return mesh_shape(self.mesh).get(name, 1)

    def data_shards(self) -> int:
        """How many ways the rules split the workload's batch dim: the
        product of the mesh axes ``"batch"`` maps to (the factor
        ``core.meshspec.localize_workload`` divides a global word schedule
        by)."""
        target = self.rules.get("batch")
        if target is None:
            return 1
        tgt = (target,) if isinstance(target, str) else target
        n = 1
        for a in tgt:
            n *= self.axis_size(a)
        return n

    def mesh_spec(self):
        """This context's topology as a hashable
        :class:`repro_torch.core.meshspec.MeshSpec` (planner / plan-cache
        key)."""
        from repro_torch.core.meshspec import MeshSpec
        return MeshSpec.from_mesh(self.mesh)


_LOCAL = threading.local()


def current() -> Optional[ShardingContext]:
    return getattr(_LOCAL, "ctx", None)


def prune_rules(rules: Rules, axes) -> Rules:
    """``rules`` with every target that names no axis in ``axes`` dropped
    (e.g. "pod" on a single-pod mesh)."""
    axes = set(axes)

    def prune(target):
        if target is None:
            return None
        if isinstance(target, str):
            return target if target in axes else None
        kept = tuple(a for a in target if a in axes)
        return kept if kept else None

    return {k: prune(v) for k, v in rules.items()}


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Rules] = None,
                 overrides: Optional[Rules] = None):
    """Install a mesh and the logical rules (``DEFAULT_RULES`` updated by
    ``overrides``) for model code on this thread."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    if overrides:
        rules.update(overrides)
    ctx = ShardingContext(mesh=mesh,
                          rules=prune_rules(rules, mesh.mesh_dim_names))
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ctx
    try:
        yield ctx
    finally:
        _LOCAL.ctx = prev


def partition_spec(logical_axes: Sequence[Optional[str]],
                   ctx: Optional[ShardingContext] = None) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: per tensor dim the
    mesh axis (or tuple of axes, or None) it is sharded over, trailing
    Nones dropped. A mesh axis appears at most once."""
    ctx = ctx or current()
    if ctx is None:
        return ()
    parts = []
    used = set()
    for name in logical_axes:
        target = ctx.rules.get(name) if name is not None else None
        if target is None:
            parts.append(None)
            continue
        tgt = (target,) if isinstance(target, str) else tuple(target)
        tgt = tuple(a for a in tgt if a not in used)
        if not tgt:
            parts.append(None)
        else:
            used.update(tgt)
            parts.append(tgt if len(tgt) > 1 else tgt[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for(logical_axes: Sequence[Optional[str]],
             ctx: Optional[ShardingContext] = None,
             shape: Optional[Sequence[int]] = None) -> tuple:
    """The DTensor placements of a tensor with these logical axes: one per
    mesh dimension, ``Shard(d)`` for the tensor dim the rules send there,
    else ``Replicate()``. A dim over several mesh axes is split over them
    in mesh order (the reference's ``P(("pod", "data"))``). Given the
    tensor's ``shape``, a dim its mesh axes do not divide is replicated
    (a batch of 1 over "data" of 2), so no rank holds an empty or a
    ragged shard, and so is a dim over axes of one rank (the same bits,
    and DTensor's views keep a replicated dim of extent 1 where they
    refuse a sharded one). ``()`` without a context."""
    from torch.distributed.tensor import Replicate, Shard

    ctx = ctx or current()
    if ctx is None:
        return ()
    names = list(ctx.mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, part in enumerate(partition_spec(logical_axes, ctx)):
        axes = (part,) if isinstance(part, str) else part or ()
        n = 1
        for axis in axes:
            n *= ctx.axis_size(axis)
        if shape is not None and (n == 1 or shape[dim] % n):
            continue
        for axis in axes:
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it (the reference's
    ``jax.sharding.NamedSharding``)."""
    mesh: Any
    placements: tuple

    def place(self, full: torch.Tensor):
        """The DTensor of ``full`` under this sharding: each rank keeps its
        own shard of the same full tensor, no collective (every rank must
        hold the same ``full``)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(full, self.mesh, self.placements,
                                 src_data_rank=None)


def sharding_for(logical_axes: Sequence[Optional[str]],
                 ctx: Optional[ShardingContext] = None,
                 shape: Optional[Sequence[int]] = None
                 ) -> Optional[NamedSharding]:
    ctx = ctx or current()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, spec_for(logical_axes, ctx, shape))


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a DTensor activation to its logical sharding (no-op
    without a context). A plain tensor under a context is a rank's local
    shard (the body of ``shard_streams``) and is left as it is."""
    ctx = current()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{logical_axes} vs rank-{x.ndim} activation")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = spec_for(logical_axes, ctx, x.shape)
    if tuple(x.placements) == placements and x.device_mesh == ctx.mesh:
        return x
    return x.redistribute(ctx.mesh, placements)


def divisible(logical: str, size: int,
              ctx: Optional[ShardingContext] = None) -> bool:
    """Can axis ``logical`` of extent ``size`` be sharded under the rules?"""
    ctx = ctx or current()
    if ctx is None:
        return True
    target = ctx.rules.get(logical)
    if target is None:
        return True
    tgt = (target,) if isinstance(target, str) else target
    n = 1
    for a in tgt:
        n *= ctx.axis_size(a)
    return size % n == 0


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree):
    """``fn`` on every axes tuple of a tree (dicts and lists) of them."""
    if is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, list):
        return [map_axes(fn, v) for v in axes_tree]
    return {k: map_axes(fn, v) for k, v in axes_tree.items()}


def tree_shardings(axes_tree, ctx: Optional[ShardingContext] = None):
    """Map a tree of logical-axes tuples to NamedShardings (or None)."""
    ctx = ctx or current()
    return map_axes(lambda ax: sharding_for(ax, ctx), axes_tree)


def place_tree(tree, axes_tree, ctx: Optional[ShardingContext] = None):
    """Every tensor leaf of ``tree`` as a DTensor on its logical sharding
    (each rank must hold the same full leaves; a dim the mesh does not
    divide is replicated); the tree unchanged without a context."""
    ctx = ctx or current()
    if ctx is None:
        return tree
    if isinstance(tree, dict):
        return {k: place_tree(v, axes_tree[k], ctx) for k, v in tree.items()}
    return sharding_for(axes_tree, ctx, tree.shape).place(tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(t, like):
    """``t`` as a DTensor on ``like``'s mesh: a DTensor as it is, a plain
    tensor replicated (each rank holds the whole of it)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def kept(placements, dims):
    """``placements`` with every shard of a dim outside ``dims`` (and any
    partial sum) replaced by a replica: what a local body that needs those
    other dims whole may see."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in placements]


def batch_local(fn, batch_args, rep_args=(), n_out: int = 1):
    """``fn(*batch_args, *rep_args)``; where any operand is a DTensor, a
    local body on each rank's batch rows (a shard_map): ``batch_args``
    (each batch-major at dim 0, or None) keep the batch shards of the
    first DTensor among them and are whole along every other dim,
    ``rep_args`` (parameters) are whole on every rank, and each of the
    ``n_out`` results is batch-major, placed as the batch. Under autograd
    the parameters' gradients come back as partial sums over the batch's
    mesh dims. For a computation that flattens a sharded dim into the
    batch (the recurrent mixers' heads), which DTensor's own ops refuse."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    args = (*batch_args, *rep_args)
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    like = next(a for a in args if is_dtensor(a))
    bpl = [p if p == Shard(0) else Replicate() for p in next(
        (a for a in batch_args if is_dtensor(a)), like).placements]
    rpl = [Replicate()] * len(bpl)
    gpl = [Partial() if p == Shard(0) else Replicate() for p in bpl]
    n_b = len(batch_args)
    placed = [None if a is None else as_dtensor(a, like) for a in args]
    in_pl = tuple(None if a is None else (bpl if i < n_b else rpl)
                  for i, a in enumerate(placed))
    grad_pl = tuple(None if a is None else (bpl if i < n_b else gpl)
                    for i, a in enumerate(placed))
    body = local_map(fn, out_placements=bpl if n_out == 1
                     else (bpl,) * n_out, in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     device_mesh=like.device_mesh, redistribute_inputs=True)
    return body(*placed)


def product_operand(x):
    """``x`` ready to be the left operand of a product over its last dim:
    a DTensor sharded on more than one leading dim (a sequence-sharded
    cache or stream beside its batch shards) keeps only its batch (and
    last-dim) shards, since DTensor's product cannot take the strided
    shards of the flattened leading dims; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    lead = {p.dim for p in x.placements
            if isinstance(p, Shard) and p.dim < x.dim() - 1}
    if len(lead) <= 1:
        return x
    return x.redistribute(x.device_mesh, kept(x.placements,
                                              {0, x.dim() - 1}))


def product_output(y):
    """``y``, a product's output, with its gradient sent through
    :func:`product_operand` on its way into the product's backward: a
    cotangent sharded on more than one leading dim (a sequence sharded
    over "model" beside the batch) keeps only its batch (and last-dim)
    shards there, as the forward's left operand does. Anything but a
    DTensor that requires grad as it is."""
    if is_dtensor(y) and y.requires_grad:
        y.register_hook(product_operand)
    return y


def follow(placements, offset: int, ndim: int):
    """Placements of an operand whose dim ``j`` is dim ``j + offset`` of
    the tensor placed by ``placements``: its shards where the dim exists
    in the operand, replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        j = p.dim - offset if isinstance(p, Shard) else -1
        out.append(Shard(j) if 0 <= j < ndim else Replicate())
    return out


def full_tensor(x):
    """The whole tensor behind a DTensor (a collective on every rank of
    its mesh); any other value as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensor leaves (a DTensor counts
    its local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
