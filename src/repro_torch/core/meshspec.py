"""Mesh topology as a planner input: :class:`MeshSpec` (the port of
``repro/core/meshspec.py``).

A plan sized under one topology must never be served to a call site running
under another, and a kernel running inside ``shard_streams`` works on
per-shard local shapes, not the global tensor. :class:`MeshSpec` is the
frozen, hashable summary of that topology (axis names and sizes, the
device count), used three ways:

* as a :class:`~repro_torch.core.program.PipePolicy` field
  (``policy.mesh``), so plans and tuned-plan cache keys are
  topology-scoped;
* as the planner's localization input: :func:`localize_workload` divides
  a global word schedule across the mesh's workload-splitting shards;
* as the ambient default: :func:`ambient_mesh` picks up the installed
  :class:`repro_torch.runtime.sharding.ShardingContext` without core ever
  importing the runtime layer at module scope.

Core stays importable without a mesh: everything degrades to
:data:`SINGLE_DEVICE` (one shard, no axes; token ``"single"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.pipeline_model import Workload


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Hashable mesh-topology summary: the ordered ``((name, size), ...)``
    axes. An empty tuple is the single-device topology."""

    axes: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        for ax in self.axes:
            name, size = ax
            if not isinstance(name, str) or int(size) < 1:
                raise ValueError(f"bad mesh axis {ax!r}")

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """Summarize a ``DeviceMesh`` (its ``mesh_dim_names`` and
        ``shape``), or anything whose ``.shape`` maps axis names to
        sizes."""
        if hasattr(mesh, "mesh_dim_names"):
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        else:
            shape = dict(mesh.shape)
        return cls(axes=tuple((str(k), int(v)) for k, v in shape.items()))

    @property
    def device_count(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n

    def axis_size(self, name: str) -> int:
        for ax, size in self.axes:
            if ax == name:
                return size
        return 1

    @property
    def token(self) -> str:
        """Cache-key component: ``"single"`` or ``"data4.model2"``."""
        if not self.axes:
            return "single"
        return ".".join(f"{name}{size}" for name, size in self.axes)


SINGLE_DEVICE = MeshSpec()


def _ambient_context():
    """The installed ShardingContext, if any (imported lazily: the runtime
    imports core, not the other way round)."""
    from repro_torch.runtime import sharding
    return sharding.current()


def ambient_mesh() -> Optional[MeshSpec]:
    """MeshSpec of the installed ambient ShardingContext, if any."""
    ctx = _ambient_context()
    return None if ctx is None else MeshSpec.from_mesh(ctx.mesh)


def resolve_mesh(mesh: Optional[MeshSpec]) -> MeshSpec:
    """The effective topology of a call site: the policy's explicit mesh,
    else the ambient ShardingContext's, else single-device."""
    if mesh is not None:
        return mesh
    return ambient_mesh() or SINGLE_DEVICE


def resolve_sharding(sharding=None) -> Tuple[MeshSpec, int]:
    """Resolve a ``sharding=`` argument to ``(MeshSpec, workload shards)``.

    Accepts a :class:`~repro_torch.runtime.sharding.ShardingContext`
    (duck-typed: anything with ``mesh`` and ``data_shards()``), a
    :class:`MeshSpec`, or ``None``, which picks up the ambient context,
    else single-device. A bare MeshSpec carries no logical rules, so its
    shard count comes from the ambient context when that context describes
    the *same* topology; otherwise every device is taken to get
    ``1/device_count`` of the word schedule.
    """
    if sharding is None:
        sharding = _ambient_context()
        if sharding is None:
            return SINGLE_DEVICE, 1
    if isinstance(sharding, MeshSpec):
        ctx = _ambient_context()
        if ctx is not None and MeshSpec.from_mesh(ctx.mesh) == sharding:
            return sharding, int(ctx.data_shards())
        return sharding, sharding.device_count
    return MeshSpec.from_mesh(sharding.mesh), int(sharding.data_shards())


def localize_workload(w: Workload, shards: int) -> Workload:
    """Per-shard view of a global word schedule: ``shards`` devices each
    stream ``ceil(n_words / shards)`` words; per-word bytes and flops are
    unchanged (the tile geometry is the same on every shard)."""
    shards = max(int(shards), 1)
    if shards == 1:
        return w
    return dataclasses.replace(w, n_words=max(-(-w.n_words // shards), 1))
