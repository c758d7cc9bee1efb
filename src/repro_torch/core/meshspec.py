"""Mesh topology as a planner input: :class:`MeshSpec` (the single-device
part of ``repro/core/meshspec.py``).

A plan sized under one topology must never be served to a call site running
under another, so every plan and tuned-plan key carries the topology's
token. The port has no distributed runtime yet: a policy's explicit mesh is
taken as it is, and everything else is :data:`SINGLE_DEVICE` (one card,
no axes), whose token ``"single"`` is the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


def resolve_mesh(mesh: Optional[MeshSpec]) -> MeshSpec:
    """The effective topology of a call site: the policy's explicit mesh,
    else single-device (the port has no ambient sharding context)."""
    return mesh if mesh is not None else SINGLE_DEVICE
