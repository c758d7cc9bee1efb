"""Mesh-aware streams: run the kernel stack on each rank's local shards
(the port of ``repro/runtime/streams.py``).

The reference's ``shard_map`` becomes ``DTensor.to_local`` /
``DTensor.from_local``: the body sees each rank's *local shard shapes*,
so the planner sizes every pipe against the per-shard word schedule.

* :func:`mesh_policy` tags a :class:`~repro_torch.core.program.PipePolicy`
  with the ambient mesh topology (:class:`~repro_torch.core.meshspec.MeshSpec`),
  so every plan and tuned-plan cache entry resolved under it is scoped to
  the topology: plans never leak across meshes;
* :func:`shard_streams` wraps any kernel callable (a ``repro_torch.ops``
  entry point, a whole model step) so that each rank calls it on its local
  shards with the mesh-tagged policy as the session default.

A spec is a tuple of DTensor placements, one per mesh dimension (what
``runtime.sharding.spec_for`` returns). Example, a registry kernel under a
4-way data mesh (on each of the 4 ranks)::

    mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("data",))
    with sharding.use_sharding(mesh):
        f = shard_streams(repro_torch.ops.matmul,
                          in_specs=((Shard(0),), (Replicate(),)),
                          out_specs=(Shard(0),))
        y = f(a, b)       # each rank plans (and caches) at local shapes
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.core.meshspec import MeshSpec
from repro_torch.core.program import PipePolicy, current_policy
from repro_torch.core.program import policy as policy_ctx
from repro_torch.runtime import sharding as shlib


def mesh_policy(policy: Optional[PipePolicy] = None,
                ctx: Optional[shlib.ShardingContext] = None) -> PipePolicy:
    """Tag a policy with the mesh topology it will run under.

    ``policy`` defaults to the session policy, ``ctx`` to the ambient
    :class:`~repro_torch.runtime.sharding.ShardingContext`. Without a mesh
    source the policy is returned unchanged (single-device call sites need
    no tag); a policy that already names a mesh keeps it.
    """
    pol = current_policy() if policy is None else policy
    ctx = ctx or shlib.current()
    if pol.mesh is not None or ctx is None:
        return pol
    return pol.replace(mesh=MeshSpec.from_mesh(ctx.mesh))


def local_shard(x, mesh, spec):
    """This rank's shard of ``x`` under ``spec``: a DTensor is
    redistributed there and its local tensor taken; a plain tensor is
    taken as the full tensor every rank holds, and sliced (no
    collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, spec).to_local()
    return distribute_tensor(x, mesh, spec, src_data_rank=None).to_local()


def shard_streams(fn: Callable[..., Any], *, in_specs, out_specs,
                  ctx: Optional[shlib.ShardingContext] = None,
                  mesh=None, policy: Optional[PipePolicy] = None
                  ) -> Callable[..., Any]:
    """Wrap a kernel callable so each rank runs it on its local shards.

    The mesh comes from ``mesh``, else ``ctx``, else the ambient
    :func:`repro_torch.runtime.sharding.use_sharding` context. Inside the
    body the session policy is ``policy`` (default: the current session
    policy) tagged with that mesh, so the planner sizes pipes against the
    local shard shapes and every plan is cache-keyed by the topology.
    ``in_specs`` holds one spec per positional argument; ``out_specs`` is
    the output's spec (or a tuple of specs for a tuple of outputs). The
    wrapper returns DTensors built from the local outputs.
    """
    from torch.distributed.tensor import DTensor

    ctx = ctx or shlib.current()
    if mesh is None:
        if ctx is None:
            raise ValueError(
                "shard_streams: no mesh — pass mesh=/ctx= or enter "
                "repro_torch.runtime.sharding.use_sharding(mesh) first")
        mesh = ctx.mesh
    # the mesh actually running the body wins over the ambient context's
    pol = (policy or current_policy()).replace(mesh=MeshSpec.from_mesh(mesh))
    single_out = not (isinstance(out_specs, tuple) and out_specs
                      and isinstance(out_specs[0], tuple))

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_streams: {len(args)} arguments vs "
                             f"{len(in_specs)} in_specs")
        local = [local_shard(a, mesh, s) for a, s in zip(args, in_specs)]
        with policy_ctx(pol):
            out = fn(*local)
        if single_out:
            return DTensor.from_local(out, mesh, out_specs, run_check=False)
        return tuple(DTensor.from_local(o, mesh, s, run_check=False)
                     for o, s in zip(out, out_specs))

    with obs.span("shard_streams", mesh=pol.mesh.token,
                  devices=pol.mesh.device_count):
        return wrapped
