"""Pipeline parallelism over a mesh axis (the port of
``repro/runtime/pipeline_parallel.py``): the paper's pipes at pod scale,
a GPipe schedule written as a Stream producer/consumer loop.

Each rank of the axis holds a contiguous stage of layers; activations flow
stage -> stage through a :class:`StageHandoff` (the intermediate leaves
the producer stage, crosses the interconnect, and lands in the consumer
stage's buffer; one microbatch a pipe word). With M microbatches and S
stages the bubble is (S-1)/(M+S-1).

Each tick runs the acquire -> consume -> release word schedule of a kernel:

* **acquire**: stage 0 reads microbatch ``t`` from the feed; later stages
  read the handoff buffer their upstream released last tick;
* **consume**: ``stage_fn`` computes on the word; a ``policy`` installs the
  mesh-tagged session :class:`~repro_torch.core.program.PipePolicy` around
  it, so kernels inside the stage plan at local shapes with
  topology-keyed caches;
* **release**: push the output one hop down the axis
  (:meth:`StageHandoff.push`, point-to-point on the axis's group).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.runtime.collectives import Hop, _mesh, exchange


@dataclasses.dataclass(frozen=True)
class StageHandoff:
    """The inter-stage pipe across one mesh axis.

    ``push`` is the release step: every stage's fresh word goes to its
    successor (stage s -> s+1; the last stage's word leaves the pipeline
    and is banked by the caller) while stage s receives its
    predecessor's; stage 0 receives zeros, as a ``ppermute`` gives a rank
    no one sends to."""

    axis_name: str
    mesh: Any = None

    @property
    def group(self):
        return _mesh(self.mesh).get_group(self.axis_name)

    def n_stages(self) -> int:
        return dist.get_world_size(self.group)

    def stage(self) -> int:
        return dist.get_rank(self.group)

    def push(self, y: torch.Tensor) -> Hop:
        n, s = self.n_stages(), self.stage()
        return exchange(y, s + 1 if s + 1 < n else None,
                        s - 1 if s > 0 else None, self.group)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   axis_name: str, policy=None, mesh=None) -> torch.Tensor:
    """Run a GPipe pipeline on every rank of ``axis_name``.

    stage_fn(params, x) -> x           one stage's forward
    stage_params                       this rank's stage
    microbatches: [M, mb, ...]         the pipeline's input, the same on
                                       every rank (stage 0 consumes it)
    policy                             optional PipePolicy installed
                                       (mesh-tagged) around the stage body
    Returns [M, mb, ...]: the final stage's outputs on the last stage
    (zeros elsewhere).
    """
    pipe = StageHandoff(axis_name, mesh=mesh)
    n_stage, stage = pipe.n_stages(), pipe.stage()
    m = microbatches.shape[0]

    scope = contextlib.nullcontext
    if policy is not None:
        from repro_torch.core.program import policy as policy_ctx
        from repro_torch.runtime.streams import mesh_policy
        pol = mesh_policy(policy)

        def scope():
            return policy_ctx(pol)

    buf = torch.zeros_like(microbatches[0])     # this stage's handoff slot
    outs = torch.zeros_like(microbatches)
    for t in range(m + n_stage - 1):
        mb_idx = t - stage                      # this stage's word this tick
        # -- acquire: stage 0 pulls from the feed, the others the handoff
        x_in = microbatches[min(t, m - 1)] if stage == 0 else buf
        y = buf
        if 0 <= mb_idx < m:
            # -- consume: the stage's compute
            with scope():
                y = stage_fn(stage_params, x_in)
            if stage == n_stage - 1:
                outs[mb_idx] = y                # the last stage banks it
        # -- release: the word one hop down the axis
        buf = pipe.push(y).wait()
    return outs
