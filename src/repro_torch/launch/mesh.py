"""Meshes and process groups (the port of ``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks (data x model).
Multi-pod:  2 x 16 x 16 = 512 ranks (pod x data x model): the "pod" axis
is data-parallel across pods; the sharding rules map logical "batch" to
("pod", "data") so the same model code serves both meshes.

A mesh is a named ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group, one process per rank. :func:`init_distributed`
joins that group from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or alone as rank 0 of 1
without it. The backend is the caller's choice: NCCL refuses two ranks on
one card, so several ranks sharing one card run ``gloo`` (compute stays on
the card, the collectives go through the host).

:func:`spawn_ranks` runs a function on ``world`` fresh processes joined
through a rendezvous file, each joined with a timeout: the tests and
``chip_smoke.py`` use it. Gloo's point-to-point calls cannot take CUDA
tensors; ``gloo_staged`` (:mod:`repro_torch.runtime.gloo_staged`) is gloo
with those staged through pinned host memory.
"""

from __future__ import annotations

import os
import queue as queue_lib
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HOST_AXES = ("data", "model")


def host_mesh_shape(world: int, model_axis: int = 2
                    ) -> Tuple[Tuple[int, int], Tuple[str, str]]:
    """``((world // m, m), ("data", "model"))`` with ``m = min(model_axis,
    world)``, the reference's host mesh over ``world`` devices."""
    m = min(model_axis, world)
    if world % m:
        raise ValueError(f"{world} ranks do not divide into model_axis={m}")
    return (world // m, m), HOST_AXES


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    return dist.get_world_size()


def make_host_mesh(model_axis: int = 2, *, device_type: str = "cpu"):
    """``(data, model)`` mesh over the process group's whole world; (1, 1)
    at world size 1."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = host_mesh_shape(_world(), model_axis)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 256-rank (or 512-rank, ``multi_pod``) production mesh; raises
    ``ValueError`` unless the world has exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    check_production_world(_world(), multi_pod)
    shape, names = production_mesh_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def check_production_world(world: int, multi_pod: bool = False) -> None:
    """Raise ``ValueError`` saying why unless ``world`` ranks make the
    production mesh (256, or 512 with ``multi_pod``)."""
    shape, names = production_mesh_shape(multi_pod)
    need = 1
    for s in shape:
        need *= s
    if world != need:
        raise ValueError(
            f"--mesh {'pod2' if multi_pod else 'pod'} is the "
            f"{'x'.join(map(str, shape))} mesh {names}: it needs {need} "
            f"ranks and the process group has {world} (launch with "
            f"torchrun making {need} ranks, or use --mesh host)")


BACKENDS = ("nccl", "gloo", "gloo_staged")


def default_backend(device: torch.device, world: int = 1) -> str:
    """``nccl`` where each of ``world`` ranks has a card of its own,
    ``gloo_staged`` where ranks share a card (NCCL refuses two ranks on
    one card), ``gloo`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo_staged"


def _register(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "gloo_staged":
        from repro_torch.runtime import gloo_staged
        gloo_staged.register()


def init_distributed(device, backend: Optional[str] = None
                     ) -> Tuple[int, int, torch.device]:
    """Join the default process group as torchrun's environment says
    (``RANK``/``WORLD_SIZE``), else alone as rank 0 of 1. Returns (rank,
    world, this rank's device): on CUDA, card ``LOCAL_RANK`` modulo the
    cards present. ``backend`` defaults to :func:`default_backend` for
    torchrun's world. A group already joined is kept as it is."""
    device = torch.device(device)
    backend = backend or default_backend(
        device, int(os.environ.get("WORLD_SIZE", "1")))
    _register(backend)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size(), device


# ---------------------------------------------------------------------------
# Spawning ranks (tests, chip_smoke.py)
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, init_file, backend, threads, args, q):
    try:
        if threads:
            torch.set_num_threads(threads)
        _register(backend)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            q.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:        # noqa: BLE001 — reported to the parent
        q.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable[..., Any], world: int, args: Sequence = (), *,
                init_file: str, backend: str = "gloo",
                timeout: float = 120.0, threads: Optional[int] = None
                ) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes (spawn)
    joined in one ``backend`` process group through the rendezvous file
    ``init_file`` (which must not exist yet). Returns the ranks' return
    values in rank order; raises ``RuntimeError`` with the ranks'
    tracebacks if one raised, died or outlived ``timeout`` seconds (every
    process is gone when it returns). ``fn`` and ``args`` must pickle;
    ``threads`` sets each rank's intra-op threads (default: the cores
    shared out)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_file, backend, threads,
                               tuple(args), q))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = q.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                if errors or any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died without a word: the others would wait on
                    # it until the timeout; give them a moment to report
                    deadline = min(deadline, time.monotonic() + 5.0)
                continue
            (results if ok else errors)[rank] = value
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if errors or len(results) < world:
        missing = [r for r in range(world)
                   if r not in results and r not in errors]
        msg = "".join(f"\n--- rank {r} ---\n{tb}"
                      for r, tb in sorted(errors.items()))
        raise RuntimeError(
            f"spawn_ranks({getattr(fn, '__name__', fn)}, world={world}): "
            f"{len(errors)} rank(s) raised, ranks {missing} gave no result "
            f"within {timeout:.0f} s (exit codes "
            f"{[p.exitcode for p in procs]}){msg}")
    return [results[r] for r in range(world)]
