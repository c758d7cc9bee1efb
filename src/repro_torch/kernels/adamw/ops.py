"""AdamW's update of a whole parameter tree: wrapper, plain version, launch
count.

Replaces no Pallas kernel: the reference leaves its update
(``repro/optim/adamw.py`` ``update``) to XLA, which fuses it into the
jitted train step. The CUDA kernel ``csrc/adamw.cu`` is that fusion written
by hand: launch 1 sums the gradients' squares (the global norm) in a fixed
order, launch 2 reads p, g, m and v once and writes p, m and v once, with
the clip scale, the learning rate and both bias corrections computed on
the device from ``state["step"]``. Its note says what bounds it.

The leaves ride in the launches' parameters (a table of at most
``MAX_LEAVES`` leaves; a larger tree takes a pair of launches per group
of them), so a compiled (CUDA-graph) train step captures both launches as
they are: nothing is copied from the host, and the only buffers are the
partial sums and the two metrics, made by the caching allocator.

``adamw_update`` makes the one choice between kernel and plain version:
the plain version (:func:`adamw_ref`, the port's loop over the leaves)
for CPU tensors, fake ones (the dry run traces) and under a policy of
mode "ref"; for CUDA tensors it launches the kernel or raises. DTensor
operands (a mesh) launch it on each rank's shards: launch 1's partial
sums are all-reduced over the mesh before launch 2, each element of the
tree counted on one rank (:func:`norm_owners`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.program import current_policy
from repro_torch.kernels import _build
from repro_torch.models import layers as L

_TILE = 4096                  # elements a tile (csrc/adamw.cu kTile)
MAX_LEAVES = 64               # leaves a pair of launches takes (a larger
                              # tree takes a pair a group; csrc/adamw.cu
                              # kMaxLeaves)
_NORM_BLOCKS_PER_SM = 4       # launch 1's grid: partial sums to read back
_APPLY_BLOCKS_PER_SM = 8      # launch 2's grid: 2,048 threads an SM
_P_BF16, _G_BF16, _VEC, _NO_NORM = 1, 2, 4, 8
_TYPES = (torch.float32, torch.bfloat16)


class _Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("tile0", ctypes.c_int),
                ("flags", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("n_leaves", ctypes.c_int), ("tiles", ctypes.c_int),
                ("leaf", _Leaf * MAX_LEAVES)]


class _Hyper(ctypes.Structure):
    _fields_ = [("lr_peak", ctypes.c_float), ("b1", ctypes.c_float),
                ("b2", ctypes.c_float), ("eps", ctypes.c_float),
                ("weight_decay", ctypes.c_float),
                ("clip_norm", ctypes.c_float),
                ("one_minus_b1", ctypes.c_float),
                ("one_minus_b2", ctypes.c_float),
                ("warmup", ctypes.c_int), ("warm_div", ctypes.c_int),
                ("decay_div", ctypes.c_int)]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


@torch.no_grad()
def adamw_ref(cfg, grads, state, params
              ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step of ``optim.adamw.update`` as plain PyTorch: the
    gradients read in f32 and clipped to ``cfg.clip_norm``, then a loop
    over the leaves. Writes ``params`` and ``state`` in place; returns
    (params, state, {"grad_norm", "lr"}). Every scalar is made on the
    device (no copy from the host), so a CUDA graph can capture it. Each
    gradient is scaled in its leaf's turn, as ``clip_by_global_norm``
    scales it (the same operations): a clipped copy of the whole tree
    would add a gradient's worth to the peak (the CPU's mesh ranks run
    this version on DTensors)."""
    from repro_torch.optim.adamw import global_norm, schedule
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    state["step"].add_(1)
    step = state["step"].float()
    lr = schedule(cfg, state["step"])
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    g_leaves = dict(L.tree_leaves(grads))
    m_leaves = dict(L.tree_leaves(state["m"]))
    v_leaves = dict(L.tree_leaves(state["v"]))
    for path, p in L.tree_leaves(params):
        g = g_leaves[path].float() * scale
        m, v = m_leaves[path], v_leaves[path]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p32 = p.float()
        p32 = p32 - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(p32)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entries():
    p, i = ctypes.c_void_p, ctypes.c_int
    norm = _build.bind("adamw", "adamw_sumsq", [p, p, i, p, p])
    apply = _build.bind("adamw", "adamw_apply", [p, p, i, p, p, p, p, i, p])
    return norm, apply


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _leaf_flags(p, g, m, v) -> int:
    flags = (_P_BF16 if p.dtype == torch.bfloat16 else 0) \
        | (_G_BF16 if g.dtype == torch.bfloat16 else 0)
    # four elements a load: 16 bytes of f32, 8 of bf16
    if all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (p, g, m, v)):
        flags |= _VEC
    return flags


def _tables(quads: List[Tuple[torch.Tensor, ...]],
            owners: Optional[List[bool]] = None) -> List[_Table]:
    """The leaves (p, g, m, v) in groups of ``MAX_LEAVES``, each group's
    tiles numbered from 0; a leaf whose ``owners`` entry is False is left
    out of the norm's sum."""
    tables = []
    for start in range(0, len(quads), MAX_LEAVES):
        group = quads[start:start + MAX_LEAVES]
        t = _Table(n_leaves=len(group))
        tiles = 0
        for j, (p, g, m, v) in enumerate(group):
            n = p.numel()
            flags = _leaf_flags(p, g, m, v)
            if owners is not None and not owners[start + j]:
                flags |= _NO_NORM
            t.leaf[j] = _Leaf(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                              v.data_ptr(), n, tiles, flags)
            tiles += -(-n // _TILE)
        t.tiles = tiles
        tables.append(t)
    return tables


def _hyper(cfg) -> _Hyper:
    return _Hyper(lr_peak=cfg.lr_peak, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                  weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
                  one_minus_b1=1 - cfg.b1, one_minus_b2=1 - cfg.b2,
                  warmup=cfg.warmup_steps, warm_div=max(cfg.warmup_steps, 1),
                  decay_div=max(cfg.total_steps - cfg.warmup_steps, 1))


def check_adamw_inputs(grads, state, params) -> List[Tuple[torch.Tensor,
                                                           ...]]:
    """The (p, g, m, v) of every leaf in the params' order, checked: one
    CUDA device, p and g float32 or bfloat16 of one size, m and v float32
    and contiguous, p contiguous, a 0-d int32 step. A gradient that is not
    contiguous is copied (autograd may return a transposed one). A leaf
    without elements stays (it takes no tile): every rank of a mesh then
    has the same leaves, in groups of the same sizes."""
    g_leaves = dict(L.tree_leaves(grads))
    m_leaves = dict(L.tree_leaves(state["m"]))
    v_leaves = dict(L.tree_leaves(state["v"]))
    step = state["step"]
    device = step.device
    if step.shape != () or step.dtype != torch.int32:
        raise TypeError(f"adamw: the step is a 0-d int32 tensor, not "
                        f"{tuple(step.shape)} {step.dtype}")
    quads = []
    for path, p in L.tree_leaves(params):
        g, m, v = g_leaves[path], m_leaves[path], v_leaves[path]
        name = ".".join(map(str, path))
        if p.dtype not in _TYPES or g.dtype not in _TYPES:
            raise TypeError(f"adamw: {name} takes float32 or bfloat16 "
                            f"parameters and gradients, not {p.dtype}, "
                            f"{g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError(f"adamw: {name}'s moments are float32, not "
                            f"{m.dtype}, {v.dtype}")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw: {name}: parameter {tuple(p.shape)}, "
                             f"gradient {tuple(g.shape)}, moments "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
        if any(t.device != device for t in (p, g, m, v)):
            raise ValueError(f"adamw: {name} is not on the step's device "
                             f"{device}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"adamw: {name}'s parameter and moments are "
                             f"updated in place and must be contiguous")
        quads.append((p, g.contiguous(), m, v))
    return quads


def mesh_of(params):
    """The DeviceMesh of ``params``' DTensor leaves; None when no leaf is
    a DTensor. Every DTensor leaf must be on that one mesh."""
    from repro_torch.runtime.sharding import is_dtensor
    meshes = {id(p.device_mesh): p.device_mesh
              for _, p in L.tree_leaves(params) if is_dtensor(p)}
    if len(meshes) > 1:
        raise ValueError(f"adamw: the parameters lie on {len(meshes)} "
                         f"meshes, not one")
    return next(iter(meshes.values()), None)


def norm_owners(grads, params, mesh) -> List[bool]:
    """Whether this rank adds each leaf's shard (in the params' order) to
    the global norm's sum: where a leaf is sharded over a mesh axis every
    rank adds its own part; where it is replicated over one (or is a
    plain tensor, which every rank holds whole) only the rank at
    coordinate 0 of that axis adds it. Summed over the mesh, every element
    of the tree is counted once. Each DTensor gradient must be placed as
    its parameter (``launch.steps.reduce_grads``)."""
    from repro_torch.runtime.sharding import is_dtensor
    coord = mesh.get_coordinate()
    g_leaves = dict(L.tree_leaves(grads))
    owners = []
    for path, p in L.tree_leaves(params):
        g = g_leaves[path]
        placements = p.placements if is_dtensor(p) else ()
        g_placements = g.placements if is_dtensor(g) else ()
        if tuple(g_placements) != tuple(placements):
            raise ValueError(
                f"adamw: {'.'.join(map(str, path))}'s gradient is placed "
                f"{tuple(g_placements)}, its parameter {tuple(placements)}")
        if any(pl.is_partial() for pl in placements):
            raise ValueError(f"adamw: {'.'.join(map(str, path))} is a "
                             f"partial sum; its placements are Shard or "
                             f"Replicate")
        owners.append(all(
            c == 0 for d, c in enumerate(coord)
            if not (d < len(placements) and placements[d].is_shard())))
    return owners


def mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed in place over every rank of ``mesh``: an all-reduce
    over each of its axes in turn (the same result on every rank)."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.all_reduce(t, group=mesh.get_group(d))
    return t


def _local(tree):
    """``tree`` with each DTensor leaf replaced by this rank's shard (the
    same storage: writes into it are the DTensor's)."""
    from repro_torch.runtime.sharding import is_dtensor
    return L.tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)


def _plain(state, params) -> bool:
    """Whether this update takes the plain version: CPU tensors, fake
    ones, or a session policy of mode "ref"."""
    from torch._subclasses.fake_tensor import is_fake
    return (state["step"].device.type == "cpu"
            or current_policy().mode == "ref"
            or any(is_fake(p) for _, p in L.tree_leaves(params)))


@torch.no_grad()
def adamw_update(cfg, grads, state, params
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written in place into ``params`` and ``state``:
    (params, state, {"grad_norm", "lr"}), as :func:`adamw_ref`. CPU
    tensors, fake tensors and a session policy of mode "ref" run
    :func:`adamw_ref`; CUDA tensors launch ``csrc/adamw.cu`` (two launches
    for up to ``MAX_LEAVES`` leaves), counted in ``adamw_update.launches``.
    DTensor operands launch it on this rank's shards, the partial sums
    of squares all-reduced over their mesh between the launches; the
    metrics are then plain tensors, the same on every rank."""
    if _plain(state, params):
        return adamw_ref(cfg, grads, state, params)
    device = state["step"].device
    if device.type != "cuda":
        raise ValueError(f"adamw runs on cpu or cuda, not {device}")
    mesh = mesh_of(params)
    owners = None if mesh is None else norm_owners(grads, params, mesh)
    local = _local(state)
    quads = check_adamw_inputs(_local(grads), local, _local(params))
    if not quads:
        raise ValueError("adamw: no parameter to update")
    step = local["step"]
    gnorm = torch.empty((), dtype=torch.float32, device=device)
    lr = torch.empty((), dtype=torch.float32, device=device)
    sms = _sms(device.index if device.index is not None
               else torch.cuda.current_device())
    tables = _tables(quads, owners)
    stride = _NORM_BLOCKS_PER_SM * sms
    norm_grids = [max(1, min(t.tiles, stride)) for t in tables]
    if mesh is None:
        offsets = [sum(norm_grids[:k]) for k in range(len(tables))]
        partials = torch.empty(sum(norm_grids), dtype=torch.float64,
                               device=device)
    else:
        # one length on every rank (their grids follow their shards'
        # sizes): each group's partials at a fixed stride, zeros between
        offsets = [k * stride for k in range(len(tables))]
        partials = torch.zeros(len(tables) * stride, dtype=torch.float64,
                               device=device)
    norm, apply = _entries()
    stream = _build.stream_ptr(device)
    hyper = _hyper(cfg)
    for k, (table, grid) in enumerate(zip(tables, norm_grids)):
        rc = norm(ctypes.byref(table), partials.data_ptr() + 8 * offsets[k],
                  grid, step.data_ptr() if k == 0 else None, stream)
        _build.check("adamw", "adamw_sumsq", rc)
    if mesh is not None:
        mesh_sum(partials, mesh)
    for k, table in enumerate(tables):
        rc = apply(ctypes.byref(table), partials.data_ptr(),
                   partials.numel(), step.data_ptr(), ctypes.byref(hyper),
                   gnorm.data_ptr() if k == 0 else None,
                   lr.data_ptr() if k == 0 else None,
                   max(1, min(table.tiles, _APPLY_BLOCKS_PER_SM * sms)),
                   stream)
        _build.check("adamw", "adamw_apply", rc)
    adamw_update.launches += 2 * len(tables)
    return params, state, {"grad_norm": gnorm, "lr": lr}


adamw_update.launches = 0
adamw_update.op_name = "adamw"
