"""Atomic, resumable checkpoints (the port of
``repro/checkpoint/checkpointer.py``, with its layout, so either package
reads the other's files).

Layout:  <dir>/step_<N>/
            manifest.json      step, extra, and per leaf shape, dtype, sha256
            arrays.npz         one entry per flattened leaf
         <dir>/LATEST          text file naming the newest complete step dir

A leaf's key is its path joined by "/" (dict keys in sorted order, list
indices), as the reference flattens a pytree. Leaves are moved to the host
as numpy before they are written (tensors on any device, numpy arrays,
Python scalars).

Sharded state: a DTensor leaf is gathered whole (``full_tensor``, a
collective: every rank of a multi-rank job calls :func:`save`), and rank 0
alone writes; the others wait at a barrier until the step is published. A
checkpoint therefore holds whole host arrays, whatever mesh wrote it, as
the reference's do. :func:`restore` places each leaf back as the mesh it
is restored onto says (``shardings``, or a DTensor leaf of ``tree_like``),
each rank keeping its own shard.

Write protocol: serialize into ``step_N.tmp-<pid>`` -> fsync -> atomic
rename -> update LATEST. A crash mid-write leaves only tmp dirs, which
restore ignores (and the next save removes).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_LATEST = "LATEST"


def _flatten_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten_with_paths(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from repro_torch.runtime.sharding import full_tensor
        return full_tensor(leaf.detach()).cpu().numpy()
    return np.asarray(leaf)


def _multi_rank() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a multi-rank
    job, or a lone process."""
    return not _multi_rank() or torch.distributed.get_rank() == 0


def _host_tree(tree):
    """The tree with every leaf moved to the host as a numpy array."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(x) for x in tree)
    return _to_numpy(tree)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
         keep_last: int = 3) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir``; keep the newest
    ``keep_last`` steps (0 keeps all). Returns the step's directory. In a
    multi-rank job every rank calls it (DTensor leaves are gathered) and
    rank 0 writes; it returns on every rank once the step is published."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    writer = _writer()
    arrays = {}
    for k, v in _flatten_with_paths(tree):
        a = _to_numpy(v)            # a collective for a DTensor leaf
        if writer:
            arrays[k] = a
    if writer:
        _write(ckpt_dir, final, step, arrays, extra, keep_last)
    if _multi_rank():
        torch.distributed.barrier()
    return final


def _write(ckpt_dir, final, step, arrays, extra, keep_last) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {k: {
            "shape": list(a.shape),
            "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
        } for k, a in arrays.items()},
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)                     # atomic publish
    latest_tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, _LATEST))
    _gc(ckpt_dir, keep_last)


def save_async(ckpt_dir: str, step: int, tree: Any, **kw) -> threading.Thread:
    """The device -> host copy here (synchronously), the serialization on
    a worker thread (the slow part). Join the returned thread before
    reading the checkpoint."""
    t = threading.Thread(target=save, args=(ckpt_dir, step, _host_tree(tree)),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and ".tmp-" not in d)
    for d in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):        # crashed partial writes
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, _LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _unflatten_like(tree, arrays, device, shardings, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], arrays, device,
                                   _child(shardings, k), prefix + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(x, arrays, device,
                                          _child(shardings, i),
                                          prefix + (str(i),))
                          for i, x in enumerate(tree))
    key = "/".join(prefix)
    a = arrays[key]
    if tuple(a.shape) != tuple(tree.shape if isinstance(tree, torch.Tensor)
                               else np.shape(tree)):
        raise ValueError(f"checkpoint leaf {key}: shape {a.shape} != "
                         f"{tuple(np.shape(tree))}")
    if not isinstance(tree, torch.Tensor):
        return a
    from repro_torch.runtime.sharding import NamedSharding, is_dtensor
    if shardings is None and is_dtensor(tree):
        shardings = NamedSharding(tree.device_mesh, tuple(tree.placements))
    if device is None:
        device = (shardings.mesh.device_type if shardings is not None
                  else "cpu" if tree.device.type == "meta" else tree.device)
    full = torch.from_numpy(a).to(device)
    return full if shardings is None else shardings.place(full)


def _child(shardings, key):
    if isinstance(shardings, (dict, list, tuple)) and not hasattr(
            shardings, "placements"):
        return shardings[key]
    return shardings


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            device=None, verify: bool = True, shardings=None):
    """Restore into the structure of ``tree_like``: a tensor leaf (``meta``
    ones too) comes back as a tensor on ``device`` (default: the leaf's
    own, the CPU for ``meta``), any other leaf as a numpy array.
    ``shardings`` (a tree of ``runtime.sharding.NamedSharding`` matching
    ``tree_like``, as ``tree_shardings`` builds) places each tensor leaf
    as a DTensor; without it a DTensor leaf of ``tree_like`` comes back
    with its own mesh and placements. Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        keys = [k for k, _ in _flatten_with_paths(tree_like)]
        missing = [k for k in keys if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        arrays = {k: data[k] for k in keys}
    if verify:
        for k, a in arrays.items():
            if hashlib.sha256(a.tobytes()).hexdigest() != \
                    manifest["leaves"][k]["sha256"]:
                raise IOError(f"checksum mismatch for {k} in {d}")
    return (_unflatten_like(tree_like, arrays, device, shardings), step,
            manifest["extra"])
