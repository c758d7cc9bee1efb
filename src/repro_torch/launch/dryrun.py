"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on the
production mesh in one process (the port of ``repro/launch/dryrun.py``).

For each cell this produces (into experiments/dryrun_torch/<cell>.json)
the reference's result dict, so ``launch/roofline.py`` ``analyze_cell``
reads it:

  * proof that the step runs on the production mesh (16 x 16) or the
    2-pod mesh (2 x 16 x 16): a sharding the rules cannot place, or an
    operation DTensor cannot propagate, fails here;
  * ``memory`` of the whole step (bytes per rank);
  * ``cost_scan_program`` (flops and bytes) of the whole step, and of the
    L=1 and L=2 variants (``variants``) with their collectives, from which
    the roofline extrapolates exact per-layer terms.

What stands in for the reference's ``jit(...).lower().compile()``:

  * a "fake" process group of 256 ranks (512 with ``--multi-pod``) in this
    one process (``torch.testing._internal.distributed.fake_pg``): its
    collectives return at once, and the mesh is rank 0's view of it;
  * parameters, optimizer state, batch and cache as ``FakeTensorMode``
    tensors placed as DTensors on ``make_production_mesh``: shapes, types
    and placements, no memory; the step runs on them as it runs on the
    card, on the plain ("xla") attention and scan path (a kernel launch
    has no fake implementation);
  * flops: ``torch.utils.flop_counter.FlopCounterMode``'s formulas applied
    to every operation on rank 0's local shards;
  * bytes: every operation's operands and results on the local shards,
    summed (a view moves none). This is not XLA's count of a fused
    program's memory traffic: every intermediate counts as written and
    read again;
  * memory: ``torch.distributed._tools.mem_tracker.MemTracker``'s peak
    over the step, with the argument bytes reckoned exactly from the
    placements (each leaf's local shard);
  * collectives: :mod:`repro_torch.launch.comm_stats` over the functional
    collectives the step dispatches.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-variants]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.launch import comm_stats
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import LINK_BW
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.runtime import sharding as shlib

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


@dataclasses.dataclass
class Lowered:
    """What tracing one cell's step measured, per rank."""

    flops: float
    bytes: float
    records: List[comm_stats.CollectiveRecord]
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int


class _CostMode(comm_stats.CommCapture):
    """Flops, bytes and collectives of the operations on local shards (an
    operation on DTensors is left to DTensor, which comes back here with
    the local operations it runs)."""

    _METADATA = frozenset(
        f"aten::{n}" for n in (
            "size", "sym_size", "stride", "sym_stride", "numel",
            "sym_numel", "dim", "is_contiguous", "sym_is_contiguous",
            "storage_offset", "sym_storage_offset", "is_strides_like_format",
            "is_non_overlapping_and_dense", "_local_scalar_dense",
            "empty.memory_format", "empty_strided", "empty"))

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_counter = FlopCounterMode(display=False)
        self.bytes = 0.0
        self.paused = 0

    @contextlib.contextmanager
    def skipping_propagation(self):
        """Leave uncounted the operations DTensor runs on global-shape fake
        tensors to learn an operation's output metadata (the first time it
        meets an operation signature; cached after): they are no part of
        the step's local work."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def uncounted(prop, op_schema):
            self.paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self.paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = uncounted
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def observe(self, func, args, kwargs, flat, out) -> None:
        if self.paused:
            return
        rec = comm_stats.record_of(func, args, out)
        if rec is not None:
            self.records.append(rec)
            return
        self.flop_counter._count_flops(func._overloadpacket, out, args,
                                       kwargs)
        name = func.name()
        if not func.is_view and name not in self._METADATA \
                and not name.startswith("_c10d_functional"):
            self.bytes += comm_stats._nbytes(flat) + comm_stats._nbytes(out)

    def flops(self) -> float:
        return float(self.flop_counter.get_total_flops())


@contextlib.contextmanager
def fake_world(world: int):
    """A "fake" default process group of ``world`` ranks in this process
    (this process is rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(tree, axes, ctx, device):
    """Fake tensors of ``tree``'s leaves (meta tensors or CacheSpecs) on
    ``device``, placed as DTensors by the logical ``axes``."""
    if isinstance(tree, dict):
        return {k: _placed(tree[k], axes[k], ctx, device) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed(t, a, ctx, device)
                          for t, a in zip(tree, axes))
    full = torch.zeros(tuple(tree.shape), dtype=tree.dtype, device=device)
    sharding = shlib.sharding_for(axes, ctx)
    return full if sharding is None else sharding.place(full)


def input_like(model, shape):
    """A batch of ``shape`` as shape-and-type stand-ins (the reference's
    ``input_specs``)."""
    cfg, b, s = model.cfg, shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": L.CacheSpec((b,), torch.int64),
                "lengths": L.CacheSpec((b,), torch.int64)}
    out = {"tokens": L.CacheSpec((b, s), torch.int64)}
    if shape.kind == "train":
        out["labels"] = L.CacheSpec((b, s), torch.int64)
    if cfg.family == "vlm":
        out["image_embeds"] = L.CacheSpec((b, cfg.n_patches, cfg.d_model),
                                          cfg.cdtype)
    if cfg.family == "encdec":
        out["frames"] = L.CacheSpec((b, cfg.n_frames, cfg.d_model),
                                    cfg.cdtype)
    return out


def _local_bytes(leaves) -> int:
    return sum(shlib.local_bytes(t) for t in leaves)


def _trace(fn, args) -> Lowered:
    """Run ``fn(*args)`` under the cost, collective and memory modes."""
    from torch.distributed._tools.mem_tracker import MemTracker
    arg_leaves = [t for a in args for _, t in L.tree_leaves(a)]
    argument_bytes = _local_bytes(arg_leaves)
    tracker = MemTracker()
    tracker.track_external(*arg_leaves)
    cost = _CostMode()
    with tracker, cost, cost.skipping_propagation():
        out = fn(*args)
    peak = sum(d.get("Total", 0)
               for d in tracker.get_tracker_snapshot("peak").values())
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    ids = {id(t) for t in arg_leaves}
    alias = _local_bytes([t for t in out_leaves if id(t) in ids])
    return Lowered(flops=cost.flops(), bytes=cost.bytes,
                   records=cost.records, argument_bytes=argument_bytes,
                   output_bytes=_local_bytes(out_leaves),
                   alias_bytes=alias, peak_bytes=int(peak))


def lower_cell(cfg, shape, mesh, overrides, *, device="cuda"):
    """Trace the entry point of one cell on fake tensors; returns
    (Lowered, model)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg.replace(attn_impl="xla", scan_impl="xla")
    with FakeTensorMode(allow_non_fake_inputs=True), \
            shlib.use_sharding(mesh, overrides=overrides) as ctx:
        model = build_model(cfg)
        p_axes = model.param_axes()
        params = _placed(model.abstract_params(), p_axes, ctx, device)
        batch = _placed(input_like(model, shape), model.input_axes(shape),
                        ctx, device)
        if shape.kind == "train":
            opt_init, _ = steps_lib.opt_init_and_update(cfg.optimizer)
            opt = opt_init(params)
            step = steps_lib.make_train_step(model, optimizer=cfg.optimizer,
                                             compiled=False)
            return _trace(step, (params, opt, batch)), model
        if shape.kind == "prefill":
            step = steps_lib.make_prefill_step(model, compiled=False)
            return _trace(step, (params, batch)), model
        cache_like, cache_axes = model.cache_spec(shape)
        cache = _placed(cache_like, cache_axes, ctx, device)
        step = steps_lib.make_decode_step(model, compiled=False)
        return _trace(step, (params, batch, cache)), model


def _reduced_cfg(cfg, n_units: int):
    """Cost-extraction variant: n_units 'layer units'."""
    if cfg.family == "hybrid":
        k = cfg.attn_every_n
        return cfg.replace(n_layers=k * n_units, scan_layers=False)
    if cfg.family == "encdec":
        return cfg.replace(n_layers=n_units, n_enc_layers=n_units,
                           scan_layers=False)
    return cfg.replace(n_layers=n_units, scan_layers=False)


def n_layer_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every_n
    return cfg.n_layers


def _mem_dict(lw: Lowered) -> Dict[str, int]:
    return {
        "argument_bytes": lw.argument_bytes,
        "output_bytes": lw.output_bytes,
        "temp_bytes": lw.peak_bytes - lw.argument_bytes - lw.output_bytes
        + lw.alias_bytes,
        "alias_bytes": lw.alias_bytes,
        "code_bytes": 0,
        "peak_bytes_est": lw.peak_bytes,
    }


def _cost_dict(lw: Lowered) -> Dict[str, float]:
    return {"flops": lw.flops, "bytes": lw.bytes}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             skip_variants: bool = False, out_dir: str = OUT_DIR,
             cfg_patch=None, tag: str = "", mesh_axes=None,
             device: str = "cuda") -> dict:
    """One cell's result dict, also written to ``out_dir``. ``mesh_axes``:
    optional ((name, size), ...) replacing the production mesh (the fake
    group then has as many ranks as it holds); ``device``: the fake
    tensors' device type (nothing runs on it)."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_config(arch_id)
    if cfg_patch:
        cfg = cfg.replace(**cfg_patch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch_id}__{shape_name}__{mesh_name}{tag}"
    result: Dict[str, Any] = {"cell": cell, "arch": arch_id,
                              "shape": shape_name, "mesh": mesh_name,
                              "ok": False, "device": device}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.update(skipped=True, reason=why, ok=True)
        _write(out_dir, cell, result)
        return result

    overrides = {**(cfg.rule_overrides or {}),
                 **(shape.rule_overrides or {})}
    if mesh_axes is None:
        world = 512 if multi_pod else 256
    else:
        world = 1
        for _, size in mesh_axes:
            world *= size
    try:
        with fake_world(world):
            if mesh_axes is not None:
                mesh = init_device_mesh(
                    device, tuple(s for _, s in mesh_axes),
                    mesh_dim_names=tuple(n for n, _ in mesh_axes))
            else:
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type=device)
            t0 = time.time()
            lowered, model = lower_cell(cfg, shape, mesh, overrides,
                                        device=device)
            result["memory"] = _mem_dict(lowered)
            result["cost_scan_program"] = _cost_dict(lowered)
            result["timings"] = {"lower_s": time.time() - t0,
                                 "compile_s": 0.0}
            result["n_params"] = model.param_count()
            result["n_active_params"] = model.active_param_count()
            result["n_layer_units"] = n_layer_units(cfg)
            result["ok"] = True
            del lowered

            if not skip_variants:
                variants = {}
                for nl in (1, 2):
                    lv, _ = lower_cell(_reduced_cfg(cfg, nl), shape, mesh,
                                       overrides, device=device)
                    variants[f"L{nl}"] = {
                        **_cost_dict(lv),
                        "collectives": comm_stats.collective_stats(
                            lv.records, link_bw=LINK_BW),
                    }
                result["variants"] = variants
    except Exception as e:   # noqa: BLE001 — report per-cell failures
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _write(out_dir, cell, result)
    return result


def _write(out_dir, cell, result):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell}.json"), "w") as f:
        json.dump(result, f, indent=1)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-variants", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (default cuda; "
                    "nothing runs on it)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    n_fail = 0
    for a, s in cells:
        r = run_cell(a, s, multi_pod=args.multi_pod,
                     skip_variants=args.skip_variants, out_dir=args.out,
                     device=args.device)
        status = ("SKIP" if r.get("skipped")
                  else "OK" if r["ok"] else "FAIL")
        n_fail += status == "FAIL"
        mem = r.get("memory", {}).get("peak_bytes_est", 0) / 2**30
        print(f"[{status:4s}] {r['cell']:60s} peak={mem:7.2f} GiB "
              f"{r.get('error', '')}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
