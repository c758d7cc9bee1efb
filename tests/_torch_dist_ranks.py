"""Rank bodies of the port's multi-rank CPU tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on gloo processes.

This module imports torch and the port only (each rank imports it afresh:
no JAX in the ranks); the tests compare what the ranks return with the
reference in the parent process. Every body takes (rank, world, ...) and
returns numpy arrays or floats, on rank 0 only where every rank computes
the same thing.
"""

import numpy as np
import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shlib

OPT_CFG = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def train_step(rank, world, cfg, np_params, np_batch, mesh_shape,
               keep=False):
    """One AdamW step of ``cfg``'s model on a ``mesh_shape`` (data, model)
    mesh, params and batch placed by the rules: {"params": {path: numpy},
    "metrics": floats, "param_bytes": by rank} on rank 0 (and, with
    ``keep``, the stepped DTensor params on every rank)."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    mesh = _mesh(mesh_shape, mesh_lib.HOST_AXES)
    with shlib.use_sharding(mesh, overrides=cfg.rule_overrides):
        params = shlib.place_tree(_tensors(np_params), model.param_axes())
        batch = shlib.place_tree(_tensors(np_batch),
                                 {k: ("batch", "seq") for k in np_batch})
        opt = adamw.init(params)
        step = steps_lib.make_train_step(model, opt_cfg=OPT_CFG,
                                         compiled=False)
        params, opt, metrics = step(params, opt, batch)
        full = L.tree_map(shlib.full_tensor, params)
        local = torch.tensor([shlib.local_bytes(params)])
        gathered = [torch.zeros_like(local) for _ in range(world)]
        torch.distributed.all_gather(gathered, local)
    out = {"params": tree_to_numpy(L.tree_map(lambda t: t.detach(), full)),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "param_bytes": [int(g) for g in gathered],
           "norm_sq": _mesh_norm_sq(params, mesh)}
    if keep:
        out["params_dtensor"] = params
        return out
    return None if rank else out


def _mesh_norm_sq(tree, mesh):
    """(the sum of squares of ``tree``'s DTensor leaves as the AdamW
    kernel's wrapper sums it on a mesh: each rank's owned shards, summed
    over the mesh; the same sum of the whole leaves), both in f64."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    owners = adamw_ops.norm_owners(tree, tree, mesh)
    part = torch.zeros(1, dtype=torch.float64)
    for own, (_, t) in zip(owners, L.tree_leaves(tree)):
        if own:
            part += torch.sum(torch.square(t.to_local().double()))
    adamw_ops.mesh_sum(part, mesh)
    whole = sum(float(torch.sum(torch.square(shlib.full_tensor(t).double())))
                for _, t in L.tree_leaves(tree))
    return float(part), whole


def train_step_and_save(rank, world, cfg, np_params, np_batch, mesh_shape,
                        ckpt_dir):
    """:func:`train_step`, then the stepped parameters saved as step 5 of
    ``ckpt_dir`` by the whole mesh (rank 0 writes)."""
    from repro_torch.checkpoint import save
    out = train_step(rank, world, cfg, np_params, np_batch, mesh_shape,
                     keep=True)
    save(ckpt_dir, 5, out.pop("params_dtensor"))
    return None if rank else out


def remesh_and_rings(rank, world, cfg, ckpt_dir, ring_in):
    """On 4 ranks: the checkpoint of ``ckpt_dir`` restored onto the
    survivable (data, model=2) mesh, with a stale plan of the 8-rank
    topology in each cache; then the ring collectives on a 1-D "d" mesh,
    the pipeline on a 1-D "pod" mesh and the compressed all-reduce.
    Returns numpy arrays (rank 0's, and the last stage's pipeline
    outputs as ``pipeline_last``)."""
    from repro_torch.core import autotune, planner
    from repro_torch.core.meshspec import SINGLE_DEVICE, MeshSpec
    from repro_torch.core.pipeline_model import Workload
    from repro_torch.models import build_model
    from repro_torch.optim.compression import compressed_allreduce
    from repro_torch.runtime import elastic
    from repro_torch.runtime.collectives import (allgather_matmul,
                                                 matmul_reducescatter,
                                                 ring_allgather)
    from repro_torch.runtime.pipeline_parallel import pipeline_apply

    out = {}
    # -- elastic remesh: 8 ranks wrote, 4 survive
    stale = MeshSpec(axes=(("data", 4), ("model", 2)))
    w = Workload(n_words=16, word_bytes=1024.0, flops_per_word=8192.0)
    for mesh in (stale, SINGLE_DEVICE):
        planner.planned_pipe("ff_matmul", w, (16, 16, 16), torch.bfloat16,
                             mesh=mesh)
        key = autotune.plan_key("ff_matmul", w, torch.bfloat16,
                                planner.H100_SXM, mesh=mesh)
        autotune._MEM[("cache.json", key)] = {"mesh": mesh.token}
    model = build_model(cfg)
    mesh = elastic.survivable_mesh(range(world), model_axis=2)
    state, step = elastic.remesh_restore(
        ckpt_dir, model.abstract_params(), model.param_axes(), mesh,
        overrides=cfg.rule_overrides)
    rep = elastic.last_remesh()
    out["remesh"] = {"step": step, "mesh": rep.mesh.token,
                     "planner_dropped": rep.planner_dropped,
                     "autotune_dropped": rep.autotune_dropped,
                     "plans_left": planner.plan_cache_info().currsize,
                     "placements": {"/".join(p): str(t.placements)
                                    for p, t in L.tree_leaves(state)},
                     "local_bytes": shlib.local_bytes(state)}
    out["restored"] = tree_to_numpy(L.tree_map(shlib.full_tensor, state))

    # -- the ring collectives over a 4-rank axis "d"
    d_mesh = _mesh((world,), ("d",))
    x, w_, x2, w2 = (torch.from_numpy(ring_in[k])
                     for k in ("x", "w", "x2", "w2"))
    m, k2 = x.shape[0] // world, x2.shape[1] // world
    ag = allgather_matmul(x[rank * m:(rank + 1) * m], w_, "d", mesh=d_mesh)
    rows = x2.shape[0] // world
    rs = matmul_reducescatter(x2[:, rank * k2:(rank + 1) * k2],
                              w2[rank * k2:(rank + 1) * k2], "d",
                              mesh=d_mesh)
    rs_all = [torch.empty(rows, w2.shape[1]) for _ in range(world)]
    torch.distributed.all_gather(rs_all, rs.contiguous(),
                                 group=d_mesh.get_group("d"))
    out["allgather_matmul"] = ag.numpy()
    out["matmul_reducescatter"] = torch.cat(rs_all).numpy()
    out["ring_allgather"] = ring_allgather(
        x[rank * m:(rank + 1) * m], "d", mesh=d_mesh).numpy()

    # -- GPipe over a 4-stage axis "pod"
    p_mesh = _mesh((world,), ("pod",))
    ws, mb = (torch.from_numpy(ring_in[k]) for k in ("ws", "mb"))
    outs = pipeline_apply(lambda wt, h: torch.tanh(h @ wt), ws[rank], mb,
                          "pod", mesh=p_mesh)
    last = [torch.empty_like(outs) for _ in range(world)]
    torch.distributed.all_gather(last, outs, group=p_mesh.get_group("pod"))
    out["pipeline_last"] = last[-1].numpy()

    # -- int8 all-reduce: each rank's slab of ring_in["c"]
    c = torch.from_numpy(ring_in["c"])
    out["compressed"] = compressed_allreduce(c[rank], "d",
                                             mesh=d_mesh).numpy()
    return None if rank else out


def sharded_streams(rank, world, coll_in):
    """On 4 ranks: every registry kernel's sharded smoke over a 4-way
    "data" mesh; ``ops.matmul`` through ``shard_streams`` (its plan's
    workload, mesh and cache counts); the collectives and GPipe with a
    policy. Returns plain values (rank 0's)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import ops
    from repro_torch.core import planner
    from repro_torch.core.program import PipePolicy
    from repro_torch.kernels.ff_matmul.ops import matmul_workload
    from repro_torch.kernels.registry import all_kernels, run_sharded_smoke
    from repro_torch.runtime.collectives import (allgather_matmul,
                                                 matmul_reducescatter)
    from repro_torch.runtime.pipeline_parallel import pipeline_apply
    from repro_torch.runtime.streams import shard_streams

    out = {"smoke": {}}
    mesh = _mesh((world,), ("data",))
    with shlib.use_sharding(mesh):
        for spec in all_kernels():
            if spec.shard_dims is None:
                continue
            sh, un, _, err_un, err_ref = run_sharded_smoke(spec, mesh)
            out["smoke"][spec.name] = (err_un, err_ref, spec.tol,
                                       bool(torch.equal(sh, un)))

        # a kernel under shard_streams plans at the local shapes
        m_global, n, k = world * 192, 160, 136
        g = torch.Generator().manual_seed(0)
        a = torch.randn(m_global, k, generator=g)
        b = torch.randn(k, n, generator=g)
        planner.plan_cache_clear()
        f = shard_streams(ops.matmul, in_specs=((Shard(0),), (Replicate(),)),
                          out_specs=(Shard(0),))
        c = f(a, b).full_tensor()
        plan = planner.last_plan("ff_matmul")
        misses = planner.plan_cache_info().misses
        f(a, b)
        info = planner.plan_cache_info()
        out["plan"] = {
            "err": float((c - a @ b).abs().max()),
            "local": plan.workload == matmul_workload(
                m_global // world, n, k, dtype=torch.float32)[0],
            "global_words": matmul_workload(
                m_global, n, k, dtype=torch.float32)[0].n_words,
            "words": plan.workload.n_words, "mesh": plan.mesh.token,
            "devices": plan.mesh.device_count,
            "new_misses": info.misses - misses, "hits": info.hits}

    d_mesh = _mesh((world,), ("d",))
    pol = PipePolicy()
    x, w_, x2, w2 = (torch.from_numpy(coll_in[k])
                     for k in ("x", "w", "x2", "w2"))
    m, k2 = x.shape[0] // world, x2.shape[1] // world
    with shlib.use_sharding(d_mesh):
        planner.plan_cache_clear()
        ag = allgather_matmul(x[rank * m:(rank + 1) * m], w_, "d",
                              policy=pol)
        ag_plan = planner.last_plan("ff_matmul")
        planner.plan_cache_clear()
        rs = matmul_reducescatter(x2[:, rank * k2:(rank + 1) * k2],
                                  w2[rank * k2:(rank + 1) * k2], "d",
                                  policy=pol)
        rs_plan = planner.last_plan("ff_matmul")
        rows = x2.shape[0] // world
        rs_all = [torch.empty(rows, w2.shape[1]) for _ in range(world)]
        torch.distributed.all_gather(rs_all, rs.contiguous(),
                                     group=d_mesh.get_group("d"))
    out["collectives"] = {
        "allgather_matmul": ag.numpy(),
        "matmul_reducescatter": torch.cat(rs_all).numpy(),
        "plans": [(p.mesh.token, p.workload == matmul_workload(
            *shape, dtype=torch.float32)[0]) for p, shape in (
                (ag_plan, (m, w_.shape[1], x.shape[1])),
                (rs_plan, (rows, w2.shape[1], k2)))]}

    p_mesh = _mesh((world,), ("pod",))
    ws, mb = (torch.from_numpy(coll_in[k]) for k in ("ws", "mb"))
    with shlib.use_sharding(p_mesh):
        planner.plan_cache_clear()
        outs = pipeline_apply(lambda wt, h: torch.tanh(ops.matmul(h, wt)),
                              ws[rank], mb,
                              "pod", policy=pol)
        stage_plan = planner.last_plan("ff_matmul")
    last = [torch.empty_like(outs) for _ in range(world)]
    torch.distributed.all_gather(last, outs, group=p_mesh.get_group("pod"))
    out["pipeline"] = {"last": last[-1].numpy(),
                       "mesh": stage_plan.mesh.token}
    return None if rank else out


def _serve_steps(model, params, tokens, n_steps, s_max, place):
    """Prefill ``tokens`` [B, S], then ``n_steps`` greedy decode steps from
    its last logits, each step's batch passed through ``place`` (the
    mesh's placement, or nothing): the logits of every step and the greedy
    tokens, as numpy."""
    from repro_torch.launch import serve as serve_lib
    b, s = tokens.shape
    prefill = steps_lib.make_prefill_step(model, compiled=False)
    decode = steps_lib.make_decode_step(model, compiled=False)
    logits, cache = prefill(params, place({"tokens": tokens},
                                          ("batch", "seq")))
    cache = serve_lib.pad_cache_to(cache, s, s_max, 2)
    cur = shlib.full_tensor(torch.argmax(logits, dim=-1).to(torch.int32))
    out = {"logits": [shlib.full_tensor(logits).numpy()], "tokens": []}
    lengths = torch.full((b,), s, dtype=torch.int32)
    for _ in range(n_steps):
        step_in = place({"token": cur, "lengths": lengths}, ("batch",))
        cur, logits, cache = decode(params, step_in, cache)
        cur = shlib.full_tensor(cur)
        out["logits"].append(shlib.full_tensor(logits).numpy())
        out["tokens"].append(cur.numpy())
        lengths = lengths + 1
    return out


def _recurrent_steps(model, params, tokens, n_steps, place):
    """A recurrent model's prefill of ``tokens`` [B, S], then ``n_steps``
    greedy decode steps on its carried state (no cache to pad): every
    step's logits as numpy."""
    b, s = tokens.shape
    prefill = steps_lib.make_prefill_step(model, compiled=False)
    decode = steps_lib.make_decode_step(model, compiled=False)
    logits, cache = prefill(params, place({"tokens": tokens},
                                          ("batch", "seq")))
    out = [shlib.full_tensor(logits).numpy()]
    cur = shlib.full_tensor(torch.argmax(logits, dim=-1).to(torch.int32))
    lengths = torch.full((b,), s, dtype=torch.int32)
    for _ in range(n_steps):
        cur, logits, cache = decode(
            params, place({"token": cur, "lengths": lengths}, ("batch",)),
            cache)
        cur = shlib.full_tensor(cur)
        out.append(shlib.full_tensor(logits).numpy())
        lengths = lengths + 1
    return out


def _adafactor_steps(model, params, batch, n_steps, opt_cfg):
    """``n_steps`` Adafactor steps: the loss of each, the final params as
    numpy."""
    from repro_torch.optim import adafactor
    opt = adafactor.init(params)
    step = steps_lib.make_train_step(model, optimizer="adafactor",
                                     opt_cfg=opt_cfg, compiled=False)
    losses = []
    for _ in range(n_steps):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    full = L.tree_map(shlib.full_tensor, params)
    return losses, tree_to_numpy(L.tree_map(lambda t: t.detach(), full))


def mesh_serve_and_adafactor(rank, world, serve_in, train_in, recur_in,
                             mesh_shape):
    """On a ``mesh_shape`` (data, model) mesh: the uncompiled prefill and
    decode steps of ``serve_in`` = (cfg, numpy params, tokens, n_steps,
    s_max) with params, batches and caches placed by the rules, the
    Adafactor steps of ``train_in`` = (cfg, numpy params, numpy batch,
    n_steps, AdafactorConfig), and a recurrent model's steps of
    ``recur_in`` = (cfg, numpy params, tokens, n_steps). Returns {"serve":
    ..., "train": (losses, params), "recurrent": logits} on rank 0."""
    from repro_torch.models import build_model
    mesh = _mesh(mesh_shape, mesh_lib.HOST_AXES)
    out = {}
    for key, fn, (cfg, np_params, *rest) in (
            ("serve", _serve_steps, serve_in),
            ("train", _adafactor_steps, train_in),
            ("recurrent", _recurrent_steps, recur_in)):
        model = build_model(cfg)
        with shlib.use_sharding(mesh, overrides=cfg.rule_overrides):
            params = shlib.place_tree(_tensors(np_params),
                                      model.param_axes())

            def place(tree, axes):
                return shlib.place_tree(tree, {k: axes for k in tree})
            if key == "serve":
                tokens, n_steps, s_max = rest
                out[key] = fn(model, params, torch.from_numpy(tokens),
                              n_steps, s_max, place)
            elif key == "recurrent":
                tokens, n_steps = rest
                out[key] = fn(model, params, torch.from_numpy(tokens),
                              n_steps, place)
            else:
                np_batch, n_steps, opt_cfg = rest
                batch = place(_tensors(np_batch), ("batch", "seq"))
                out[key] = fn(model, params, batch, n_steps, opt_cfg)
    return None if rank else out


def serve_mesh_cases(rank, world, cases, skewed):
    """``launch/serve.py``'s ``serve_bench`` on the host mesh of the spawn
    (the process group is already joined), once per ``(name, argv)`` of
    ``cases``. In the cases named in ``skewed`` this rank's
    ``time.perf_counter`` runs at ``1 + rank`` times real speed. Returns
    {name: result} from every rank."""
    import argparse
    import time

    from repro_torch.launch import serve
    out = {}
    real = time.perf_counter
    for name, argv in cases:
        ap = argparse.ArgumentParser()
        serve.add_serve_args(ap)
        if name in skewed:
            serve.time.perf_counter = lambda: real() * (1 + rank)
        try:
            out[name] = serve.serve_bench(ap.parse_args(argv))
        finally:
            serve.time.perf_counter = real
    return out
