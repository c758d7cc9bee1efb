"""Serving driver: paged-KV continuous batching vs. padded lockstep (the
port of ``repro/launch/serve.py``).

Two schedulers over the same Poisson request trace:

  * **lockstep** — FIFO static batches: wait until ``n_slots`` requests
    have arrived, right-pad prompts into one prefill, then decode the
    whole batch in lockstep over a dense right-padded KV cache
    ``[L, B, S_max, KVH, hd]`` until its slowest row finishes.
  * **paged** (continuous batching) — requests are admitted the moment a
    decode slot and enough KV blocks are free, prefill is per request
    (bucketed to power-of-2 prompt lengths), and every step retires
    finished slots and recycles their blocks
    (:class:`~repro_torch.runtime.paged_kv.PagedKVCache`). Decode attention
    reads KV through the block table in the paged CUDA kernel.

Both replay the trace on a virtual clock advanced by measured step times
(no sleeping, real compute costs; on the card each clock reading follows a
``torch.cuda.synchronize``), and both decode greedily with identical math:
under ``--impl ff`` the dense path's KV tile is pinned to the page size
(``cfg.decode_block_kv``), under ``--impl xla`` both read the same rows
densely, so paged decode is bitwise-identical to the contiguous path and
the two schedulers emit token-for-token equal sequences.
:func:`decode_parity_probe` checks the bitwise claim.

The decoder-only K/V families are served: dense (qwen1.5, llama3.2,
starcoder2, qwen2), MoE with attention (grok-1) and the VLM (internvl2,
on text prompts, as the reference's ``serve_bench`` sends them: its
prefill without ``image_embeds`` is the dense LM's). The others are
refused (``SystemExit``): encdec (whisper) as the reference refuses it,
and the recurrent families and MLA, whose caches are no K/V cache.

On the card every step is compiled (``launch/steps.py``): prefill is
captured as a CUDA graph once per (batch, bucket) and decode once per
cache signature, then replayed, as the reference jits both; weights are
cast to the compute type once, as they are drawn (``model.init_cast``,
the bits of ``model.cast_params(model.init(...))``).

With ``--layer-graph`` the lockstep scheduler's decode steps go through
the whole-layer ``decode_layer`` kernels instead; their rounding points
differ from the per-op layer's in bf16, so the probe then reports a small
non-zero difference (the reference's does too).

The plan stack, as the reference's flags drive it:

  * ``--policy-mode ff|baseline|autotune`` — the
    :class:`~repro_torch.core.program.PipePolicy` mode of every step:
    pipes planned per call site, the synchronous depth-1 strawman, or
    measured plans (a compiled step never measures: it serves the plan
    cache or the PlanDB, else the analytic plan). Without it the session
    policy sizes the steps (``with repro_torch.policy(...)`` around
    ``serve_bench``; ``ff`` by default);
  * ``--plan-db PATH`` — the release PlanDB the measured lookup chain
    consults (pre-warmed at start-up);
  * ``--record-profile PATH`` — every plan resolution of the run into a
    TrafficProfile (``python -m repro_torch.plans sweep`` tunes from it);
  * ``--metrics-json PATH`` — live telemetry (per-token latency
    histograms, the KV gauge, spans, plan-source counters), written as
    ``obs.metrics_snapshot()`` at exit.

Under ``torchrun`` (``WORLD_SIZE`` > 1, or inside a process group of more
than one rank) it serves on the host mesh, as the reference's
``serve_bench`` does: ``launch/mesh.py``'s ``(N // m, m)`` over ``("data",
"model")``, ``m = min(2, N)``, the parameters drawn from seed 0 on every
rank and placed by the rules, the steps uncompiled (a CUDA-graph capture
cannot hold the collectives), the paged pool's KV heads over "model". The
schedulers' clock is one clock: every timed step is the most any rank
took (one scalar all-reduce), so every rank admits the same requests and
issues the same collectives. Rank 0 alone prints and writes ``--json``,
``--metrics-json`` and ``--record-profile``; the result ends with
``ranks_agree`` (every rank emitted the same tokens). At world 1 no
process group is started and no DTensor made.

Runs on the card unless asked for the CPU (the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve
  PYTHONPATH=src python -m repro_torch.launch.serve --policy-mode baseline \
      --record-profile traffic.json --metrics-json metrics.json
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --layer-graph
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --arch grok1_314b --impl xla
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --dist-backend gloo_staged --json out.json
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --smoke --device cpu --dist-backend gloo
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.kernels import launch_counters
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.paged_kv import PagedKVCache, to_device
from repro_torch.runtime.sharding import is_dtensor, kept


def resolve_device(name: str) -> torch.device:
    """The device to serve on; raises when a GPU is asked for and none is
    found (no silent fall back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "the kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ints(x, device) -> torch.Tensor:
    """Host ints on ``device`` as int32, copied without a host sync."""
    return to_device(np.asarray(x, np.int32), device)


def _coll_device(device: torch.device) -> torch.device:
    """Where a collective of the default group takes its tensors: the
    card under NCCL, else the host."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def _make_steps(model, params, policy):
    """(prefill, decode) under ``policy``; uncompiled when ``params`` are
    DTensors (a CUDA-graph capture cannot hold the collectives)."""
    compiled = not is_dtensor(params["embed"])
    return (steps_lib.make_prefill_step(model, compiled=compiled,
                                        policy=policy),
            steps_lib.make_decode_step(model, compiled=compiled,
                                       policy=policy))


def _elapsed(t0: float, params) -> float:
    """Seconds since ``t0`` on the trace clock. On a mesh (DTensor
    ``params``) it is the most any rank of the default group took (one
    scalar all-reduce): the mesh's step ends when its slowest rank does,
    and every rank's clock, so every rank's admissions, stay the same."""
    dt = time.perf_counter() - t0
    if not is_dtensor(params["embed"]):
        return dt
    t = torch.tensor([dt], dtype=torch.float64,
                     device=_coll_device(params["embed"].device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _host_tokens(nxt) -> np.ndarray:
    """The greedy tokens [B] on the host (a DTensor's batch shards
    gathered first)."""
    return shlib.full_tensor(nxt).cpu().numpy()


def pad_cache_to(cache, s_from: int, s_max: int, seq_dims):
    """Right-pad the declared sequence axes of a cache pytree (nested dicts
    and lists of tensors).

    ``seq_dims`` names the sequence axis: an int applied to every leaf, or
    a pytree matching ``cache`` whose values are an axis index or None (None
    = no sequence axis, left untouched); an int or None given for a
    subtree applies to each of its leaves. The hybrid family pads its
    ``attn[i]`` leaves and leaves its Mamba2 states alone:
    ``{"mamba": None, "attn": 1}``. A DTensor leaf is padded in a local
    body with its sequence gathered (its other shards kept), then placed
    back as it was."""
    if seq_dims is None:
        raise TypeError("pad_cache_to requires seq_dims (an int axis or a "
                        "per-leaf dict of axes); padding by shape match "
                        "corrupts non-sequence dims that equal s_from")
    if s_from == s_max:
        return cache

    def pad(x, axis):
        if axis is None:
            return x
        if x.shape[axis] != s_from:
            raise ValueError(
                f"cache leaf {tuple(x.shape)} has {x.shape[axis]} at "
                f"declared seq axis {axis}, expected {s_from}")
        pads = [0, 0] * (x.dim() - 1 - axis) + [0, s_max - s_from]
        if not is_dtensor(x):
            return F.pad(x, pads)
        from torch.distributed.tensor.experimental import local_map
        pl = kept(x.placements, set(range(x.dim())) - {axis})
        body = local_map(lambda t: F.pad(t, pads), out_placements=pl,
                         in_placements=(pl,), device_mesh=x.device_mesh,
                         redistribute_inputs=True)
        out = body(x)
        return out if tuple(pl) == tuple(x.placements) else \
            out.redistribute(x.device_mesh, x.placements)

    def walk(node, dims):
        if isinstance(node, dict):
            return {k: walk(x, dims if dims is None or isinstance(dims, int)
                            else dims[k]) for k, x in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(
                walk(x, dims if dims is None or isinstance(dims, int)
                     else dims[i]) for i, x in enumerate(node))
        return pad(node, dims)

    return walk(cache, seq_dims)


# ---------------------------------------------------------------------------
# Load generator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float          # seconds on the trace clock
    prompt: np.ndarray      # [len] int32
    max_new: int


def make_requests(n: int, *, prompt_len: int, max_new: int, rate: float,
                  vocab: int, seed: int = 0) -> List[Request]:
    """Poisson arrivals (rate req/s), prompt lengths uniform in
    [4, prompt_len], per-request token budgets uniform in
    [max(1, max_new//2), max_new]. The same numpy stream as the
    reference, so both packages replay the same trace."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n) if rate > 0 else np.zeros(n)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, prompt_len + 1))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        budget = int(rng.integers(max(1, max_new // 2), max_new + 1))
        reqs.append(Request(i, float(arrivals[i]), prompt, budget))
    return reqs


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _summarize(emits: Dict[int, List[float]], requests: List[Request],
               util_samples: List[float], prefill_s: float, decode_s: float,
               steps: int) -> Dict[str, object]:
    """Per-token latency (first token measured from arrival, later tokens
    from the previous emit), throughput over the whole trace."""
    lat = []
    t_end = 0.0
    total = 0
    for r in requests:
        prev = r.arrival
        for t in emits.get(r.rid, []):
            lat.append(t - prev)
            prev = t
            t_end = max(t_end, t)
            total += 1
    lat_ms = np.array(sorted(lat)) * 1e3
    return {
        "tokens": total,
        "tokens_per_s": total / max(t_end, 1e-9),
        "p50_ms": float(np.percentile(lat_ms, 50)) if total else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if total else None,
        "kv_util": float(np.mean(util_samples)) if util_samples else None,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_steps": steps,
    }


# ---------------------------------------------------------------------------
# Scheduler 1: padded lockstep (the baseline)
# ---------------------------------------------------------------------------


def run_lockstep(model, params, cfg, requests: List[Request], *,
                 n_slots: int, page: int, eos_id: Optional[int],
                 policy=None) -> Dict[str, object]:
    """Static FIFO batches over a dense right-padded cache, on the device
    the parameters live on, every step under ``policy`` (default: the
    session's). Returns the trace's summary and ``outputs``: each
    request's greedy tokens, by rid."""
    dev = params["embed"].device
    prefill, decode = _make_steps(model, params, policy)
    p_max = _bucket(max(len(r.prompt) for r in requests))
    total_max = max(len(r.prompt) + r.max_new for r in requests)
    s_max = max(-(-total_max // page) * page, -(-p_max // page) * page)

    # warm up outside the clock (kernel build/load, library handles)
    zeros = _ints(np.zeros(n_slots), dev)
    _, wcache = prefill(params, {"tokens": _ints(np.zeros((n_slots, p_max)),
                                                 dev)})
    wcache = pad_cache_to(wcache, p_max, s_max, 2)
    decode(params, {"token": zeros, "lengths": zeros}, wcache)
    _sync(dev)

    clock = 0.0
    prefill_s = decode_s = 0.0
    steps = 0
    emits: Dict[int, List[float]] = {}
    outputs: Dict[int, List[int]] = {}     # rid -> its greedy tokens
    utils: List[float] = []
    # live telemetry: one enabled check per run, then per-token histogram
    # observes of exactly the quantity _summarize computes post hoc (first
    # token from arrival, later tokens from the previous emit)
    telemetry = obs.enabled()
    hist = (obs.histogram("serve_token_latency_seconds",
                          "per-token emit latency (live)",
                          scheduler="lockstep") if telemetry else None)
    prev_emit: Dict[int, float] = {}
    queue = deque(sorted(requests, key=lambda r: r.arrival))
    while queue:
        batch = [queue.popleft() for _ in range(min(n_slots, len(queue)))]
        # static batching: the batch launches when its LAST request arrives
        clock = max(clock, max(r.arrival for r in batch))
        toks = np.zeros((n_slots, p_max), np.int32)
        lens = np.zeros((n_slots,), np.int32)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)

        t0 = time.perf_counter()
        with obs.span("serve_prefill", scheduler="lockstep",
                      batch=len(batch)):
            _, cache = prefill(params, {"tokens": _ints(toks, dev)})
            cache = pad_cache_to(cache, p_max, s_max, 2)
            _sync(dev)
        dt = _elapsed(t0, params)
        clock += dt
        prefill_s += dt

        # re-feed each row's last prompt token at position len-1: the cache
        # write is idempotent (same k/v), and the step's logits are exactly
        # the model's next-token prediction at the prompt end
        cur = _ints(toks[np.arange(n_slots), np.maximum(lens - 1, 0)], dev)
        lengths = _ints(np.maximum(lens - 1, 0), dev)
        produced = np.zeros(n_slots, np.int64)
        active = np.array([i < len(batch) for i in range(n_slots)])
        # lockstep's cost: the batch steps until its slowest row finishes
        while active.any():
            t0 = time.perf_counter()
            with obs.span("serve_decode_step", scheduler="lockstep"):
                nxt, _, cache = decode(
                    params, {"token": cur, "lengths": lengths}, cache)
                nxt_np = _host_tokens(nxt)
                _sync(dev)
            dt = _elapsed(t0, params)
            clock += dt
            decode_s += dt
            steps += 1
            for i in np.nonzero(active)[0]:
                r = batch[i]
                tok = int(nxt_np[i])
                emits.setdefault(r.rid, []).append(clock)
                outputs.setdefault(r.rid, []).append(tok)
                if telemetry:
                    hist.observe(clock - prev_emit.get(r.rid, r.arrival))
                    prev_emit[r.rid] = clock
                produced[i] += 1
                if tok == eos_id or produced[i] >= r.max_new:
                    active[i] = False      # retired; cache stays allocated
            cur = nxt
            lengths = lengths + 1
            live = sum(lens[i] + produced[i] for i in range(len(batch)))
            utils.append(live / (n_slots * s_max))
    out = _summarize(emits, requests, utils, prefill_s, decode_s, steps)
    out["outputs"] = outputs
    return out


# ---------------------------------------------------------------------------
# Scheduler 2: paged continuous batching
# ---------------------------------------------------------------------------


def run_continuous(model, params, cfg, requests: List[Request], *,
                   n_slots: int, page: int, eos_id: Optional[int],
                   policy=None, pool_blocks: Optional[int] = None
                   ) -> Dict[str, object]:
    """Continuous batching over a :class:`PagedKVCache`: admit on arrival
    into free slots, retire per step, recycle blocks; every step under
    ``policy`` (default: the session's). Returns the trace's summary, the
    pool's, ``outputs`` (each request's greedy tokens, by rid) and
    ``admissions`` (each admission's rid, slot and the decode steps run
    before it)."""
    dev = params["embed"].device
    prefill, decode = _make_steps(model, params, policy)
    n_pages_max = max(-(-(len(r.prompt) + r.max_new) // page)
                      for r in requests)
    if pool_blocks is None:
        pool_blocks = n_slots * n_pages_max
    # a single empty-pool admission must always fit, else admission stalls
    pool_blocks = max(pool_blocks, n_pages_max)

    def fresh_cache():
        return PagedKVCache(
            n_layers=cfg.n_layers, n_blocks=pool_blocks, page=page,
            kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=n_slots,
            n_pages_max=n_pages_max, dtype=cfg.cdtype, device=dev)

    buckets = sorted({_bucket(len(r.prompt)) for r in requests})

    # warm up every prefill bucket, the admission scatter and decode
    warm = fresh_cache()
    for i, pb in enumerate(buckets):
        _, wc = prefill(params, {"tokens": _ints(np.zeros((1, pb)), dev)})
        warm.admit(i % n_slots, wc["k"][:, 0], wc["v"][:, 0], 4, 4)
        warm.retire(i % n_slots)
    zeros = _ints(np.zeros(n_slots), dev)
    decode(params, {"token": zeros, "lengths": zeros}, warm.cache_view())
    _sync(dev)

    kv = fresh_cache()
    clock = 0.0
    prefill_s = decode_s = 0.0
    steps = 0
    emits: Dict[int, List[float]] = {}
    outputs: Dict[int, List[int]] = {}     # rid -> its greedy tokens
    admissions: List[List[int]] = []       # [rid, slot, steps before it]
    utils: List[float] = []
    utils_pool: List[float] = []
    telemetry = obs.enabled()
    hist = (obs.histogram("serve_token_latency_seconds",
                          "per-token emit latency (live)",
                          scheduler="paged") if telemetry else None)
    kv_gauge = (obs.gauge("serve_kv_utilization",
                          "paged KV pool utilization vs allocated blocks")
                if telemetry else None)
    prev_emit: Dict[int, float] = {}
    pending = deque(sorted(requests, key=lambda r: r.arrival))
    slot_req: List[Optional[Request]] = [None] * n_slots
    cur = np.zeros(n_slots, np.int32)
    produced = np.zeros(n_slots, np.int64)

    def active_mask():
        return np.array([r is not None for r in slot_req])

    while pending or active_mask().any():
        # admit arrived requests into free slots while blocks allow
        while pending and pending[0].arrival <= clock:
            free = [i for i, r in enumerate(slot_req) if r is None]
            if not free:
                break
            r = pending[0]
            need = -(-(len(r.prompt) + r.max_new) // page)
            if need > kv.allocator.n_free:
                break                       # wait for a retirement
            pending.popleft()
            slot = free[0]
            plen = len(r.prompt)
            toks = np.zeros((1, _bucket(plen)), np.int32)
            toks[0, :plen] = r.prompt
            t0 = time.perf_counter()
            with obs.span("serve_admit", scheduler="paged", rid=r.rid,
                          slot=slot, prompt_len=plen):
                _, pc = prefill(params, {"tokens": _ints(toks, dev)})
                kv.admit(slot, pc["k"][:, 0], pc["v"][:, 0], plen,
                         plen + r.max_new)
                _sync(dev)
            dt = _elapsed(t0, params)
            clock += dt
            prefill_s += dt
            admissions.append([r.rid, slot, steps])
            slot_req[slot] = r
            cur[slot] = int(r.prompt[-1])
            produced[slot] = 0
            # first decode step re-feeds the last prompt token at
            # position plen-1 (idempotent cache write, exact logits)
            kv.lengths[slot] = plen - 1

        act = active_mask()
        if not act.any():
            if pending:
                clock = max(clock, pending[0].arrival)
                continue
            break

        t0 = time.perf_counter()
        with obs.span("serve_decode_step", scheduler="paged"):
            nxt, _, new_caches = decode(
                params, {"token": _ints(cur, dev),
                         "lengths": _ints(kv.lengths, dev)},
                kv.cache_view())
            nxt_np = _host_tokens(nxt)
            _sync(dev)
        dt = _elapsed(t0, params)
        clock += dt
        decode_s += dt
        steps += 1
        kv.update(new_caches)
        kv.append(act.astype(np.int32))
        for slot in np.nonzero(act)[0]:
            r = slot_req[slot]
            tok = int(nxt_np[slot])
            emits.setdefault(r.rid, []).append(clock)
            outputs.setdefault(r.rid, []).append(tok)
            if telemetry:
                hist.observe(clock - prev_emit.get(r.rid, r.arrival))
                prev_emit[r.rid] = clock
            produced[slot] += 1
            if tok == eos_id or produced[slot] >= r.max_new:
                with obs.span("serve_retire", scheduler="paged",
                              rid=r.rid, slot=int(slot)):
                    kv.retire(slot)         # blocks recycle immediately
                slot_req[slot] = None
            else:
                cur[slot] = tok
        u = kv.utilization()
        utils.append(u["util_vs_allocated"])
        utils_pool.append(u["util_vs_pool"])
        if telemetry:
            kv_gauge.set(u["util_vs_allocated"])
    out = _summarize(emits, requests, utils, prefill_s, decode_s, steps)
    out["kv_util_pool"] = (float(np.mean(utils_pool))
                           if utils_pool else None)
    out["pool_blocks"] = pool_blocks
    out["page"] = page
    out["outputs"] = outputs
    out["admissions"] = admissions
    return out


# ---------------------------------------------------------------------------
# Bitwise parity probe (paged vs. contiguous decode on identical state)
# ---------------------------------------------------------------------------


def decode_parity_probe(model, params, cfg, *, page: int, n_steps: int = 3,
                        seed: int = 0, policy=None) -> float:
    """Run ``n_steps`` greedy decode steps from the same prefill state
    through (a) the dense right-padded cache and (b) the paged pool, and
    return the max abs logits difference (0.0 = bitwise identical).
    Under "ff" it requires ``cfg.decode_block_kv == page``."""
    dev = params["embed"].device
    rng = np.random.default_rng(seed)
    b = 2
    lens = np.array([11, 24], np.int32)
    p_max = int(lens.max())
    toks = np.zeros((b, p_max), np.int32)
    for i in range(b):
        toks[i, :lens[i]] = rng.integers(1, cfg.vocab, size=lens[i])
    n_pages = -(-(p_max + n_steps) // page)
    s_max = n_pages * page

    prefill, decode = _make_steps(model, params, policy)

    _, dense = prefill(params, {"tokens": _ints(toks, dev)})
    dense_cache = pad_cache_to(dense, p_max, s_max, 2)

    kv = PagedKVCache(
        n_layers=cfg.n_layers, n_blocks=b * n_pages + 2, page=page,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=b,
        n_pages_max=n_pages, dtype=cfg.cdtype, device=dev)
    for i in range(b):
        kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(lens[i]), s_max)

    cur_d = _ints(toks[np.arange(b), lens - 1], dev)
    cur_p = cur_d
    len_d = _ints(lens - 1, dev)
    kv.lengths[:] = lens - 1
    max_diff = 0.0
    for _ in range(n_steps):
        nd, logits_d, dense_cache = decode(
            params, {"token": cur_d, "lengths": len_d}, dense_cache)
        np_, logits_p, new_caches = decode(
            params, {"token": cur_p, "lengths": _ints(kv.lengths, dev)},
            kv.cache_view())
        kv.update(new_caches)
        kv.append(np.ones(b, np.int32))
        diff = (shlib.full_tensor(logits_d).float()
                - shlib.full_tensor(logits_p).float()).abs().max().item()
        max_diff = max(max_diff, diff)
        cur_d, cur_p = nd, np_
        len_d = len_d + 1
    return max_diff


# ---------------------------------------------------------------------------
# Benchmark entry
# ---------------------------------------------------------------------------


def serve_bench(args) -> Dict[str, object]:
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        # the reference's refusal, word for word
        raise SystemExit("serve driver targets decoder-only archs")
    if cfg.family in ("ssm", "hybrid") or cfg.kv_lora_rank:
        # no dense "k" cache to pad or page (MLA keeps a latent {"c",
        # "k_rope"}), and a recurrent state would take the lockstep re-feed
        # of the last prompt token twice; the reference's schedulers cannot
        # run these families either
        family = "MLA" if cfg.kv_lora_rank else cfg.family
        raise SystemExit(
            f"serve: {args.arch} ({family}) is not served by these "
            f"schedulers: they keep a dense or paged K/V cache, which the "
            f"{family} family does not have. Drive it through "
            f"repro_torch.launch.steps (make_prefill_step, "
            f"make_decode_step) instead.")
    device = resolve_device(args.device)
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    if args.impl != "cfg":
        cfg = cfg.replace(attn_impl=args.impl)
    if cfg.attn_impl == "ff":
        # pin the dense path's KV tile to the page so lockstep decode is
        # bitwise-identical to the paged kernel
        cfg = cfg.replace(decode_block_kv=args.page)
    if args.layer_graph:
        # route dense-cache decode steps through the whole-layer
        # decode_layer kernels (the paged scheduler keeps the per-op path)
        cfg = cfg.replace(layer_graph=True)
    from repro_torch.core.program import PipePolicy, current_policy
    # --policy-mode sets the mode alone; without it the session's policy
    # (``with repro_torch.policy(...)``, default ``ff``) sizes every step
    mode = getattr(args, "policy_mode", None)
    policy = PipePolicy(mode=mode) if mode else current_policy()
    model = build_model(cfg)
    requests = make_requests(
        args.requests, prompt_len=args.prompt_len, max_new=args.max_new,
        rate=args.rate, vocab=cfg.vocab, seed=args.seed)

    # on a mesh when torchrun (or a process group already joined) says so;
    # at world 1 no process group is started and no DTensor made
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    mesh, rank = None, 0
    if world > 1:
        rank, world, device = mesh_lib.init_distributed(
            device, getattr(args, "dist_backend", None))
        mesh = mesh_lib.make_host_mesh(device_type=device.type)
    shape, names = mesh_lib.host_mesh_shape(world)
    lead = rank == 0
    counters = launch_counters()
    launches_before = [w.launches for w in counters]

    # plan-service hooks: --plan-db points the autotune lookup chain at a
    # release PlanDB (pre-warmed here so the first resolution is a dict
    # hit, not file IO; on every rank); --record-profile captures this
    # run's traffic for an offline sweep (see repro_torch.plans; rank 0)
    from repro_torch.core import autotune
    plan_service: Dict[str, object] = {}
    # --metrics-json opts into live telemetry (rank 0): per-token latency
    # histograms and the kv gauge observe only while obs is enabled
    metrics_path = getattr(args, "metrics_json", None) if lead else None
    trace_state = None
    if metrics_path and not obs.enabled():
        trace_state = obs.enable()      # in-memory ring, no JSONL sink
    with contextlib.ExitStack() as stack:
        if getattr(args, "plan_db", None):
            from repro_torch.plans import plandb as plandb_lib
            stack.enter_context(autotune.tuning_config(plan_db=args.plan_db))
            plan_service["prewarm"] = plandb_lib.prewarm(args.plan_db)
            if lead:
                print(f"# plan-db {args.plan_db}: "
                      f"{plan_service['prewarm']['records_in_namespace']} "
                      f"records for namespace "
                      f"{plan_service['prewarm']['namespace']}")
        profile = None
        if getattr(args, "record_profile", None) and lead:
            from repro_torch.plans import record_traffic
            profile = stack.enter_context(
                record_traffic(args.record_profile))
        if mesh is not None:
            stack.enter_context(shlib.use_sharding(
                mesh, overrides=cfg.rule_overrides))

        # weights from a fixed seed on every rank, as the reference's
        # key(0), then each rank keeps its shards; --seed is the trace's
        params = model.init_cast(
            torch.Generator(device=device).manual_seed(0), device)
        if mesh is not None:
            params = shlib.place_tree(params, model.param_axes())
        lockstep = run_lockstep(model, params, cfg, requests,
                                n_slots=args.slots, page=args.page,
                                eos_id=args.eos_id, policy=policy)
        paged = run_continuous(model, params, cfg, requests,
                               n_slots=args.slots, page=args.page,
                               eos_id=args.eos_id, policy=policy,
                               pool_blocks=args.pool_blocks)
        bitwise = decode_parity_probe(model, params, cfg, page=args.page,
                                      policy=policy)
        if profile is not None:
            plan_service["recorded"] = {
                "path": args.record_profile,
                "buckets": len(profile),
                "observations": profile.total_count}
        if getattr(args, "plan_db", None) or profile is not None:
            plan_service["stats"] = autotune.plan_stats_snapshot()
    compiled = model.__dict__.get("_compiled_steps", {})
    result = {
        "arch": args.arch,
        "mesh": dict(zip(names, shape)),
        "device": {"type": device.type,
                   "name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")},
        "smoke": bool(args.smoke),
        "n_layers": cfg.n_layers,
        "impl": cfg.attn_impl,
        "policy_mode": policy.mode,
        "requests": args.requests,
        "slots": args.slots,
        "page": args.page,
        "rate_req_per_s": args.rate,
        "prompt_len": args.prompt_len,
        "max_new": args.max_new,
        "lockstep": lockstep,
        "paged": paged,
        "speedup_tokens_per_s": (paged["tokens_per_s"]
                                 / max(lockstep["tokens_per_s"], 1e-9)),
        "p99_ratio": (lockstep["p99_ms"] / max(paged["p99_ms"], 1e-9)
                      if lockstep["p99_ms"] and paged["p99_ms"] else None),
        "bitwise_max_abs_diff": bitwise,
        "bitwise_identical": bitwise == 0.0,
        "token_count_parity": lockstep["tokens"] == paged["tokens"],
        # CUDA graphs captured per step kind (none on the CPU or a mesh:
        # eager steps)
        "compiled_graphs": {kind: len(step.graphs)
                            for kind, step in compiled.items()},
        # this rank's kernel launches over the run, by op (0 on the CPU)
        "kernel_launches": {w.op_name: w.launches - n
                            for w, n in zip(counters, launches_before)
                            if w.launches > n},
        "ranks_agree": (True if mesh is None
                        else _ranks_agree(requests, lockstep, paged,
                                          device)),
    }
    if plan_service:
        result["plan_service"] = plan_service
        if "recorded" in plan_service:
            rec = plan_service["recorded"]
            print(f"# recorded traffic profile: {rec['buckets']} buckets / "
                  f"{rec['observations']} observations -> {rec['path']}")
    if metrics_path:
        with open(metrics_path, "w") as f:
            json.dump(obs.metrics_snapshot(), f, indent=2, sort_keys=True)
        result["metrics_json"] = metrics_path
        print(f"# wrote live metrics snapshot -> {metrics_path}")
        if trace_state is not None:
            obs.restore(trace_state)
    return result


def _ranks_agree(requests: List[Request], lockstep, paged,
                 device: torch.device) -> bool:
    """Whether every rank of the default group emitted the same tokens by
    rid in both schedulers: one all-gather of each rank's outputs, laid
    out [scheduler, request, its budget] (-1 past its last token)."""
    row = {r.rid: j for j, r in enumerate(requests)}
    mine = torch.full((2, len(requests), max(r.max_new for r in requests)),
                      -1, dtype=torch.int64)
    for i, run in enumerate((lockstep, paged)):
        for rid, toks in run["outputs"].items():
            mine[i, row[rid], :len(toks)] = torch.as_tensor(toks)
    mine = mine.to(_coll_device(device))
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(t, mine) for t in every)


def add_serve_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1_5_0p5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config to this many layers, at full "
                         "width (a model whose every layer does not fit "
                         "one card: grok-1's 64 layers are 1,179 GiB in "
                         "f32, qwen2-72b's 80 are 270.9 GiB)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page", type=int, default=16,
                    help="KV block (page) size in tokens; also pins the "
                         "dense path's block_kv for bitwise parity")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (batch rows) for both schedulers")
    ap.add_argument("--rate", type=float, default=10.0,
                    help="Poisson arrival rate, requests/s (0 = all at t=0)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="retire a slot when it emits this token")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged pool size in blocks (default: slots x "
                         "max pages per request)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("ff", "xla", "cfg"), default="ff",
                    help="attention implementation: ff = the CUDA kernels "
                         "(default), xla = the reference's unfused plain "
                         "PyTorch path, cfg = whatever the arch config pins")
    ap.add_argument("--layer-graph", action="store_true",
                    help="run each dense-cache (lockstep) decode step "
                         "through the whole-layer decode_layer kernels: "
                         "q-projection with RMSNorm/bias/RoPE, attention, "
                         "and the MLP tail as one launch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--policy-mode", choices=("ff", "baseline", "autotune"),
                    default=None,
                    help="PipePolicy mode of the prefill/decode step "
                         "bodies (default: the session policy's, ff "
                         "unless a caller installed another): ff = planned "
                         "pipes, "
                         "baseline = the synchronous depth-1 strawman, "
                         "autotune = measured plans (served from the plan "
                         "cache / PlanDB inside compiled steps)")
    ap.add_argument("--record-profile", default=None, metavar="PATH",
                    help="record every plan resolution into a "
                         "TrafficProfile JSON at PATH (the input of "
                         "`python -m repro_torch.plans sweep`)")
    ap.add_argument("--plan-db", default=None, metavar="PATH",
                    help="release PlanDB consulted after the per-host plan "
                         "cache and before measuring (pre-warmed at "
                         "startup; overrides $REPRO_TORCH_PLAN_DB)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable live telemetry (per-token latency "
                         "histograms, plan-source counters) and write "
                         "obs.metrics_snapshot() to PATH at exit")
    ap.add_argument("--dist-backend", choices=mesh_lib.BACKENDS,
                    default=None,
                    help="process-group backend under torchrun (default: "
                         "nccl with a card a rank, gloo_staged for ranks "
                         "sharing a card, gloo on cpu)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_serve_args(ap)
    ap.add_argument("--json", default=None,
                    help="write the benchmark dict to this path")
    args = ap.parse_args(argv)
    joined = dist.is_initialized()
    try:
        result = serve_bench(args)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()
    if rank:
        return result                  # rank 0 alone prints and writes
    ls, pg = result["lockstep"], result["paged"]
    print(f"impl={result['impl']} policy={result['policy_mode']} "
          f"mesh={result['mesh']} device={result['device']} "
          f"requests={args.requests} slots={args.slots} page={args.page}")
    for name, m in (("lockstep", ls), ("paged", pg)):
        print(f"{name:9s}: {m['tokens']} tokens, "
              f"{m['tokens_per_s']:.2f} tok/s, "
              f"p50 {m['p50_ms']:.1f} ms, p99 {m['p99_ms']:.1f} ms, "
              f"kv util {m['kv_util']:.2f}, "
              f"decode {m['decode_s']:.3f} s / {m['decode_steps']} steps")
    print(f"speedup x{result['speedup_tokens_per_s']:.2f} tok/s, "
          f"p99 x{result['p99_ratio']:.2f}, "
          f"bitwise diff {result['bitwise_max_abs_diff']:.1e}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
