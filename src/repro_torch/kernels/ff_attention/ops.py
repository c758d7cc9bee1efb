"""Prefill flash attention and attention -> out-projection: wrappers,
plain versions, launch counts.

:func:`attention` replaces the TPU kernel
``repro/kernels/ff_attention/kernel.py`` (``build_program`` /
``flash_attention_ff``, wrapper ``ops.py:_apply``); its CUDA kernel is
``csrc/ff_attention.cu``. :func:`attention_proj` replaces the
``attention_proj`` StreamGraph (``repro/models/layers.py:
build_attention_proj_graph``, the attention output streamed into the
``ff_matmul`` out-projection in one launch); its CUDA kernel is
``csrc/ff_attention_proj.cu``. Both run the bodies of
``csrc/ff_attention.cuh``; each kernel's note says what bounds it on the
H100 and what its design does about that.

``depth`` and ``streams`` are the reference's ``flash_attention_ff``
keywords: the stages of the shared-memory ring that carries the K and V
tiles to the consumers (the tensor cores in bf16, the CUDA cores in f32),
and the boxes each tile copy is split into (``depth=1`` is the
synchronous copy-then-compute baseline). Each type has its own tiles
(:data:`BLOCK_Q`, :data:`BLOCK_KV`), so its own deepest ring
(:func:`max_depth`) and stream counts. They change when a tile lands,
never what is computed. Both entry points resolve them through the pipe
policy (``policy=``, the session policy, or the ``depth=``/``streams=``
keywords), as the reference's do: :func:`attention` as the kernel
``ff_attention`` (:func:`attention_workload`), :func:`attention_proj` as
the graph ``attention_proj`` (its two nodes' workloads summed).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.pipe import itemsize
from repro_torch.core.pipeline_model import Workload
from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels import _build
from repro_torch.kernels.ff_matmul.ops import matmul_ref, matmul_workload
from repro_torch.kernels.registry import KernelCost, register_kernel

# q rows per CUDA block and K/V rows per tile, by type (csrc/
# ff_attention.cuh: bf16 the wgmma body wg, f32 the CUDA-core body f32)
BLOCK_Q = {torch.bfloat16: 64, torch.float32: 64}
BLOCK_KV = {torch.bfloat16: 64, torch.float32: 32}
_NEG_INF = -1e30
_MAX_D = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# a stage holds a K and a V tile of BLOCK_KV rows by d padded to whole
# 128-byte slabs (64 bf16 or 32 f32 columns); the q tile is BLOCK_Q rows
# of the same slabs; the f32 body also keeps its p tile (BLOCK_Q x 32 f32)
_SLAB_COLS = {torch.bfloat16: 64, torch.float32: 32}
_MAX_SMEM = 232448                  # 227 KB of shared memory a block
_MIN_STREAM_ROWS = 8                # one 128-byte swizzle atom of rows


def _smem_bytes(d: int, depth: int, dtype=torch.bfloat16) -> int:
    """Shared memory of the block at head dim ``d``, ring ``depth`` and
    type (csrc/ff_attention.cuh ``wg::smem_bytes``, ``f32::smem_bytes``):
    1024 bytes of alignment slack, the q tile, the f32 body's p tile, the
    stages, and two mbarriers a stage plus the q tile's."""
    slabs = -(-d // _SLAB_COLS[dtype])
    p_tile = BLOCK_Q[dtype] * 128 if dtype == torch.float32 else 0
    return (1024 + slabs * 128 * (BLOCK_Q[dtype] + 2 * depth
                                  * BLOCK_KV[dtype])
            + p_tile + 8 * (2 * depth + 1))


def max_depth(d: int, dtype=torch.bfloat16) -> int:
    """The deepest ring that fits one block's shared memory at head dim
    ``d`` in ``dtype``."""
    depth = 1
    while _smem_bytes(d, depth + 1, dtype) <= _MAX_SMEM:
        depth += 1
    return depth


def stream_options(options, dtype=torch.bfloat16) -> tuple:
    """The stream counts of ``options`` this kernel can run in ``dtype``:
    those that split its K/V tiles (64 rows bf16, 32 f32) into boxes of at
    least 8 rows."""
    rows = BLOCK_KV[dtype]
    return tuple(s for s in options
                 if rows % s == 0 and rows // s >= _MIN_STREAM_ROWS)


def _pipe(depth, streams, d, dtype=torch.bfloat16):
    """``depth`` and ``streams`` checked as the reference's ``Pipe`` checks
    them against this kernel's tiles in ``dtype``: each at least 1,
    ``streams`` dividing the K/V tiles' rows into boxes of at least 8 rows
    (one swizzle atom), ``depth`` stages fitting in shared memory at head
    dim ``d``."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    rows = BLOCK_KV[dtype]
    if rows % streams or rows // streams < _MIN_STREAM_ROWS:
        raise ValueError(f"streams={streams} must split the tile's {rows} "
                         f"rows into boxes of at least {_MIN_STREAM_ROWS} "
                         f"rows")
    if d <= _MAX_D and depth > max_depth(d, dtype):
        raise ValueError(f"depth {depth} needs {_smem_bytes(d, depth, dtype)}"
                         f" bytes of shared memory at head dim {d}; at most "
                         f"{max_depth(d, dtype)} stages fit in {_MAX_SMEM}")
    return depth, streams


def _live_tiles(s: int, skv: int, causal: bool, bq: int, bkv: int) -> int:
    """KV tiles the kernel streams for all q tiles of one head: every tile
    of the cache, or under ``causal`` only those at or before each q
    tile's last row (the kernel skips the rest)."""
    nq, nkv = -(-s // bq), -(-skv // bkv)
    if not causal:
        return nq * nkv
    return sum(min(nkv, -(-min(s, (qi + 1) * bq) // bkv))
               for qi in range(nq))


def attention_workload(bh: int, s: int, d: int, *, skv=None,
                       causal: bool = True, dtype=torch.bfloat16
                       ) -> Tuple[Workload, Tuple[int, int]]:
    """The kernel's stream program in pipe words: one word per (head, q
    tile, live KV tile), a K and a V tile of :data:`BLOCK_KV` rows (64
    bf16, 32 f32). The reference counts every (q tile, KV tile) pair of
    its 128-row blocks and halves the flops under ``causal``; the port's
    kernel skips the tiles past a q tile's diagonal, so its words are the
    live ones and each does a whole tile's flops. The output is written
    once, spread over the words. Planning tile = the K tile."""
    skv = s if skv is None else skv
    item = itemsize(dtype)
    bq, bkv = BLOCK_Q[dtype], BLOCK_KV[dtype]
    n_words = max(bh * _live_tiles(s, skv, causal, bq, bkv), 1)
    w = Workload(
        n_words=n_words,
        word_bytes=float(2 * bkv * d * item),
        flops_per_word=4.0 * bq * bkv * d,
        regular=True,
        store_bytes_per_word=float(bh * s * d * item) / n_words,
    )
    return w, (bkv, d)


def attention_cost(bh: int, s: int, d: int, *, skv=None,
                   causal: bool = True, depth: int = 2,
                   dtype=torch.bfloat16) -> KernelCost:
    """Operations and bytes of one call by the kernel's tile schedule: the
    live K/V tiles of every q tile, q read and the output written once."""
    w, _ = attention_workload(bh, s, d, skv=skv, causal=causal, dtype=dtype)
    item = itemsize(dtype)
    hbm = w.n_words * w.word_bytes + 2 * bh * s * d * item
    return KernelCost(flops=w.n_words * w.flops_per_word,
                      hbm_bytes=float(hbm),
                      smem_bytes=_smem_bytes(d, depth, dtype))


def _resolve(op, pol, q, k, kv_groups, causal, run):
    """(depth, streams) of one prefill attention call under ``pol``."""
    bh, s, d = q.shape
    skv = k.shape[1]
    so = stream_options(pol.stream_options, q.dtype)
    pol = pol if so == tuple(pol.stream_options) else \
        pol.replace(stream_options=so)
    w, tile = attention_workload(bh, s, d, skv=skv, causal=causal,
                                 dtype=q.dtype)
    choice = autotune.resolve_call(
        op, pol, workload=w, tile=tile, dtype=q.dtype,
        workload_fn=lambda tk: (w, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(dep, st),
        # the workload is built from the q shape only; skv/kv_groups
        # change the measured kernel
        extra_key=f"skv={skv}|groups={kv_groups}",
        site={"bh": bh, "s": s, "d": d, "skv": skv,
              "kv_groups": kv_groups, "causal": causal},
        site_dynamic=("bh", "s", "skv"),
        depth_cap=max_depth(d, q.dtype))
    return _pipe(choice.depth, choice.streams, d, q.dtype)


def attention_ref(q, k, v, *, kv_groups: int = 1, causal: bool = True,
                  block_kv=None) -> torch.Tensor:
    """Plain version of the kernel: the same online softmax over K/V tiles
    of ``block_kv`` rows (default: the kernel's tile for q's type,
    :data:`BLOCK_KV`), in f32, with ``p`` rounded to V's type before the
    PV product. q: [BH, S, D]; k, v: [BKVH, Skv, D] -> [BH, S, D].

    All q rows are processed at once; tiles past a row's diagonal add
    exactly 0 (masked scores give ``exp == 0`` and ``alpha == 1``), so this
    equals the kernel's per-q-tile skipping."""
    bh, s, d = q.shape
    skv = k.shape[1]
    block_kv = block_kv or BLOCK_KV[q.dtype]
    kk = k.repeat_interleave(kv_groups, dim=0)
    vv = v.repeat_interleave(kv_groups, dim=0)
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((bh, s, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    n_kv = -(-skv // block_kv)
    if causal:
        n_kv = min(n_kv, -(-s // block_kv))
    for kj in range(n_kv):
        kv0 = kj * block_kv
        kt = kk[:, kv0:kv0 + block_kv].float()
        vt = vv[:, kv0:kv0 + block_kv]
        sc = torch.matmul(qf, kt.transpose(1, 2)) * scale
        if causal:
            cols = kv0 + torch.arange(kt.shape[1], device=q.device)[None, :]
            sc = torch.where(rows >= cols, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(vt.dtype).float(), vt.float())
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """ff_attention_<type>: the ring's depth and streams after the
    scale."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ff_attention", f"ff_attention_{_SUFFIX[dtype]}",
                       [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i,
                        p])


def _check(q, k, v, kv_groups):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"attention wants q [BH,S,D], k=v [BKVH,Skv,D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] * kv_groups or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} with kv_groups={kv_groups}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"attention takes float32 or bfloat16 q/k/v of one "
                        f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _launch(q, k, v, kv_groups, causal, depth, streams) -> torch.Tensor:
    bh, s, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), bh, s, k.shape[1], d, kv_groups,
                         int(causal), 1.0 / math.sqrt(d), depth, streams,
                         _build.stream_ptr(q.device))
    _build.check("ff_attention", "ff_attention", rc)
    return out


def _apply(q, k, v, *, kv_groups: int = 1, causal: bool = True,
           policy: PipePolicy) -> torch.Tensor:
    """Flash attention over [BH, S, D] q and [BKVH, Skv, D] k/v (q head
    ``bh`` reads KV head ``bh // kv_groups``). The ring that feeds the
    consumers is sized by ``policy`` within the type's ring (planned per
    call site under "ff", measured under "autotune", depth 1 under
    "baseline"); it does not change the result. mode="ref" and CPU tensors run
    :func:`attention_ref`; CUDA tensors launch the kernel."""
    _check(q, k, v, kv_groups)
    if policy.mode == "ref":
        return attention_ref(q, k, v, kv_groups=kv_groups, causal=causal)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    if q.device.type == "cuda" and q.shape[2] > _MAX_D:
        raise ValueError(f"head dim {q.shape[2]} > {_MAX_D}")

    def run(depth, streams):
        if q.device.type == "cpu":
            return attention_ref(q, k, v, kv_groups=kv_groups,
                                 causal=causal)
        return _launch(q, k, v, kv_groups, causal, depth, streams)

    depth, streams = _resolve("ff_attention", policy, q, k, kv_groups,
                              causal, run)
    out = run(depth, streams)
    if q.device.type == "cuda":
        attention.launches += 1
    return out


attention = make_entrypoint("ff_attention", _apply, name="attention")


def attention_proj_ref(q, k, v, w, *, causal: bool = True) -> torch.Tensor:
    """Plain version of the fused kernel, rounding where the reference
    graph rounds: the attention output in q's type (the graph's attention
    program writes its ring in the operand type), then the product in f32,
    rounded once. q: [BH, S, D]; k, v: [BH, Skv, D]; w: [D, D_out] ->
    [BH*S, D_out]."""
    bh, s, d = q.shape
    a = attention_ref(q, k, v, causal=causal)
    return matmul_ref(a.reshape(bh * s, d), w)


@functools.lru_cache(maxsize=None)
def _proj_entry(dtype: torch.dtype):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ff_attention_proj",
                       f"ff_attention_proj_{_SUFFIX[dtype]}",
                       [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i,
                        i, p])


def attention_proj_nodes(bh: int, s: int, d: int, d_out: int, *,
                         causal: bool = True, dtype=torch.bfloat16):
    """The graph's nodes as ``(name, Workload, tile)``: the attention's
    words, then the projection's (a [BH*S, D] @ [D, D_out] product in the
    port's product tiles)."""
    wa, ta = attention_workload(bh, s, d, causal=causal, dtype=dtype)
    wm, tm = matmul_workload(bh * s, d_out, d, dtype=dtype)
    return (("attention", wa, ta), ("proj", wm, tm))


def _apply_proj(q, k, v, w, *, causal: bool = True,
                policy: PipePolicy) -> torch.Tensor:
    """Attention over [BH, S, D] q and [BH, Skv, D] k/v (one KV head per q
    head, as the reference graph's), then the out-projection by w [D,
    D_out] (q's type), in one launch: the
    [BH, S, D] intermediate stays on chip. Returns [BH*S, D_out], equal
    bit for bit to ``matmul(attention(q, k, v).reshape(BH*S, D), w)`` at
    any ``depth`` and ``streams`` of either (as :func:`attention`'s: the
    projection's words of w ride the same ring). The ring is sized by
    ``policy`` for the whole graph (``autotune.resolve_graph``).
    mode="ref" and CPU tensors run :func:`attention_proj_ref`; CUDA
    tensors launch the kernel."""
    _check(q, k, v, 1)
    if w.dim() != 2 or w.shape[0] != q.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} is not [{q.shape[2]}, D_out]")
    if w.dtype != q.dtype:
        raise TypeError(f"w must have q's type {q.dtype}, not {w.dtype}")
    if w.device != q.device:
        raise ValueError("w must be on q's device")
    if policy.mode == "ref":
        return attention_proj_ref(q, k, v, w, causal=causal)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_proj runs on cpu or cuda, not "
                         f"{q.device}")
    bh, s, d = q.shape
    if q.device.type == "cuda" and d > _MAX_D:
        raise ValueError(f"head dim {d} > {_MAX_D}")

    def run(depth, streams):
        if q.device.type == "cpu":
            return attention_proj_ref(q, k, v, w, causal=causal)
        return _launch_proj(q, k, v, w, causal, depth, streams)

    nodes = attention_proj_nodes(bh, s, d, w.shape[1], causal=causal,
                                 dtype=q.dtype)
    wl, tile = autotune.graph_workload(nodes)
    so = stream_options(policy.stream_options, q.dtype)
    pol = policy if so == tuple(policy.stream_options) else \
        policy.replace(stream_options=so)
    choice = autotune.resolve_graph(
        "attention_proj", pol, workload=wl, tile=tile, dtype=q.dtype,
        signature=autotune.graph_signature(nodes),
        workload_fn=lambda tk: (wl, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(dep, st),
        site={"bh": bh, "s": s, "d": d, "d_out": w.shape[1],
              "causal": bool(causal)},
        site_dynamic=("bh", "s"),
        depth_cap=max_depth(d, q.dtype))
    out = run(*_pipe(choice.depth, choice.streams, d, q.dtype))
    if q.device.type == "cuda":
        attention_proj.launches += 1
    return out


def _launch_proj(q, k, v, w, causal, depth, streams) -> torch.Tensor:
    bh, s, d = q.shape
    q, k, v, w = q.contiguous(), k.contiguous(), v.contiguous(), \
        w.contiguous()
    out = torch.empty((bh * s, w.shape[1]), dtype=q.dtype, device=q.device)
    rc = _proj_entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), out.data_ptr(), bh, s,
                              k.shape[1], d, w.shape[1], int(causal),
                              1.0 / math.sqrt(d), depth, streams,
                              _build.stream_ptr(q.device))
    _build.check("ff_attention_proj", "ff_attention_proj", rc)
    return out


attention_proj = make_entrypoint("attention_proj", _apply_proj)


def _make_inputs(gen, device):
    q = torch.randn((2, 192, 64), generator=gen, device=device)
    kv = torch.randn((1, 192, 64), generator=gen, device=device)
    return (q, kv, kv), {"kv_groups": 2, "causal": True}


def _sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep): the KV batch is
    # bh / kv_groups, so bh snaps to a multiple of the group count; causal
    # self-attention keeps s == skv
    groups = int(site.get("kv_groups", 1))
    kvb = max(1, int(site["bh"]) // groups)
    bh, s, d = kvb * groups, int(site["s"]), int(site["d"])
    skv = s if site.get("causal", True) else int(site.get("skv", s))
    dt = getattr(torch, site.get("dtype", "float32"))
    q = torch.randn((bh, s, d), generator=gen, device=device).to(dt)
    kv = torch.randn((kvb, skv, d), generator=gen, device=device).to(dt)
    return (q, kv, kv), {"kv_groups": groups,
                         "causal": bool(site.get("causal", True))}


# no tile knob: the kernel's tiles are fixed by the type (BLOCK_Q,
# BLOCK_KV), so the tuner searches (depth, streams) only
_TILE_OPTIONS = ()

register_kernel(
    name="ff_attention",
    alias="attention",
    op=attention,
    ref=attention_ref,
    cost=attention_cost,
    workload=attention_workload,
    make_inputs=_make_inputs,
    bench_kwargs={"bh": 32, "s": 8192, "d": 128, "dtype": torch.bfloat16},
    tile_options=_TILE_OPTIONS,
    regular=True,
    tol=2e-4,
    doc="flash attention prefill, GQA, K/V on the shared-memory ring",
    shard_dims=(0, 0, 0),        # head-batch dim data-parallel (q and kv
    shard_out_dim=0,             # shard together, preserving kv_groups)
    sweep_inputs=_sweep_inputs,
)
