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
tiles to the tensor cores (bf16), and the boxes each tile copy is split
into (``depth=1`` is the synchronous copy-then-compute baseline). They
are checked for both types and change when a tile lands, never what is
computed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ff_matmul.ops import matmul_ref

# q rows per CUDA block and K/V rows per tile, by type (csrc/
# ff_attention.cuh: bf16 the wgmma body wg, f32 the CUDA-core body f32)
BLOCK_Q = {torch.bfloat16: 64, torch.float32: 32}
BLOCK_KV = {torch.bfloat16: 64, torch.float32: 32}
_NEG_INF = -1e30
_MAX_D = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the bf16 ring (csrc/ff_attention.cuh wg::smem_bytes): a stage holds a K
# and a V tile of 64 rows by d padded to 64-column slabs of 8 KB each
_SLAB_BYTES = 64 * 64 * 2
_MAX_SMEM = 232448                  # 227 KB of shared memory a block
_MIN_STREAM_ROWS = 8                # one 128-byte swizzle atom of rows
DEFAULT_DEPTH = 2
DEFAULT_STREAMS = 1


def _smem_bytes(d: int, depth: int) -> int:
    """Shared memory of the bf16 block at head dim ``d`` and ring
    ``depth``: 1024 bytes of alignment slack, the q tile, the stages, and
    two mbarriers a stage plus the q tile's."""
    slabs = -(-d // 64)
    return 1024 + slabs * _SLAB_BYTES * (1 + 2 * depth) + 8 * (2 * depth + 1)


def max_depth(d: int) -> int:
    """The deepest ring that fits one block's shared memory at head dim
    ``d``."""
    depth = 1
    while _smem_bytes(d, depth + 1) <= _MAX_SMEM:
        depth += 1
    return depth


def _pipe(depth, streams, d):
    """``depth`` and ``streams`` (None: the defaults), checked as the
    reference's ``Pipe`` checks them against this kernel's tiles: each at
    least 1, ``streams`` dividing the 64-row tiles into boxes of at least
    8 rows (one swizzle atom), ``depth`` stages fitting in shared memory
    at head dim ``d``."""
    depth = DEFAULT_DEPTH if depth is None else depth
    streams = DEFAULT_STREAMS if streams is None else streams
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    rows = BLOCK_KV[torch.bfloat16]
    if rows % streams or rows // streams < _MIN_STREAM_ROWS:
        raise ValueError(f"streams={streams} must split the tile's {rows} "
                         f"rows into boxes of at least {_MIN_STREAM_ROWS} "
                         f"rows")
    if d <= _MAX_D and depth > max_depth(d):
        raise ValueError(f"depth {depth} needs {_smem_bytes(d, depth)} "
                         f"bytes of shared memory at head dim {d}; at most "
                         f"{max_depth(d)} stages fit in {_MAX_SMEM}")
    return depth, streams


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
    """ff_attention_bf16 takes the ring's depth and streams after the
    scale; ff_attention_f32 does not."""
    p, i = ctypes.c_void_p, ctypes.c_int
    pipe = [i, i] if dtype == torch.bfloat16 else []
    return _build.bind("ff_attention", f"ff_attention_{_SUFFIX[dtype]}",
                       [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, *pipe,
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


def _pipe_args(dtype, depth, streams):
    return (depth, streams) if dtype == torch.bfloat16 else ()


def attention(q, k, v, *, kv_groups: int = 1, causal: bool = True,
              depth=None, streams=None) -> torch.Tensor:
    """Flash attention over [BH, S, D] q and [BKVH, Skv, D] k/v (q head
    ``bh`` reads KV head ``bh // kv_groups``). ``depth`` and ``streams``
    (default :data:`DEFAULT_DEPTH`, :data:`DEFAULT_STREAMS`) size the ring
    that feeds the tensor cores (bf16); they are checked for both types and
    do not change the result. CPU tensors run :func:`attention_ref`; CUDA
    tensors launch the kernel."""
    _check(q, k, v, kv_groups)
    depth, streams = _pipe(depth, streams, q.shape[2])
    if q.device.type == "cpu":
        return attention_ref(q, k, v, kv_groups=kv_groups, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    bh, s, d = q.shape
    if d > _MAX_D:
        raise ValueError(f"head dim {d} > {_MAX_D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), bh, s, k.shape[1], d, kv_groups,
                         int(causal), 1.0 / math.sqrt(d),
                         *_pipe_args(q.dtype, depth, streams),
                         _build.stream_ptr(q.device))
    _build.check("ff_attention", "ff_attention", rc)
    attention.launches += 1
    return out


attention.launches = 0


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
    pipe = [i, i] if dtype == torch.bfloat16 else []
    return _build.bind("ff_attention_proj",
                       f"ff_attention_proj_{_SUFFIX[dtype]}",
                       [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                        *pipe, p])


def attention_proj(q, k, v, w, *, causal: bool = True, depth=None,
                   streams=None) -> torch.Tensor:
    """Attention over [BH, S, D] q and [BH, Skv, D] k/v (one KV head per q
    head, as the reference graph's), then the out-projection by w [D,
    D_out] (q's type), in one launch: the
    [BH, S, D] intermediate stays on chip. Returns [BH*S, D_out], equal
    bit for bit to ``matmul(attention(q, k, v).reshape(BH*S, D), w)`` at
    any ``depth`` and ``streams`` of either (as :func:`attention`'s: the
    projection's words of w ride the same ring). CPU tensors run
    :func:`attention_proj_ref`; CUDA tensors launch the kernel."""
    _check(q, k, v, 1)
    depth, streams = _pipe(depth, streams, q.shape[2])
    if w.dim() != 2 or w.shape[0] != q.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} is not [{q.shape[2]}, D_out]")
    if w.dtype != q.dtype:
        raise TypeError(f"w must have q's type {q.dtype}, not {w.dtype}")
    if w.device != q.device:
        raise ValueError("w must be on q's device")
    if q.device.type == "cpu":
        return attention_proj_ref(q, k, v, w, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"attention_proj runs on cpu or cuda, not "
                         f"{q.device}")
    bh, s, d = q.shape
    if d > _MAX_D:
        raise ValueError(f"head dim {d} > {_MAX_D}")
    q, k, v, w = q.contiguous(), k.contiguous(), v.contiguous(), \
        w.contiguous()
    out = torch.empty((bh * s, w.shape[1]), dtype=q.dtype, device=q.device)
    rc = _proj_entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), out.data_ptr(), bh, s,
                              k.shape[1], d, w.shape[1], int(causal),
                              1.0 / math.sqrt(d),
                              *_pipe_args(q.dtype, depth, streams),
                              _build.stream_ptr(q.device))
    _build.check("ff_attention_proj", "ff_attention_proj", rc)
    attention_proj.launches += 1
    return out


attention_proj.launches = 0
