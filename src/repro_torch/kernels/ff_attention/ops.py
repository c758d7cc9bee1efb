"""Prefill flash attention: wrapper, plain version, launch count.

Replaces the TPU kernel ``repro/kernels/ff_attention/kernel.py``
(``build_program`` / ``flash_attention_ff``, wrapper ``ops.py:_apply``).
The CUDA kernel is ``csrc/ff_attention.cu``; its note says what bounds it
on the H100 and what its design does about that.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

BLOCK_Q = 32      # q rows per CUDA block (csrc/ff_attention.cu kBlockQ)
BLOCK_KV = 32     # K/V rows per tile (csrc/ff_attention.cu kBlockKV)
_NEG_INF = -1e30
_MAX_D = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def attention_ref(q, k, v, *, kv_groups: int = 1, causal: bool = True,
                  block_kv: int = BLOCK_KV) -> torch.Tensor:
    """Plain version of the kernel: the same online softmax over K/V tiles
    of ``block_kv`` rows, in f32, with ``p`` rounded to V's type before the
    PV product. q: [BH, S, D]; k, v: [BKVH, Skv, D] -> [BH, S, D].

    All q rows are processed at once; tiles past a row's diagonal add
    exactly 0 (masked scores give ``exp == 0`` and ``alpha == 1``), so this
    equals the kernel's per-q-tile skipping."""
    bh, s, d = q.shape
    skv = k.shape[1]
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
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ff_attention", f"ff_attention_{_SUFFIX[dtype]}",
                       [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p])


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


def attention(q, k, v, *, kv_groups: int = 1,
              causal: bool = True) -> torch.Tensor:
    """Flash attention over [BH, S, D] q and [BKVH, Skv, D] k/v (q head
    ``bh`` reads KV head ``bh // kv_groups``). CPU tensors run
    :func:`attention_ref`; CUDA tensors launch the kernel."""
    _check(q, k, v, kv_groups)
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
                         _build.stream_ptr(q.device))
    _build.check("ff_attention", "ff_attention", rc)
    attention.launches += 1
    return out


attention.launches = 0
