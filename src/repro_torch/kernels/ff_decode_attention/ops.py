"""Decode attention (one new token) over a contiguous cache or a paged
pool: the contiguous kernel's wrapper and plain version, and the
launchers of both CUDA kernels.

Replaces the TPU kernels ``repro/kernels/ff_decode_attention/kernel.py``
(``build_program`` / ``decode_attention_ff``, wrapper ``ops.py:_apply``)
and, for the paged launch, the ``paged_decode_attention`` StreamGraph
(``repro/runtime/paged_kv.py:build_paged_decode_graph``: ``ff_gather``
fused into ``build_paged_program``). Both CUDA kernels are one templated
body in ``csrc/ff_decode_attention.cu``; its note says what bounds them on
the H100 and why paged == contiguous holds bit for bit.

The wrapper of the contiguous kernel is :func:`decode_attention` here;
the paged kernel's wrapper is
:func:`repro_torch.runtime.paged_kv.paged_decode_attention`, beside the
pool it reads.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30
_MAX_D = 256
_MAX_BLOCK_KV = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def decode_attention_ref(q, k, v, lengths, *, block_kv: int) -> torch.Tensor:
    """Plain version of the kernel: the same tile loop over ``block_kv``
    rows, the same skip rule (tiles with ``kv_start >= length`` leave the
    state untouched), f32 online softmax, ``p`` rounded to V's type.
    q: [B, H, D]; k, v: [B, KVH, S, D] (any strides); lengths: [B].
    Returns [B, H, D]; rows with ``lengths == 0`` are exactly 0."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.reshape(b, kvh, group, d).float()
    m = torch.full((b, kvh, group, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, group, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, group, d), dtype=torch.float32, device=dev)
    lens = lengths.to(device=dev, dtype=torch.int64).view(b, 1, 1, 1)
    for kj in range(-(-s // block_kv)):
        kv0 = kj * block_kv
        # contiguous tile copies: the paged plain version hands this
        # function a gathered cache, and equal layouts keep the two bitwise
        kt = k[:, :, kv0:kv0 + block_kv].float().contiguous()
        vt = v[:, :, kv0:kv0 + block_kv].contiguous()
        sc = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        cols = kv0 + torch.arange(kt.shape[2], device=dev)
        sc = torch.where(cols < lens, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.matmul(p.to(vt.dtype).float(),
                                             vt.float())
        live = kv0 < lens
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype).reshape(b, h, d)


@functools.lru_cache(maxsize=None)
def _entry(paged: bool, dtype: torch.dtype):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if paged:
        args = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        name = "ff_paged_decode_attention"
    else:
        args = [p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                ctypes.c_float, p]
        name = "ff_decode_attention"
    return _build.bind("ff_decode_attention", f"{name}_{_SUFFIX[dtype]}",
                       args)


def check_decode_inputs(q, kv, lengths, *, kvh: int, d: int) -> None:
    if q.dim() != 3 or q.shape[2] != d or q.shape[1] % kvh:
        raise ValueError(f"q {tuple(q.shape)} is not [B, H, {d}] with H a "
                         f"multiple of {kvh} KV heads")
    if q.dtype != kv.dtype or q.dtype not in _SUFFIX:
        raise TypeError(f"decode attention takes float32 or bfloat16 q and "
                        f"cache of one type; got {q.dtype}, {kv.dtype}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths {tuple(lengths.shape)} != "
                         f"({q.shape[0]},)")
    if not (q.device == kv.device == lengths.device):
        raise ValueError("q, cache and lengths must be on one device")
    if d > _MAX_D:
        raise ValueError(f"head dim {d} > {_MAX_D}")


def decode_attention(q, k, v, lengths, *, block_kv: int) -> torch.Tensor:
    """Decode attention for one new token against a contiguous cache.

    q: [B, H, D]; k, v: [B, KVH, S, D] with the last dim contiguous (a
    transposed view of a [B, S, KVH, D] cache is taken as it is);
    lengths: [B] (0 = inactive row); ``S % block_kv == 0``. Returns
    [B, H, D]. CPU tensors run :func:`decode_attention_ref`; CUDA tensors
    launch the kernel."""
    b, kvh, s, d = k.shape
    if v.shape != k.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    check_decode_inputs(q, k, lengths, kvh=kvh, d=d)
    if s % block_kv or not 0 < block_kv <= _MAX_BLOCK_KV:
        raise ValueError(f"block_kv={block_kv} must be in "
                         f"(0, {_MAX_BLOCK_KV}] and divide S={s}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    if k.stride(3) != 1 or v.stride(3) != 1 or v.dtype != k.dtype:
        raise ValueError("k and v need a contiguous last dim and one type")
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _entry(False, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, kvh, q.shape[1] // kvh, d, block_kv,
        s // block_kv, *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    _build.check("ff_decode_attention", "ff_decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def launch_paged(q, kv_pool, block_tables, lengths) -> torch.Tensor:
    """Launch the paged kernel on CUDA tensors already checked by the
    caller (:func:`repro_torch.runtime.paged_kv.paged_decode_attention`)."""
    nb, _, page, kvh, d = kv_pool.shape
    b, n_pages = block_tables.shape
    if not kv_pool.is_contiguous():
        raise ValueError("the KV pool must be contiguous")
    if page > _MAX_BLOCK_KV:
        raise ValueError(f"page {page} > {_MAX_BLOCK_KV}")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _entry(True, q.dtype)(
        q.data_ptr(), kv_pool.data_ptr(), bt.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, kvh, q.shape[1] // kvh, d, page, n_pages, nb,
        1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    _build.check("ff_decode_attention", "ff_paged_decode_attention", rc)
    return out
