"""Decode attention (one new token) over a contiguous cache or a paged
pool: the contiguous kernel's wrapper and plain version, and the
launchers of both CUDA kernels.

Replaces the TPU kernels ``repro/kernels/ff_decode_attention/kernel.py``
(``build_program`` / ``decode_attention_ff``, wrapper ``ops.py:_apply``)
and, for the paged launch, the ``paged_decode_attention`` StreamGraph
(``repro/runtime/paged_kv.py:build_paged_decode_graph``: ``ff_gather``
fused into ``build_paged_program``). Both CUDA kernels are one templated
body in ``csrc/ff_decode_attention.cu``.

What bounds them on the H100: every live K/V byte is read once for about
2 operations (at one query head a KV head), so the bytes over 3.35 TB/s
bound them, and what keeps them from it is latency. The body streams K/V
through a ``ring_pipe.cuh`` ring of ``depth`` shared-memory stages, each a
word of 16, 32 or 64 cache rows (:func:`_word_rows`: as many as fit 16
KB; ``streams`` sub-copies a stage: the reference's ``Pipe`` arguments,
default 2 and 1; ``depth=1`` is the synchronous copy-then-compute
baseline), one producer warp issuing ``cp.async`` ahead of four consumer
warps that each own a quarter of a word's rows. A row's live words are
split over up to :func:`_plan`'s ``split`` blocks, from the shapes both
layouts share, so paged == contiguous bit for bit at ``block_kv ==
page``; the last split of a row sums the splits' partials in split order,
in the same launch. ``depth`` and ``streams`` never change a bit.

The wrapper of the contiguous kernel is :func:`decode_attention` here;
the paged kernel's wrapper is
:func:`repro_torch.runtime.paged_kv.paged_decode_attention`, beside the
pool it reads. Both take ``depth`` and ``streams``, check them as the
reference's ``Pipe`` checks them, and on the CPU run the plain version,
which ignores them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ff_matmul.ops import _sm_count

_NEG_INF = -1e30
_MAX_D = 256
_MAX_BLOCK_KV = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ITEM = {torch.float32: 4, torch.bfloat16: 2}
# the ring (csrc/ff_decode_attention.cu): words of 16, 32 or 64 cache rows
# (a stage of K and V within 16 KB), four consumer warps; a row splits
# only into parts of at least 128 rows, and the plan aims at 4 blocks an SM
_WORD_ROWS = (64, 32, 16)
_STAGE_BYTES = 16384
_WARPS = 4
_MIN_SPLIT_ROWS = 128
_BLOCKS_PER_SM = 4
_MAX_SMEM = 232448              # 227 KB of shared memory a block
DEFAULT_DEPTH = 2               # the reference's (kernel.py:34, :128)
DEFAULT_STREAMS = 1


class Plan(NamedTuple):
    rows: int                   # cache rows a ring word
    words: int                  # words of the cache
    split: int                  # blocks a (b, kv head) row at most


def _pitch(d: int, dtype: torch.dtype) -> int:
    """Bytes of a cache row in a stage: D elements padded to 16 bytes."""
    return -(-d * _ITEM[dtype] // 16) * 16


def _word_rows(d: int, dtype: torch.dtype) -> int:
    """Cache rows a ring word holds: the most of 64, 32, 16 whose K and V
    rows fit 16 KB (64 at head dim 64 in bf16, 32 at 80 or 128, 16 at
    256; f32 half as many)."""
    for rows in _WORD_ROWS:
        if 2 * rows * _pitch(d, dtype) <= _STAGE_BYTES:
            return rows
    return _WORD_ROWS[-1]


@functools.lru_cache(maxsize=None)
def _plan(b: int, kvh: int, d: int, dtype: torch.dtype, s: int,
          sm_count: int) -> Plan:
    """The launch's word and split, from B x KVH, the head dim, the type,
    the cache rows ``s`` and the SM count alone: what the contiguous cache
    and the paged pool share at ``block_kv == page`` and ``S == n_pages *
    page``, so both split alike. Enough splits that the grid holds about 4
    blocks an SM, each split at least 128 rows in whole words (a cache of
    fewer than twice that is not split); the live words are then cut on
    the card (:func:`_split_words`)."""
    rows = _word_rows(d, dtype)
    words = -(-s // rows)
    split = -(-_BLOCKS_PER_SM * sm_count // max(1, b * kvh))
    return Plan(rows, words, max(1, min(split, words // _min_words(rows))))


def _min_words(rows: int) -> int:
    return -(-_MIN_SPLIT_ROWS // rows)


def _split_words(words: int, split: int, rows: int) -> List[Tuple[int, int]]:
    """The live words ``[lo, hi)`` of each split a row uses, in split
    order, as the kernel cuts them: ``min(split, max(1, words //
    min_words))`` splits (none at 0 words), split j from ``j * words //
    used``."""
    used = (min(split, max(1, words // _min_words(rows))) if words
            else 0)
    return [(j * words // used, (j + 1) * words // used)
            for j in range(used)]


def ring_smem_bytes(depth: int, d: int, dtype: torch.dtype) -> int:
    """The ring's stages: ``depth`` words of K and V rows in the cache's
    type, each row padded to 16 bytes. It does not depend on ``block_kv``
    or the page."""
    return depth * 2 * _word_rows(d, dtype) * _pitch(d, dtype)


def smem_bytes(depth: int, d: int, dtype: torch.dtype,
               group: int = 1) -> int:
    """A block's shared memory (csrc/ff_decode_attention.cu ``Layout``):
    the ring, q and each consumer warp's acc, m and l in f32, two
    mbarriers a stage and a flag."""
    dp = _pitch(d, dtype) // _ITEM[dtype]
    rest = 4 * group * dp * (1 + _WARPS) + 8 * _WARPS * group
    return ring_smem_bytes(depth, d, dtype) + -(-rest // 8) * 8 \
        + 16 * depth + 16


def max_depth(d: int, dtype: torch.dtype, group: int = 1) -> int:
    """The deepest ring that fits one block's shared memory."""
    depth = 0
    while smem_bytes(depth + 1, d, dtype, group) <= _MAX_SMEM:
        depth += 1
    return depth


@functools.lru_cache(maxsize=None)
def _pipe(depth: int, streams: int, rows: int, d: int, dtype: torch.dtype,
          group: int) -> None:
    """``depth`` and ``streams`` checked as the reference's ``Pipe``
    checks them on its K/V stream, whose tile has ``rows`` leading rows
    (``block_kv``, or ``2 * page`` for the paged pool's merged K+V word):
    each at least 1, ``streams`` dividing ``rows``; the ``depth`` stages
    must also fit in shared memory with the block's q and state."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    if rows % streams:
        raise ValueError(f"tile leading dim {rows} not divisible by "
                         f"streams={streams}")
    if smem_bytes(depth, d, dtype, group) > _MAX_SMEM:
        raise ValueError(
            f"depth {depth} at head dim {d}, {group} query heads a KV head "
            f"needs {smem_bytes(depth, d, dtype, group)} bytes of shared "
            f"memory; at most {max_depth(d, dtype, group)} stages fit in "
            f"{_MAX_SMEM}")


def decode_attention_ref(q, k, v, lengths, *, block_kv: int) -> torch.Tensor:
    """Plain version of the kernel: the reference's tile loop over
    ``block_kv`` rows, the same skip rule (tiles with ``kv_start >=
    length`` leave the state untouched), f32 online softmax, ``p`` rounded
    to V's type. The kernel sums the same terms in another order.
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
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    ring = [i, i, i, i, p, p, p]      # depth, streams, split, rows, ws,
    if paged:                         # tickets, stream
        args = [p, p, p, p, p, i, i, i, i, i, i, i, f] + ring
        name = "ff_paged_decode_attention"
    else:
        args = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                f] + ring
        name = "ff_decode_attention"
    return _build.bind("ff_decode_attention", f"{name}_{_SUFFIX[dtype]}",
                       args)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SM count of card ``index``, asked once (the query costs more
    host time than the launch)."""
    return _sm_count(index)


def scratch_size(b: int, kvh: int, group: int, d: int, dtype: torch.dtype,
                 s: int, sm_count: int) -> Tuple[int, int]:
    """(tickets, f32 workspace words) a launch needs: one ticket a (b, kv
    head) row, and the splits' partials (acc, m and l of each query head)
    when :func:`_plan` splits. A pure function of the shapes: the plan
    uses the cache rows ``s``, not the lengths, and a call never uses
    more splits than the plan (:func:`_split_words`), so the size covers
    every call at these shapes."""
    split = _plan(b, kvh, d, dtype, s, sm_count).split
    return b * kvh, (b * kvh * split * group * (d + 2) if split > 1 else 0)


_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_RETIRED: List[torch.Tensor] = []


def _scratch(device: torch.device, stream: int, rows: int, ws_words: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tickets (``rows`` of them) and the splits' f32 partials
    (``ws_words``, :func:`scratch_size`), kept per device and stream:
    every launch leaves its tickets at 0 again (the last split of a row
    resets its own), and a later launch on the stream runs only after
    this one has read its partials. A buffer that is too small is
    replaced by a larger one, and the old one is kept alive: a captured
    CUDA graph holds its address. Replacing one while the stream is
    capturing raises: a compiled step sizes the buffers by warming up on
    its capture stream first."""
    key = (device, stream)
    tickets, ws = _SCRATCH.get(key, (None, None))
    grow_t = tickets is None or tickets.numel() < rows
    grow_w = ws is None or ws.numel() < ws_words
    if (grow_t or grow_w) and _build.capturing(device):
        raise RuntimeError(
            "ff_decode_attention: scratch would be allocated during CUDA "
            "graph capture; run the step once on the capture stream first")
    if grow_t:
        if tickets is not None:
            _RETIRED.append(tickets)
        tickets = torch.zeros(max(rows, 1024), dtype=torch.int32,
                              device=device)
    if grow_w:
        if ws is not None:
            _RETIRED.append(ws)
        ws = torch.empty(max(ws_words, 1 << 16), dtype=torch.float32,
                         device=device)
    _SCRATCH[key] = (tickets, ws)
    return tickets, ws


def _launch(paged: bool, q, out, lens, kvh: int, d: int, s: int, depth: int,
            streams: int, *operands) -> None:
    """Plan the split, then call the C entry with ``operands`` (the
    layout's two pointers, then its sizes) between the shared
    arguments."""
    b, h = q.shape[0], q.shape[1]
    group = h // kvh
    sms = _sms(q.device.index)
    plan = _plan(b, kvh, d, q.dtype, s, sms)
    stream = _build.stream_ptr(q.device)
    tickets, ws = _scratch(q.device, stream,
                           *scratch_size(b, kvh, group, d, q.dtype, s, sms))
    name = "ff_paged_decode_attention" if paged else "ff_decode_attention"
    ptrs, sizes = operands[:2], operands[2:]
    rc = _entry(paged, q.dtype)(
        q.data_ptr(), *ptrs, lens.data_ptr(), out.data_ptr(), b, kvh, group,
        d, *sizes, 1.0 / math.sqrt(d), depth, streams, plan.split,
        plan.rows, ws.data_ptr(), tickets.data_ptr(), stream)
    _build.check("ff_decode_attention", name, rc)


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


def decode_attention(q, k, v, lengths, *, block_kv: int,
                     depth: int = DEFAULT_DEPTH,
                     streams: int = DEFAULT_STREAMS) -> torch.Tensor:
    """Decode attention for one new token against a contiguous cache.

    q: [B, H, D]; k, v: [B, KVH, S, D] with the last dim contiguous (a
    transposed view of a [B, S, KVH, D] cache is taken as it is);
    lengths: [B] (0 = inactive row); ``S % block_kv == 0``. ``depth`` and
    ``streams`` size the ring the kernel reads K/V through; they never
    change the result. Returns [B, H, D]. CPU tensors run
    :func:`decode_attention_ref`; CUDA tensors launch the kernel."""
    b, kvh, s, d = k.shape
    if v.shape != k.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    check_decode_inputs(q, k, lengths, kvh=kvh, d=d)
    if s % block_kv or not 0 < block_kv <= _MAX_BLOCK_KV:
        raise ValueError(f"block_kv={block_kv} must be in "
                         f"(0, {_MAX_BLOCK_KV}] and divide S={s}")
    _pipe(depth, streams, block_kv, d, q.dtype, q.shape[1] // kvh)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    if k.stride(3) != 1 or v.stride(3) != 1 or v.dtype != k.dtype:
        raise ValueError("k and v need a contiguous last dim and one type")
    out = launch_contiguous(q, k, v, lengths, depth=depth, streams=streams)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def launch_contiguous(q, k, v, lengths, *, depth: int,
                      streams: int) -> torch.Tensor:
    """Launch the contiguous kernel on tensors already checked by
    :func:`decode_attention`."""
    b, kvh, s, d = k.shape
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch(False, q, out, lens, kvh, d, s, depth, streams, k.data_ptr(),
            v.data_ptr(), s, *k.stride()[:3], *v.stride()[:3])
    return out


def launch_paged(q, kv_pool, block_tables, lengths, *, depth: int,
                 streams: int) -> torch.Tensor:
    """Launch the paged kernel on CUDA tensors already checked by the
    caller (:func:`repro_torch.runtime.paged_kv.paged_decode_attention`)."""
    nb, _, page, kvh, d = kv_pool.shape
    n_pages = block_tables.shape[1]
    if not kv_pool.is_contiguous():
        raise ValueError("the KV pool must be contiguous")
    if page > _MAX_BLOCK_KV:
        raise ValueError(f"page {page} > {_MAX_BLOCK_KV}")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _launch(True, q, out, lens, kvh, d, page * n_pages, depth, streams,
            kv_pool.data_ptr(), bt.data_ptr(), page, n_pages, nb)
    return out
