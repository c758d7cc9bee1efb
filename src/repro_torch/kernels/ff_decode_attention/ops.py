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
sized by the pipe policy; ``depth=1`` is the synchronous copy-then-compute
baseline), one producer warp issuing ``cp.async`` ahead of four consumer
warps that each own a quarter of a word's rows. A row's live words are
split over up to :func:`_plan`'s ``split`` blocks, from the shapes both
layouts share, so paged == contiguous bit for bit at ``block_kv ==
page``; the last split of a row sums the splits' partials in split order,
in the same launch. ``depth`` and ``streams`` never change a bit.

The wrapper of the contiguous kernel is :func:`decode_attention` here;
the paged kernel's wrapper is
:func:`repro_torch.runtime.paged_kv.paged_decode_attention`, beside the
pool it reads. Both resolve ``depth`` and ``streams`` through the pipe
policy (the contiguous one as the kernel ``ff_decode_attention``, the
paged one as the graph ``paged_decode_attention``), check them as the
reference's ``Pipe`` checks them, and on the CPU run the plain version,
which ignores them. Their words are the port's (:func:`_word_rows`), not
the reference's ``block_kv`` tiles: :func:`decode_attention_workload`
says how they differ.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.pipe import itemsize
from repro_torch.core.pipeline_model import Workload
from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels import _build
from repro_torch.kernels.ff_matmul.ops import _sm_count
from repro_torch.kernels.registry import KernelCost, register_kernel

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
_SM_SMEM = 233472               # 228 KB of shared memory an SM
_BLOCK_SMEM = 1024              # what the runtime keeps of it a block
_SM_THREADS = 2048
_THREADS = 32 * (_WARPS + 1)    # four consumer warps and the producer


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


def resident_blocks(depth: int, d: int, dtype: torch.dtype,
                    group: int = 1) -> int:
    """Blocks of the kernel one SM holds at once with a ring of ``depth``
    stages, as its shared memory and threads allow. Registers are not
    counted: on the card they hold the contiguous kernel to 5 blocks an
    SM at depths 1 and 2 and the paged one to 6 at depth 1 (bf16, head
    dim 64), which moves no :func:`wave_depth` at the serve,
    ``decode_256`` and ``decode_long`` shapes (``chip_smoke.py``
    ``decode_waves`` checks it against the card's occupancy)."""
    return min(_SM_SMEM // (smem_bytes(depth, d, dtype, group) + _BLOCK_SMEM),
               _SM_THREADS // _THREADS)


@functools.lru_cache(maxsize=None)
def wave_depth(b: int, kvh: int, d: int, dtype: torch.dtype, s: int,
               sm_count: int, group: int = 1) -> int:
    """The deepest ring at which the launch's grid (B x KVH rows, each cut
    into :func:`_plan`'s split) runs in as few waves as at depth 1. The
    pipe model sees one ring for the whole card; this kernel runs a ring a
    block and aims at 4 blocks an SM, so a deeper ring that leaves room
    for fewer blocks than the grid needs adds a wave (``decode_long``:
    576 blocks on 132 SMs need 5 an SM; depth 2 holds 6, depth 3 only 4).
    A grid within one block an SM is not capped."""
    blocks = b * kvh * _plan(b, kvh, d, dtype, s, sm_count).split

    def waves(depth):
        return -(-blocks // (sm_count * max(
            resident_blocks(depth, d, dtype, group), 1)))
    depth = max_depth(d, dtype, group)
    while depth > 1 and waves(depth) > waves(1):
        depth -= 1
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


def stream_options(options, rows: int, d: int, dtype) -> tuple:
    """The stream counts of ``options`` the ring can run: those dividing
    the reference's K/V tile (``rows``: ``block_kv``, or ``2 * page`` for
    the paged pool) and the port's word (:func:`_word_rows`)."""
    word = _word_rows(d, dtype)
    return tuple(s for s in options if rows % s == 0 and word % s == 0)


def decode_attention_workload(b: int, h: int, kvh: int, s: int, d: int, *,
                              dtype=torch.bfloat16
                              ) -> Tuple[Workload, Tuple[int, int]]:
    """The kernel's stream program in pipe words: one word per (b, kv head,
    R cache rows), a K and a V tile of R = :func:`_word_rows` rows (64 at
    head dim 64 in bf16, 32 at 80 or 128, 16 at 256; f32 half as many),
    whatever ``block_kv`` or the page is. The reference's word is a
    ``block_kv`` tile; the two are one workload where ``block_kv == R``.
    The whole cache streams once: the paper's regular, DLCD-free case.
    Planning tile = the K tile of a word."""
    rows = _word_rows(d, dtype)
    group = max(h // kvh, 1)
    w = Workload(
        n_words=max(b * kvh * -(-s // rows), 1),
        word_bytes=float(2 * rows * d * itemsize(dtype)),
        flops_per_word=4.0 * group * rows * d,
        regular=True,
    )
    return w, (rows, d)


def decode_attention_cost(b: int, h: int, kvh: int, s: int, d: int, *,
                          depth: int = 2, dtype=torch.bfloat16
                          ) -> KernelCost:
    item = itemsize(dtype)
    return KernelCost(
        flops=4.0 * b * h * s * d,
        hbm_bytes=float(b * kvh * 2 * s * d * item + 2 * b * h * d * item),
        smem_bytes=smem_bytes(depth, d, dtype, max(h // kvh, 1)))


def resolve_pipe(op: str, policy, q, kvh: int, s: int, d: int, rows: int,
                 run, *, nodes=None, site=None, extra_key: str = ""
                 ) -> Tuple[int, int]:
    """(depth, streams) of one decode launch under ``policy``: the kernel
    (``nodes=None``) or a graph of ``nodes`` (``(name, Workload, tile)``,
    the paged decode), its stream options those :func:`stream_options`
    keeps at ``rows``, its depth capped at :func:`wave_depth` (at most
    :func:`max_depth`) for the card the launch runs on, or on the CPU for
    ``policy.hw``'s SM count."""
    b, h = q.shape[0], q.shape[1]
    group = h // kvh
    so = stream_options(policy.stream_options, rows, d, q.dtype)
    pol = policy if so == tuple(policy.stream_options) \
        else policy.replace(stream_options=so)
    runner = None if autotune.in_capture() else \
        (lambda tk, dep, st: lambda: run(dep, st))
    sms = _sms(q.device.index) if q.device.type == "cuda" else policy.hw.sms
    cap = wave_depth(b, kvh, d, q.dtype, s, sms, group)
    if nodes is None:
        w, tile = decode_attention_workload(b, h, kvh, s, d, dtype=q.dtype)
        choice = autotune.resolve_call(
            op, pol, workload=w, tile=tile, dtype=q.dtype,
            workload_fn=lambda tk: (w, tile), runner=runner,
            extra_key=extra_key, site=site, site_dynamic=("b", "s"),
            depth_cap=cap)
    else:
        w, tile = autotune.graph_workload(nodes)
        choice = autotune.resolve_graph(
            op, pol, workload=w, tile=tile, dtype=q.dtype,
            signature=autotune.graph_signature(nodes),
            workload_fn=lambda tk: (w, tile), runner=runner, site=site,
            site_dynamic=("b", "n_pages", "n_blocks"), depth_cap=cap)
    _pipe(choice.depth, choice.streams, rows, d, q.dtype, group)
    return choice.depth, choice.streams


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


def _apply(q, k, v, lengths, *, block_kv: int,
           policy: PipePolicy) -> torch.Tensor:
    """Decode attention for one new token against a contiguous cache.

    q: [B, H, D]; k, v: [B, KVH, S, D] with the last dim contiguous (a
    transposed view of a [B, S, KVH, D] cache is taken as it is);
    lengths: [B] (0 = inactive row); ``S % block_kv == 0``. The ring the
    kernel reads K/V through is sized by ``policy``; it never changes the
    result. Returns [B, H, D]. mode="ref" and CPU tensors run
    :func:`decode_attention_ref`; CUDA tensors launch the kernel."""
    b, kvh, s, d = k.shape
    if v.shape != k.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    check_decode_inputs(q, k, lengths, kvh=kvh, d=d)
    if s % block_kv or not 0 < block_kv <= _MAX_BLOCK_KV:
        raise ValueError(f"block_kv={block_kv} must be in "
                         f"(0, {_MAX_BLOCK_KV}] and divide S={s}")
    if policy.mode == "ref":
        return decode_attention_ref(q, k, v, lengths, block_kv=block_kv)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode attention runs on cpu or cuda, "
                         f"not {q.device}")
    if q.device.type == "cuda" and (k.stride(3) != 1 or v.stride(3) != 1
                                    or v.dtype != k.dtype):
        raise ValueError("k and v need a contiguous last dim and one type")

    def run(depth, streams):
        if q.device.type == "cpu":
            return decode_attention_ref(q, k, v, lengths, block_kv=block_kv)
        return launch_contiguous(q, k, v, lengths, depth=depth,
                                 streams=streams)

    depth, streams = resolve_pipe(
        "ff_decode_attention", policy, q, kvh, s, d, block_kv, run,
        site={"b": b, "h": q.shape[1], "kvh": kvh, "s": s, "d": d,
              "block_kv": block_kv},
        # the port's words do not depend on block_kv: it goes in the key
        extra_key=f"block_kv={block_kv}")
    out = run(depth, streams)
    if q.device.type == "cuda":
        decode_attention.launches += 1
    return out


decode_attention = make_entrypoint("ff_decode_attention", _apply,
                                   name="decode_attention")


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


def _make_inputs(gen, device):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k, v = rn(2, 4, 64), rn(2, 2, 128, 64), rn(2, 2, 128, 64)
    lens = torch.tensor([70, 128], dtype=torch.int32, device=device)
    return (q, k, v, lens), {"block_kv": 64}


def _sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep); h snaps to a
    # multiple of the recorded KV-head count
    kvh = int(site["kvh"])
    h = max(1, int(site["h"]) // kvh) * kvh
    b, s, d = int(site["b"]), int(site["s"]), int(site["d"])
    dt = getattr(torch, site.get("dtype", "float32"))

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)
    lens = torch.full((b,), s, dtype=torch.int32, device=device)
    return (rn(b, h, d), rn(b, kvh, s, d), rn(b, kvh, s, d), lens), \
        {"block_kv": int(site.get("block_kv", 64))}


register_kernel(
    name="ff_decode_attention",
    alias="decode_attention",
    op=decode_attention,
    ref=decode_attention_ref,
    cost=decode_attention_cost,
    workload=decode_attention_workload,
    make_inputs=_make_inputs,
    bench_kwargs={"b": 8, "h": 64, "kvh": 8, "s": 32768, "d": 128,
                  "dtype": torch.bfloat16},
    # no tile knob: the word (_word_rows) is fixed by the head dim and the
    # type, and block_kv is the caller's (serving pins it to the page)
    tile_options=(),
    regular=True,
    tol=2e-4,
    doc="decode attention against a contiguous cache, K/V on the ring",
    shard_dims=(0, 0, 0, 0),     # request batch data-parallel
    shard_out_dim=0,
    sweep_inputs=_sweep_inputs,
)
