"""Gated linear-attention scan (Mamba2 / RWKV6): wrapper, plain versions,
launch count.

Replaces the TPU kernel ``repro/kernels/ff_chunk_scan/kernel.py``
(``build_program`` / ``_chunk_body`` / ``chunk_scan_ff``, wrapper
``ops.py:_apply``). Per ``bh`` row it runs the recurrence

    h_t = diag(exp(lw_t)) h_{t-1} + k_t (x) v_t
    inclusive (Mamba2):        y_t = q_t . h_t
    exclusive (RWKV6, bonus u): y_t = q_t . (h_{t-1} + diag(u) k_t (x) v_t)

with the ``[N, P]`` state carried in f32 across chunks of ``chunk`` rows
and the chunk's terms in the decay-to-boundary factorization, so that
every exponent is <= 0. The CUDA kernels are in ``csrc/ff_chunk_scan.cu``;
its note says what bounds them on the H100.

Which body a CUDA call runs is decided by the operands' types and shapes
alone (:func:`_body`). Both stream the rows 16 at a time through a
``depth``-stage shared-memory ring (``csrc/ring_pipe.cuh``), each stage
copied in ``streams`` parts, and keep the state on chip:

* ``"ring"``, the tensor-core body (``ring_scan_kernel``: bf16 products on
  ``mma.sync``) when q, k and v are bfloat16, N is 16, 32, 64 or 128, P a
  multiple of 16, ``chunk`` a multiple of 16 and the subtile 16; its grid
  is :func:`_plan`'s, its shared memory :func:`ring_smem_bytes`, its
  deepest ring :func:`max_depth`;
* ``"f32_ring"``, the CUDA-core body (``f32_ring_scan_kernel``: f32
  arithmetic throughout) for every other call: f32 or mixed streams, any
  N that shared memory holds, any P. It carries the state at every 4-row
  boundary, so the reference's ``chunk`` and ``subtile`` change only the
  reference's order of summation and this body gives the same bits for
  any of them (:func:`_subtile` still checks them as the reference does).
  Each word it also scales the state once so that its decay over the word
  is ``e^{sum lw}`` to a few 1e-9: the rounding of the per-row decays
  does not compound over a long row. Its grid is :func:`_f32_plan`'s, its
  shared memory :func:`f32_ring_smem_bytes`, its deepest ring
  :func:`f32_max_depth`.

``depth`` and ``streams`` are the reference's ``chunk_scan_ff`` keywords
(its ``Pipe``; ``depth=1`` is the synchronous copy-then-compute baseline),
resolved through the pipe policy as the kernel ``ff_chunk_scan`` with the
reference's workload (one word per chunk, :func:`chunk_scan_workload`),
capped at the deepest ring the body's shared memory holds
(:func:`_deepest`) and checked as its ``Pipe`` checks them for every call;
both bodies use them and neither's bits move with them. The CPU plain
version ignores them.

:func:`chunk_scan_ref` is the naive per-step scan (the oracle, reference
``ref.py:chunk_scan_ref``); :func:`chunk_scan_plain` is the kernel's
chunked factorization in PyTorch, which CPU tensors run. The reference's
XLA twin (``chunk_scan_xla``) is not ported: the port has no XLA path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import autotune
from repro_torch.core.pipe import itemsize
from repro_torch.core.pipeline_model import Workload
from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels import _build
from repro_torch.kernels.registry import KernelCost, register_kernel

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448          # shared memory one block may use (227 KB)
RING_N = (16, 32, 64, 128)   # N the ring body is built for
_WORD_ROWS = 16              # rows of a ring word: one subtile
_COLS = 16                   # columns of P per consumer warp
_MAX_COLS = 128              # columns of one ring block (eight warps)
_F32_COLS = 32               # columns of one f32 ring block (one a lane)


def chunk_scan_ref(q, k, v, log_w, u=None, *,
                   inclusive: bool = True) -> torch.Tensor:
    """The naive scan, one step at a time, in f32 (the reference's oracle;
    like it, the result is float32 whatever the operand types). q, k, log_w
    [BH, S, N]; v [BH, S, P]; u [BH, N] or None."""
    q, k, v = q.float(), k.float(), v.float()
    lw = torch.clamp(log_w.float(), max=0.0)
    bh, s, n = q.shape
    h = torch.zeros(bh, n, v.shape[2], dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        h_new = torch.exp(lw[:, t])[:, :, None] * h + kv
        if inclusive:
            eff = h_new
        else:
            eff = h + (u.float()[:, :, None] * kv if u is not None else 0.0)
        ys.append(torch.einsum("bn,bnp->bp", q[:, t], eff))
        h = h_new
    return torch.stack(ys, dim=1)


def _chunk_body(q, k, v, lw, u, h, *, subtile: int, inclusive: bool):
    """One chunk of the scan for every row at once, all f32, in the
    kernel's order of terms (reference ``kernel.py:_chunk_body``). q, k, lw
    [BH, L, N]; v [BH, L, P]; u [BH, N] or None; h [BH, N, P]. Returns
    (y [BH, L, P], h_new [BH, N, P])."""
    bh, L, n = q.shape
    t = subtile
    cw = torch.cumsum(lw, dim=1)                 # inclusive cumsum
    cq = cw if inclusive else cw - lw            # the q side's exponent
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril(
        0 if inclusive else -1)
    ys = []
    for i in range(L // t):
        t0 = i * t
        rows = slice(t0, t0 + t)
        cw_b = cw[:, t0 - 1] if t0 else torch.zeros_like(cw[:, 0])
        # the carried state: q decayed from the chunk's start
        inter = torch.matmul(q[:, rows] * torch.exp(cq[:, rows]), h)
        # earlier tiles through the boundary b = t0 - 1: both exponents <= 0
        q_i = q[:, rows] * torch.exp(cq[:, rows] - cw_b[:, None])
        k_b = k[:, :t0] * torch.exp(cw_b[:, None] - cw[:, :t0])
        s_pre = torch.matmul(q_i, k_b.transpose(1, 2))        # [BH, t, t0]
        # the diagonal tile: exact pairwise exponents, clamped at 0 where
        # masked
        e = torch.clamp(cq[:, rows, None, :] - cw[:, None, rows, :], max=0.0)
        s_diag = (q[:, rows, None, :] * torch.exp(e)
                  * k[:, None, rows, :]).sum(-1)              # [BH, t, t]
        s_diag = torch.where(keep, s_diag, 0.0)
        scores = torch.cat([s_pre, s_diag], dim=2)
        ys.append(inter + torch.matmul(scores, v[:, :t0 + t]))
    y = torch.cat(ys, dim=1)
    if u is not None:
        # the bonus: the current token, undecayed
        y = y + (q * u[:, None, :] * k).sum(-1, keepdim=True) * v
    k2 = k * torch.exp(cw[:, -1:] - cw)
    h_new = torch.exp(cw[:, -1])[:, :, None] * h + torch.matmul(
        k2.transpose(1, 2), v)
    return y, h_new


def chunk_scan_plain(q, k, v, log_w, u=None, *, chunk: int = 64,
                     subtile: int = 16,
                     inclusive: bool = True) -> torch.Tensor:
    """Plain version of the kernel: S padded up to a multiple of ``chunk``
    (``log_w = 0``, ``q = k = v = 0``, reference ``ops.py:277-278``),
    ``log_w`` clamped at 0, the chunks in order with the state carried in
    f32, each chunk by :func:`_chunk_body`, the output cut back to S in q's
    type."""
    st = _subtile(chunk, subtile)
    bh, s, n = q.shape
    pad = -s % chunk
    qf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (q, k, v))
    lw = F.pad(torch.clamp(log_w.float(), max=0.0), (0, 0, 0, pad))
    uf = u.float() if u is not None else None
    h = torch.zeros(bh, n, v.shape[2], dtype=torch.float32, device=q.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        c = slice(c0, c0 + chunk)
        y, h = _chunk_body(qf[:, c], kf[:, c], vf[:, c], lw[:, c], uf, h,
                           subtile=st, inclusive=inclusive)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s].to(q.dtype)


def _subtile(chunk: int, subtile: int) -> int:
    """The reference's rule (``ops.py:274-276``): the subtile is at most
    the chunk and must divide it."""
    if chunk < 1 or subtile < 1:
        raise ValueError(f"chunk={chunk} and subtile={subtile} must be >= 1")
    st = min(subtile, chunk)
    if chunk % st != 0:
        raise ValueError(f"chunk={chunk} not a multiple of subtile={st}")
    return st


def ring_smem_bytes(n: int, cols: int, w_bytes: int, depth: int) -> int:
    """Dynamic shared memory of one ring block of ``cols`` columns
    (``csrc/ff_chunk_scan.cu`` ``Layout``): ``depth`` stages of 16 rows (q
    and k [16, N+8] bf16, v [16, cols+8] bf16, log_w [16, N+4] f32 or [16,
    N+8] bf16 by ``w_bytes``); two derived buffers (q decayed two ways and
    k decayed, [16, N+8] bf16 each, the cumsum [17, N+4] f32, the diagonal
    scores [16, 24] bf16, the bonus [16] and two [N] decays in f32); u and
    the carried cumsum [3, N] f32; the carried state h [N, cols] f32; two
    mbarriers a stage. Nothing grows with the chunk."""
    ns, cs = n + 8, n + 4
    ws = (n + 4) * 4 if w_bytes == 4 else (n + 8) * 2
    stage = 2 * 16 * ns * 2 + 16 * (cols + 8) * 2 + 16 * ws
    buf = 3 * 16 * ns * 2 + 17 * cs * 4 + 16 * 24 * 2 + 16 * 4 + 2 * n * 4
    return depth * stage + 2 * buf + 3 * n * 4 + n * cols * 4 + 16 * depth


def _f32_nt(n: int) -> int:
    """State rows a consumer thread of the f32 ring body carries in
    registers for each of its 4 columns (``csrc/ff_chunk_scan.cu``
    ``f32_nt``): four warps of 4 x NT rows up to N = 128, eight up to 256,
    then 16 rows a thread."""
    return (1 if n <= 16 else 2 if n <= 32 else 4 if n <= 64
            else 8 if n <= 256 else 16)


def f32_ring_smem_bytes(n: int, cols: int, depth: int,
                        sizes: Tuple[int, int, int, int] = (4, 4, 4, 4)
                        ) -> int:
    """Dynamic shared memory of one f32 ring block of ``cols`` columns
    (``csrc/ff_chunk_scan.cu`` ``F32Layout``), ``sizes`` the element bytes
    of q, k, log_w and v: ``depth`` stages of 16 rows (q, k and log_w [16,
    NS], v [16, CS], each in its own type; NS and CS are N and ``cols``
    rounded up to 8); in f32 qd and ke [16, NP], the block decays [4, NP],
    the word's decay correction [NP] and u [NP] (NP = 4 NT W, the consumer
    warps' state rows), the warps' pair scores [W, 48] and their sums
    [48], the warps' partial outputs [W, 16, 32]; two mbarriers a stage.
    Nothing grows with the chunk."""
    rows = 4 * _f32_nt(n)          # state rows a warp: four quarters
    warps = -(-n // rows)
    np_ = warps * rows
    ns, cs = -(-n // 8) * 8, -(-cols // 8) * 8
    eq, ek, ew, ev = sizes
    stage = 16 * (ns * (eq + ek + ew) + cs * ev)
    derived = 4 * ((2 * 16 + 4 + 2) * np_ + 48 * warps + 48
                   + 16 * _F32_COLS * warps)
    return depth * stage + derived + 16 * depth


@functools.lru_cache(maxsize=None)
def max_depth(n: int, p: int, w_dtype: torch.dtype = torch.float32) -> int:
    """The deepest ring of the tensor-core body that fits one block's
    shared memory at state width ``n`` and ``p`` columns (a block takes at
    most 128), log_w of type ``w_dtype``."""
    cols, w_bytes = min(p, _MAX_COLS), torch.finfo(w_dtype).bits // 8
    depth = 1
    while ring_smem_bytes(n, cols, w_bytes, depth + 1) <= SMEM_LIMIT:
        depth += 1
    return depth


@functools.lru_cache(maxsize=None)
def f32_max_depth(n: int, p: int, dtypes=None) -> int:
    """The deepest ring of the f32 ring body that fits one block's shared
    memory at state width ``n``, :func:`_f32_plan`'s columns of ``p``, q,
    k, log_w and v of ``dtypes`` (each float32 unless given); 0 when not
    even one stage fits."""
    sizes = tuple(itemsize(d) for d in (dtypes or (torch.float32,) * 4))
    cols = _f32_plan(1, p).cols
    depth = 0
    while f32_ring_smem_bytes(n, cols, depth + 1, sizes) <= SMEM_LIMIT:
        depth += 1
    return depth


def _pipe(depth: int, streams: int, chunk: int) -> None:
    """``depth`` and ``streams`` checked as the reference's ``Pipe``
    checks them for the scan's (chunk, N) tiles (``core/pipe.py``): each
    at least 1, ``streams`` dividing the chunk's rows."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    if chunk % streams:
        raise ValueError(f"tile leading dim {chunk} not divisible by "
                         f"streams={streams}")


class Plan(NamedTuple):
    """A body's grid: ``slices`` blocks of ``cols`` columns for each of the
    ``bh`` rows, ``blocks`` in all, each walking all of its row's rows in
    order (:func:`_plan` for the tensor-core body, :func:`_f32_plan` for
    the f32 ring body)."""
    slices: int
    cols: int
    blocks: int


def _plan(bh: int, s: int, n: int, p: int, chunk: int,
          sm_count: int) -> Plan:
    """The ring body's split of P, from the shapes and the SM count alone:
    one block per row with every column (the shared work of a row, its
    cumsum and exponents, is then done once), at most 128 columns a block;
    P is halved while the doubled blocks still fit on the SMs, down to 16
    columns a block (each slice repeats the row's cumsum and exponents, so
    a split pays only where SMs would otherwise idle). A row's chunks stay
    in one block, in order: at the models' prefill shapes (256 and 320
    rows) the rows alone cover the card, and the state never leaves the
    chip. ``s``, ``n`` and ``chunk`` do not change it: a block walks all
    of its row's chunks, and its shared memory does not grow with them."""
    units = p // _COLS
    slices = -(-p // _MAX_COLS)
    while units % slices:
        slices += 1
    while bh * slices * 2 <= sm_count and units % (2 * slices) == 0:
        slices *= 2
    return Plan(slices=slices, cols=p // slices, blocks=bh * slices)


def _f32_plan(bh: int, p: int) -> Plan:
    """The f32 ring body's split of P: ``ceil(P / 32)`` slices of ``cols``
    columns (a multiple of 8, so that each slice of v starts 16-byte
    aligned; the last slice may be narrower), one block per (row, slice),
    each walking all of its row's words in order. A block's columns are
    its consumer lanes, so a narrower slice would leave lanes idle without
    shortening the block: the plan never splits P below 32 columns, and at
    the timing shape (16 rows, P = 256) its 8 slices give 128 blocks for
    the H100's 132 SMs; the models' prefill rows (256 and 320, P = 64)
    alone cover the card. N, S and the chunk do not change it."""
    slices = -(-p // _F32_COLS)
    per = -(-p // slices)
    cols = min(-(-per // 8) * 8, _F32_COLS)
    slices = -(-p // cols)
    return Plan(slices=slices, cols=cols, blocks=bh * slices)


def _body(q, k, v, chunk: int, st: int) -> str:
    """``"ring"`` (the tensor-core body) when q, k and v are bfloat16, N is
    16, 32, 64 or 128, P a multiple of 16, the chunk a multiple of 16 and
    the subtile 16; ``"f32_ring"`` (the CUDA-core body, f32 arithmetic)
    otherwise."""
    bf = torch.bfloat16
    if (q.dtype == bf and k.dtype == bf and v.dtype == bf
            and q.shape[2] in RING_N and v.shape[2] % _COLS == 0
            and chunk % _WORD_ROWS == 0 and st == _WORD_ROWS):
        return "ring"
    return "f32_ring"


def _deepest(q, k, v, log_w, chunk: int, st: int) -> int:
    """The deepest ring of the body this call runs (0: not one stage of
    the f32 body fits)."""
    n, p = q.shape[2], v.shape[2]
    if _body(q, k, v, chunk, st) == "ring":
        return max_depth(n, p, log_w.dtype)
    return f32_max_depth(n, p, (q.dtype, k.dtype, log_w.dtype, v.dtype))


def _check(q, k, v, log_w, u, inclusive):
    if q.dim() != 3 or k.shape != q.shape or log_w.shape != q.shape:
        raise ValueError(f"chunk_scan wants q, k, log_w of one shape [BH, S, "
                         f"N]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(log_w.shape)}")
    if v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"v {tuple(v.shape)} is not [BH, S, P] for q "
                         f"{tuple(q.shape)}")
    if u is not None:
        if inclusive:
            raise ValueError("u is the exclusive mode's bonus; the inclusive "
                             "scan takes none")
        if u.shape != (q.shape[0], q.shape[2]):
            raise ValueError(f"u {tuple(u.shape)} is not [BH, N] = "
                             f"{(q.shape[0], q.shape[2])}")
    for x in (q, k, v, log_w) + ((u,) if u is not None else ()):
        if x.dtype not in _DTYPES:
            raise TypeError(f"chunk_scan takes float32 or bfloat16 operands, "
                            f"not {x.dtype}")
        if x.device != q.device:
            raise ValueError("every operand must be on q's device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_scan runs on cpu or cuda, not {q.device}")


@functools.lru_cache(maxsize=None)
def _entry(body: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if body == "ring":
        return _build.bind("ff_chunk_scan", "ff_chunk_scan_ring",
                           [p, p, p, p, p, p] + [i] * 10 + [p])
    return _build.bind("ff_chunk_scan", "ff_chunk_scan_f32_ring",
                       [p, p, p, p, p, p] + [i] * 9 + [p, p])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(x):
    """``x`` contiguous, copied if its data is not 16-byte aligned (the
    ring body reads 16 bytes a copy)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def chunk_scan_workload(bh: int, s: int, n: int, p: int, *, chunk: int = 64,
                        dtype=torch.bfloat16
                        ) -> Tuple[Workload, Tuple[int, int]]:
    """The reference's workload, word for word: one word per (bh, chunk),
    q/k/w [L, N] and v [L, P] tiles, the chunk-boundary state the DLCD the
    consumer carries. The port's ring body streams the chunk's rows 16 at
    a time, but its pipe check and its ``streams`` are on the chunk's
    rows, as the reference's."""
    item = itemsize(dtype)
    nc = max(-(-s // chunk), 1)
    per_chunk = 2.0 * chunk * n * p * 2 + chunk * chunk * (n + p)
    w = Workload(
        n_words=bh * nc,
        word_bytes=float(chunk * (3 * n + p) * item),
        flops_per_word=per_chunk,
        regular=True,
        dlcd_cycles=2.0 * n,
        store_bytes_per_word=float(chunk * p * item),
    )
    return w, (chunk, n)


def chunk_scan_cost(bh: int, s: int, n: int, p: int, *, chunk: int = 64,
                    depth: int = 2, dtype=torch.bfloat16) -> KernelCost:
    w, _ = chunk_scan_workload(bh, s, n, p, chunk=chunk, dtype=dtype)
    if (dtype == torch.bfloat16 and n in RING_N and p % _COLS == 0
            and chunk % _WORD_ROWS == 0):
        smem = ring_smem_bytes(n, min(p, _MAX_COLS), 4, depth)
    else:
        smem = f32_ring_smem_bytes(n, _f32_plan(bh, p).cols, depth,
                                   (itemsize(dtype),) * 4)
    return KernelCost(
        flops=w.n_words * w.flops_per_word,
        hbm_bytes=float(bh * s * (3 * n + 2 * p) * itemsize(dtype)),
        smem_bytes=smem)


# chunk lengths the measured autotuner may search in mode="autotune" (the
# kernel takes every one of them; a chunk changes the scan's summation, so
# a compiled step, which never measures, never searches them)
_TILE_OPTIONS = (
    {"chunk": 32},
    {"chunk": 128},
    {"chunk": 256},
)


def _apply(q, k, v, log_w, u=None, *, chunk: int = 64, subtile: int = 16,
           inclusive: bool = True, policy: PipePolicy) -> torch.Tensor:
    """The gated linear-attention scan: q, k, log_w [BH, S, N], v [BH, S,
    P], u [BH, N] (the exclusive mode's bonus) or None; each operand float32
    or bfloat16 on its own. Any S: the ragged last chunk is padded with
    ``log_w = 0`` and ``k = v = 0``. ``log_w`` is clamped at 0. The ring's
    stages and the parts each stage is copied in are sized by ``policy``
    (the reference's ``Pipe``; checked for every call, used by both CUDA
    bodies); mode="autotune" may also pick the chunk. Returns [BH, S,
    P] in q's type. mode="ref" runs :func:`chunk_scan_ref`; CPU tensors run
    :func:`chunk_scan_plain`; CUDA tensors launch the body :func:`_body`
    picks (one launch)."""
    _subtile(chunk, subtile)
    _check(q, k, v, log_w, u, inclusive)
    if policy.mode == "ref":
        return chunk_scan_ref(q, k, v, log_w, u, inclusive=inclusive)
    bh, s, n = q.shape
    p = v.shape[2]

    def run(ck, depth, streams):
        _pipe(depth, streams, ck)
        st = _subtile(ck, subtile)
        if q.device.type == "cpu":
            return chunk_scan_plain(q, k, v, log_w, u, chunk=ck,
                                    subtile=st, inclusive=inclusive)
        return _launch(q, k, v, log_w, u, ck, st, inclusive, depth, streams)

    so = tuple(x for x in policy.stream_options if chunk % x == 0)
    pol = policy if so == tuple(policy.stream_options) \
        else policy.replace(stream_options=so)
    w, tile = chunk_scan_workload(bh, s, n, p, chunk=chunk, dtype=q.dtype)
    choice = autotune.resolve_call(
        "ff_chunk_scan", pol, workload=w, tile=tile, dtype=q.dtype,
        workload_fn=lambda tk: chunk_scan_workload(
            bh, s, n, p, chunk=tk.get("chunk", chunk), dtype=q.dtype),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(tk.get("chunk", chunk), dep, st),
        tile_options=_TILE_OPTIONS,
        # statics outside the Workload that change the measured kernel
        extra_key=f"subtile={subtile}|inclusive={int(inclusive)}"
                  f"|u={int(u is not None)}",
        site={"bh": bh, "s": s, "n": n, "p": p, "chunk": chunk,
              "subtile": subtile, "inclusive": inclusive,
              "has_u": u is not None},
        site_dynamic=("bh", "s"),
        depth_cap=max(1, _deepest(q, k, v, log_w, chunk,
                                  _subtile(chunk, subtile))))
    out = run(choice.tile_kwargs.get("chunk", chunk), choice.depth,
              choice.streams)
    if q.device.type == "cuda":
        chunk_scan.launches += 1
    return out


def _launch(q, k, v, log_w, u, chunk, st, inclusive, depth, streams,
            clocks=None):
    """One launch of the body :func:`_body` picks. ``clocks``: None, or an
    int64 CUDA tensor of 4 counters a block of the f32 body (the cycles
    its thread 0 spends waiting for a word and in passes AB, C1 and C2;
    ``csrc/ff_chunk_scan.cu``), for measurement."""
    bh, s, n = q.shape
    p = v.shape[2]
    body = _body(q, k, v, chunk, st)
    deepest = _deepest(q, k, v, log_w, chunk, st)
    if depth > deepest:
        raise ValueError(
            f"depth {depth} needs more than the {SMEM_LIMIT} bytes of "
            f"shared memory of a block at N={n}, P={p}"
            + (f"; at most {deepest} stages fit" if deepest else
               f" ({body} body: not even one stage fits)"))
    if body == "ring":
        slices = _plan(bh, s, n, p, chunk,
                       _sm_count(q.device.index or 0)).slices
        q, k, v, log_w = (_aligned(x) for x in (q, k, v, log_w))
    else:
        cols = _f32_plan(bh, p).cols
        q, k, v, log_w = (x.contiguous() for x in (q, k, v, log_w))
    u = u.contiguous() if u is not None else None
    out = torch.empty((bh, s, p), dtype=q.dtype, device=q.device)
    types = sum(bit for bit, x in ((1, q), (2, k), (4, v), (8, log_w),
                                   (16, u))
                if x is not None and x.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr() if u is not None else None, out.data_ptr())
    stream = _build.stream_ptr(q.device)
    if body == "ring":
        rc = _entry(body)(*ptrs, bh, s, n, p, chunk, int(inclusive), types,
                          slices, depth, streams, stream)
        name = "ff_chunk_scan_ring"
    else:
        rc = _entry(body)(*ptrs, bh, s, n, p, cols, int(inclusive), types,
                          depth, streams,
                          clocks.data_ptr() if clocks is not None else None,
                          stream)
        name = "ff_chunk_scan_f32_ring"
    _build.check("ff_chunk_scan", name, rc)
    return out


chunk_scan = make_entrypoint("ff_chunk_scan", _apply, name="chunk_scan")


def _make_inputs(gen, device):
    bh, s, n, p = 2, 128, 16, 32

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k, v = 0.5 * rn(bh, s, n), 0.5 * rn(bh, s, n), rn(bh, s, p)
    lw = -0.5 * torch.exp(rn(bh, s, n))
    return (q, k, v, lw), {"chunk": 64, "subtile": 16, "inclusive": True}


def _sweep_inputs(gen, site, device):
    # operands at a recorded call-site shape (plan sweep)
    bh, s = int(site["bh"]), int(site["s"])
    n, p = int(site["n"]), int(site["p"])
    dt = getattr(torch, site.get("dtype", "float32"))

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    args = (0.5 * rn(bh, s, n), 0.5 * rn(bh, s, n), rn(bh, s, p),
            -0.5 * torch.exp(rn(bh, s, n)))
    args = tuple(x.to(dt) for x in args)
    if site.get("has_u"):
        args += (rn(bh, n).to(dt),)
    return args, {"chunk": int(site.get("chunk", 64)),
                  "subtile": int(site.get("subtile", 16)),
                  "inclusive": bool(site.get("inclusive", True))}


register_kernel(
    name="ff_chunk_scan",
    alias="chunk_scan",
    op=chunk_scan,
    ref=chunk_scan_ref,
    cost=chunk_scan_cost,
    workload=chunk_scan_workload,
    make_inputs=_make_inputs,
    bench_kwargs={"bh": 64, "s": 4096, "n": 64, "p": 64,
                  "dtype": torch.bfloat16},
    tile_options=_TILE_OPTIONS,
    regular=True,
    tol=1e-3,
    doc="gated linear-attention scan (Mamba2 / RWKV6)",
    shard_dims=(0, 0, 0, 0),     # head-batch dim data-parallel
    shard_out_dim=0,
    sweep_inputs=_sweep_inputs,
)
