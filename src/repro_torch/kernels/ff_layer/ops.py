"""The decode layer's projection kernels: wrappers, plain versions and
launchers of ``csrc/ff_layer.cu``.

Replaces the TPU kernels of ``repro/kernels/ff_layer/kernel.py``
(``build_matmul_program``, ``build_swiglu_program``) and the fused chain
oproj -> gateup -> down of the ``decode_layer`` StreamGraph
(``repro/models/layers.py:build_decode_layer_graph``, one pallas_call by
``repro/core/graph.py:_compile_chain``):

  * :func:`ff_layer_matmul` — ``maybe_rmsnorm(a) @ b`` with an optional
    q-bias + RoPE or residual epilogue (the graph's qproj, oproj and down
    nodes);
  * :func:`ff_layer_swiglu` — ``silu(maybe_rmsnorm(x) @ wg) *
    (maybe_rmsnorm(x) @ wu)`` (the gateup node);
  * :func:`ff_layer_mlp_tail` — oproj + residual -> RMSNorm + SwiGLU ->
    down + residual as one cooperative launch (the fused chain).

What bounds them on the H100: at decode a few rows meet a whole weight
matrix, about 2 operations per weight byte, so each is bound by device
memory (the weight bytes over 3.35 TB/s), and what keeps it from that is
the latency of getting enough bytes in flight. One body serves both
types: the work is tiles of 64 output columns times a split of k
(:func:`_plan`, from the shapes and the SM count alone, so every SM
streams, the same plan in bf16 and f32); each block feeds its weight rows
through a ring of ``depth`` 16 KB shared-memory stages (128 or 64 rows in
bf16, 64 or 32 in f32; ``streams`` sub-copies a stage, the reference's
``Pipe`` arguments; ``depth=1`` is the synchronous copy-then-compute
baseline), and the last block of a tile sums the splits' partials in
split order from a workspace the wrapper allocates. No k is refused: a
block stages at most a split's rows (:func:`_plan` splits any k into
pieces of at most 2048). The tail keeps its intermediates in an
L2-resident scratch buffer instead of a second and third launch.
``csrc/ff_layer.cu`` says more.

Each plain version repeats its kernel's rounding points (normalised rows
rounded to the input type before the product, f32 sums, the product
rounded to the output type before the epilogue, SwiGLU rounded once), and
the plain MLP tail is the staged composition of the other two, as the
kernel's tail is of its stages.

Each wrapper resolves its ring's ``depth`` and ``streams`` through the
pipe policy (``policy=``, the session policy, or the ``depth=`` /
``streams=`` keywords) as the op of its name, over the port's words
(:func:`ff_layer_workload`); the decode layer
(``repro_torch.models.layers.decode_layer``) resolves one plan for its
three launches as the graph ``decode_layer`` and hands it down.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.pipe import itemsize
from repro_torch.core.pipeline_model import Workload
from repro_torch.core.program import PipePolicy, make_entrypoint
from repro_torch.kernels import _build, device_table
from repro_torch.kernels.ff_matmul.ops import _sm_count

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # columns per 16-byte load
_EPILOGUE = {"none": 0, "rope": 1, "residual": 2}
# the ring (csrc/ff_layer.cu), both types: tiles of 64 output columns, 16 KB
# ring stages, the partial tile of a split [rows, 64] f32 (SwiGLU: g and u,
# 128)
_TILE = 64
_STAGE_BYTES = 16384
_PARTIAL_COLS = {"matmul": 64, "swiglu": 128}
_MAX_SPLIT_ROWS = 2048          # a split's k rows staged: 4 x 2048 f32
_MIN_SPLIT_ROWS = 32
_MAX_SMEM = 232448              # 227 KB of shared memory a block
_REF_BLOCK_M = 8                # the reference programs' row block


class Plan(NamedTuple):
    tiles: int                  # column tiles of 64
    split: int                  # k split over this many blocks a tile


def _plan(n: int, k: int, sm_count: int) -> Plan:
    """The launch's tiles and k split, from the output columns ``n``, the
    depth ``k`` and the SM count alone (not the type: a 64-column tile is
    one plan in bf16 and f32): the standalone kernels and the MLP tail's
    stages get the same plan at the same shape, so they sum in the same
    order. As many splits as keep tiles x splits within one block
    an SM (the cooperative tail's grid: 128 of 132 at qwen's projections,
    132 at its gate/up), no fewer than 32 rows a split, no more than 2048
    (what a block stages of its rows)."""
    tiles = max(1, -(-n // _TILE))
    split = min(max(1, sm_count // tiles), max(1, k // _MIN_SPLIT_ROWS))
    return Plan(tiles, max(split, -(-k // _MAX_SPLIT_ROWS)))


def _tile_columns(n: int, t: int, head_dim: Optional[int] = None,
                  dtype=torch.bfloat16) -> list:
    """The output columns of tile ``t`` in the tile's order, as
    ``csrc/ff_layer.cu`` ``mm_col`` places them (a SwiGLU tile takes the
    same columns of wg and of wu): 64 in order, or with RoPE 32 columns of
    the first halves of heads, then the same columns of the second halves,
    in 16-byte chunks (8 bf16 or 4 f32 columns). Columns past n are
    dropped."""
    if head_dim is None:
        return list(range(t * _TILE, min(n, (t + 1) * _TILE)))
    vec = _VEC[dtype]
    half, pairs = head_dim // 2, _TILE // 2 // vec   # chunks a half tile
    per_head = half // vec
    cols = []
    for second in (0, half):
        for pair in range(t * pairs, min((t + 1) * pairs, n // (2 * vec))):
            head = pair // per_head
            c0 = head * head_dim + (pair - head * per_head) * vec + second
            cols += range(c0, c0 + vec)
    return cols


def _split_rows(k: int, split: int) -> list:
    """The k rows ``[lo, hi)`` of each split, as ``csrc/ff_layer.cu``
    ``split_lo`` cuts them: ``s * k // split`` rounded down to a multiple
    of 8, so the activation slices of a k % 8 == 0 row are 16-byte
    aligned."""
    lo = [s * k // split // 8 * 8 for s in range(split)] + [k]
    return list(zip(lo[:-1], lo[1:]))


def _smem_bytes(depth: int, split_rows: int = _MAX_SPLIT_ROWS + 8) -> int:
    """Shared memory of a block (csrc/ff_layer.cu ring_smem_bytes), the
    same in bf16 and f32: the 16 KB stages and their two mbarriers, 4 rows
    of the split's k slice in f32 (by default the most a plan gives:
    ``_split_rows`` rounds bounds down to 8), four warps' and the block's
    f32 sums of 128 columns, the rows' rsqrt, a flag."""
    return (depth * (_STAGE_BYTES + 16) + 4 * (4 * split_rows + 5 * 512 + 4)
            + 16)


MAX_DEPTH = max(d for d in range(1, 64) if _smem_bytes(d) <= _MAX_SMEM)


def _pipe(depth: int, streams: int) -> None:
    """``depth`` and ``streams`` checked as the reference's ``Pipe`` checks
    them on its programs' activation stream (a tile of 8 rows): each at
    least 1, ``streams`` dividing 8; ``depth`` stages must also fit in
    shared memory (the same stages in bf16 and f32). A 16 KB stage holds
    64 or 128 weight rows in bf16, 32 or 64 in f32, so each sub-copy is at
    least 4 rows."""
    if depth < 1:
        raise ValueError(f"pipe depth must be >= 1, got {depth}")
    if streams < 1:
        raise ValueError(f"pipe streams must be >= 1, got {streams}")
    if _REF_BLOCK_M % streams:
        raise ValueError(f"streams={streams} must divide the reference's "
                         f"{_REF_BLOCK_M}-row blocks")
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} needs {_smem_bytes(depth)} bytes "
                         f"of shared memory; at most {MAX_DEPTH} stages "
                         f"fit in {_MAX_SMEM}")


def stream_options(options) -> tuple:
    """The stream counts of ``options`` the kernels can run: those
    dividing the reference's 8-row blocks."""
    return tuple(s for s in options if _REF_BLOCK_M % s == 0)


def ff_layer_workload(m: int, k: int, n: int, *, dtype=torch.bfloat16,
                      gated: bool = False
                      ) -> Tuple[Workload, Tuple[int, int]]:
    """One product's stream program in the port's words: a 16 KB ring
    stage of weight rows for one 64-column tile (128 rows of k in bf16,
    64 in f32; a SwiGLU stage holds wg's and wu's columns, so half as
    many), ``ceil(k / rows)`` of them a tile. The reference's words are
    the activation's 8-row blocks against its weight blocks; the port
    streams the weights, which is what bounds a decode step. Each word
    does ``m`` rows' products over its rows; the output is written once.
    Planning tile = (weight rows a word, 64)."""
    item = itemsize(dtype)
    cols = _TILE * (2 if gated else 1)
    rows = max(_STAGE_BYTES // (cols * item), 1)
    n_words = max(-(-n // _TILE) * -(-k // rows), 1)
    w = Workload(
        n_words=n_words,
        word_bytes=float(rows * cols * item),
        flops_per_word=2.0 * m * rows * cols,
        regular=True,
        store_bytes_per_word=float(m * n * item) / n_words,
    )
    return w, (rows, _TILE)


def mlp_tail_nodes(m: int, hq: int, d: int, f: int, *,
                   dtype=torch.bfloat16):
    """The tail's three stages as ``(name, Workload, tile)``: the
    out-projection [hq, d], gate/up [d, f] x 2, the down-projection
    [f, d]."""
    return (("oproj",) + ff_layer_workload(m, hq, d, dtype=dtype),
            ("gateup",) + ff_layer_workload(m, d, f, dtype=dtype,
                                            gated=True),
            ("down",) + ff_layer_workload(m, f, d, dtype=dtype))


def resolve_pipe(op: str, policy, dtype, w, tile, run, site
                 ) -> Tuple[int, int]:
    """(depth, streams) of one launch under ``policy``."""
    so = stream_options(policy.stream_options)
    pol = policy if so == tuple(policy.stream_options) \
        else policy.replace(stream_options=so)
    choice = autotune.resolve_call(
        op, pol, workload=w, tile=tile, dtype=dtype,
        workload_fn=lambda tk: (w, tile),
        runner=None if autotune.in_capture() else
        lambda tk, dep, st: lambda: run(dep, st),
        site=site, site_dynamic=("m",), depth_cap=MAX_DEPTH)
    _pipe(choice.depth, choice.streams)
    return choice.depth, choice.streams


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def rms_ref(x: torch.Tensor, nw: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm as the reference's ``_rms``: f32 mean square, rsqrt(+eps),
    times the f32 weight, rounded to the input type."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                            + eps)
    return (x32 * nw.float()).to(x.dtype)


@device_table
def rope_freqs(theta: float, half: int, device: torch.device
               ) -> torch.Tensor:
    """``theta ** (-j / half)`` for j < half, f32, made once per device
    (afresh under a fake mode: :func:`~repro_torch.kernels.device_table`)."""
    return theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)


def rope_bias_ref(val, bias, positions, *, rope_theta: float,
                  head_dim: int) -> torch.Tensor:
    """The qproj epilogue: ``val`` (already in its output type) plus the q
    bias in f32, rotated per head of ``head_dim`` by the positions' angles
    in f32, rounded back."""
    m, n = val.shape
    half = head_dim // 2
    v = val.float()
    if bias is not None:
        v = v + bias.float()
    ang = positions.float()[:, None] * rope_freqs(float(rope_theta), half,
                                                  val.device)
    c = torch.cos(ang)[:, None, :]
    s = torch.sin(ang)[:, None, :]
    vh = v.view(m, n // head_dim, head_dim)
    x1, x2 = vh[..., :half], vh[..., half:]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(m, n).to(val.dtype)


def ff_layer_matmul_ref(a, b, *, norm_weight=None, eps: float = 1e-6,
                        bias=None, positions=None, rope_theta=None,
                        head_dim=None, residual=None) -> torch.Tensor:
    """Plain version of :func:`ff_layer_matmul`."""
    dt = a.dtype
    if norm_weight is not None:
        a = rms_ref(a, norm_weight, eps)
    val = torch.matmul(a.float(), b.float()).to(dt)
    if positions is not None:
        return rope_bias_ref(val, bias, positions, rope_theta=rope_theta,
                             head_dim=head_dim)
    if residual is not None:
        return val + residual
    return val


def ff_layer_swiglu_ref(x, wg, wu, *, norm_weight=None,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`ff_layer_swiglu`."""
    if norm_weight is not None:
        x = rms_ref(x, norm_weight, eps)
    xf = x.float()
    g = torch.matmul(xf, wg.float())
    u = torch.matmul(xf, wu.float())
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def ff_layer_mlp_tail_ref(a, wo, x, nw2, wg, wu, wo2, *,
                          eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`ff_layer_mlp_tail`: the staged composition
    of the two plain versions above."""
    h = ff_layer_matmul_ref(a, wo, residual=x)
    act = ff_layer_swiglu_ref(h, wg, wu, norm_weight=nw2, eps=eps)
    return ff_layer_matmul_ref(act, wo2, residual=h)


def mlp_tail_staged(a, wo, x, nw2, wg, wu, wo2, *, eps: float = 1e-6,
                    **pipe) -> torch.Tensor:
    """The MLP tail as three wrapper calls (three launches on the card):
    what :func:`ff_layer_mlp_tail` must equal bit for bit. ``pipe``:
    ``depth``/``streams`` of every launch."""
    h = ff_layer_matmul(a, wo, residual=x, **pipe)
    act = ff_layer_swiglu(h, wg, wu, norm_weight=nw2, eps=eps, **pipe)
    return ff_layer_matmul(act, wo2, residual=h, **pipe)


# ---------------------------------------------------------------------------
# checks and launchers
# ---------------------------------------------------------------------------


def _device_of(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"ff_layer operands must be on one device, got "
                         f"{sorted(str(d) for d in devs)}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ff_layer runs on cpu or cuda, not {dev}")
    return dev


def _check_act(name, t, dtype, shape):
    if t.dtype != dtype or dtype not in _SUFFIX:
        raise TypeError(f"{name}: ff_layer takes float32 or bfloat16 "
                        f"operands of one type; got {t.dtype}, {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)} != {tuple(shape)}")


def _check_weight(name, w, dtype, rows, cols=None):
    if w.dim() != 2 or w.shape[0] != rows or (cols is not None
                                              and w.shape[1] != cols):
        raise ValueError(f"{name} {tuple(w.shape)} is not "
                         f"[{rows}, {cols if cols is not None else 'n'}]")
    _check_act(name, w, dtype, w.shape)


def _check_norm(nw, k):
    if nw is not None and (nw.shape != (k,) or nw.dtype != torch.float32):
        raise ValueError(f"norm weight {tuple(nw.shape)} {nw.dtype} is not "
                         f"float32 [{k}]")


def _check_cuda_layout(acts, weights):
    """What the kernels read: activations contiguous, weights with a
    contiguous last dim (any row stride: ``wi[:, :f]`` is taken as it
    is)."""
    for t in acts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"operand {tuple(t.shape)} with strides "
                             f"{t.stride()} is not contiguous")
    for w in weights:
        if w.stride(-1) != 1:
            raise ValueError(f"weight {tuple(w.shape)} with strides "
                             f"{w.stride()} has no contiguous last dim")


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    ring = [i, i, i, p, p]            # depth, streams, split, ws, tickets
    args = {
        "ff_layer_matmul": [p, p, ll, p, p, i, i, i, f, i, p, p, p, i, p]
        + ring + [p],
        "ff_layer_swiglu": [p, p, p, ll, p, p, i, i, i, f] + ring + [p],
        "ff_layer_mlp_tail": [p, p, ll, p, p, p, p, ll, p, ll, p, p, p, i, i,
                              i, i, f, i, i, i, i, i, p, p, p],
    }[kernel]
    return _build.bind("ff_layer", f"{kernel}_{_SUFFIX[dtype]}", args)


def _launch(kernel: str, dtype, device, *args) -> None:
    rc = _entry(kernel, dtype)(*args, _build.stream_ptr(device))
    _build.check("ff_layer", kernel, rc)


def ring_size(m: int, stages, sm_count: int) -> Tuple[list, int, int]:
    """What launches of ``stages`` ``[(kind, n, k), ...]`` at ``m`` rows
    need, in either type: each stage's k split, the f32 workspace words
    of the splits' partial tiles (the largest stage's) and the tickets
    (two words of the MLP tail's grid barrier, then one a column tile of
    the widest stage). A pure function of the shapes and the SM count."""
    plans = [(_plan(n, k, sm_count), _PARTIAL_COLS[kind])
             for kind, n, k in stages]
    words = max(pl.tiles * pl.split * m * cols if pl.split > 1 else 0
                for pl, cols in plans)
    return ([pl.split for pl, _ in plans], words,
            max(pl.tiles for pl, _ in plans) + 2)


_TICKETS: Dict[tuple, torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """``n`` ticket words (:func:`ring_size`), zeroed once per device and
    stream: every launch leaves the barrier count and the tickets at 0
    again (the last block to arrive resets them), so no launch clears
    them. A buffer that is too small is replaced by a larger one, and the
    old one is kept alive: a captured CUDA graph holds its address.
    Replacing one while the stream is capturing raises: a compiled step
    sizes the buffer by warming up on its capture stream first."""
    key = (device, _build.stream_ptr(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if _build.capturing(device):
            raise RuntimeError(
                "ff_layer: tickets would be allocated during CUDA graph "
                "capture; run the step once on the capture stream first")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _ring(device, m: int, stages) -> Tuple[list, Optional[torch.Tensor],
                                            torch.Tensor]:
    """Each stage's k split, the workspace of the splits' f32 partial tiles
    (allocated per call: under capture it lives in the graph's pool) and
    the tickets, for launches of ``stages`` ``[(kind, n, k), ...]`` at
    ``m`` rows (:func:`ring_size`), the same in bf16 and f32."""
    splits, words, tickets = ring_size(m, stages, _sm_count(device.index))
    ws = (torch.empty(words, dtype=torch.float32, device=device)
          if words else None)
    return splits, ws, _tickets(device, tickets)


def _launch_matmul(a, b, out, *, norm_weight, eps, epilogue, bias, pos,
                   freqs, head_dim, residual, depth, streams) -> None:
    (m, k), n = a.shape, b.shape[1]
    (split,), ws, tickets = _ring(a.device, m, [("matmul", n, k)])
    _launch("ff_layer_matmul", a.dtype, a.device, a.data_ptr(),
            b.data_ptr(), b.stride(0), _ptr(norm_weight), out.data_ptr(), m,
            n, k, eps, _EPILOGUE[epilogue], _ptr(bias), _ptr(pos),
            _ptr(freqs), head_dim or 0, _ptr(residual), depth, streams,
            split, _ptr(ws), _ptr(tickets))


def _launch_swiglu(x, wg, wu, out, *, norm_weight, eps, depth,
                   streams) -> None:
    (m, k), f = x.shape, wg.shape[1]
    (split,), ws, tickets = _ring(x.device, m, [("swiglu", f, k)])
    _launch("ff_layer_swiglu", x.dtype, x.device, x.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wg.stride(0), _ptr(norm_weight),
            out.data_ptr(), m, f, k, eps, depth, streams, split, _ptr(ws),
            _ptr(tickets))


def _launch_tail(a, wo, x, nw2, wg, wu, wo2, out, scratch, *, eps, depth,
                 streams) -> None:
    (m, hq), d, f = a.shape, wo.shape[1], wg.shape[1]
    splits, ws, tickets = _ring(a.device, m, [
        ("matmul", d, hq), ("swiglu", f, d), ("matmul", d, f)])
    h, act = scratch[:m * d], scratch[m * d:]
    _launch("ff_layer_mlp_tail", a.dtype, a.device, a.data_ptr(),
            wo.data_ptr(), wo.stride(0), x.data_ptr(), nw2.data_ptr(),
            wg.data_ptr(), wu.data_ptr(), wg.stride(0), wo2.data_ptr(),
            wo2.stride(0), h.data_ptr(), act.data_ptr(), out.data_ptr(), m,
            hq, d, f, eps, depth, streams, *splits, _ptr(ws), _ptr(tickets))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _apply_matmul(a, b, *, norm_weight=None, eps: float = 1e-6,
                  bias=None, positions=None, rope_theta=None,
                  head_dim=None, residual=None,
                  policy: PipePolicy) -> torch.Tensor:
    """``out = epilogue(round(maybe_rmsnorm(a) @ b))``.

    a: [m, k]; b: [k, n] (f32 or bf16, one type); ``norm_weight``: [k] f32
    turns on the RMSNorm prologue. Epilogue, at most one of:
      * RoPE: ``positions`` [m] (int), ``rope_theta`` and ``head_dim`` (n a
        multiple of it), optional q ``bias`` [n]: the value plus the bias
        in f32, rotated per head, rounded back;
      * ``residual`` [m, n]: added in the output type.
    ``policy`` sizes the weight ring's stages and sub-copies a stage
    (:func:`_pipe`); the result does not depend on them. Returns [m, n] in
    a's type. mode="ref" and CPU tensors run :func:`ff_layer_matmul_ref`;
    CUDA tensors launch the kernel."""
    if a.dim() != 2:
        raise ValueError(f"a {tuple(a.shape)} is not [m, k]")
    m, k = a.shape
    dt = a.dtype
    _check_weight("b", b, dt, k)
    n = b.shape[1]
    _check_norm(norm_weight, k)
    rope = positions is not None
    if rope and residual is not None:
        raise ValueError("ff_layer_matmul takes one epilogue: RoPE or a "
                         "residual, not both")
    if bias is not None and not rope:
        raise ValueError("the q bias rides the RoPE epilogue: pass "
                         "positions, rope_theta and head_dim with it")
    if rope:
        if head_dim is None or rope_theta is None or head_dim % 2 \
                or n % head_dim:
            raise ValueError(f"RoPE needs an even head_dim dividing n={n} "
                             f"and rope_theta; got {head_dim}, {rope_theta}")
        if positions.shape != (m,) or positions.is_floating_point():
            raise ValueError(f"positions {tuple(positions.shape)} "
                             f"{positions.dtype} are not integer [{m}]")
        if bias is not None:
            _check_act("bias", bias, dt, (n,))
    if residual is not None:
        _check_act("residual", residual, dt, (m, n))
    dev = _device_of(a, b, norm_weight, bias, positions, residual)
    kw = dict(norm_weight=norm_weight, eps=eps, bias=bias,
              positions=positions, rope_theta=rope_theta, head_dim=head_dim,
              residual=residual)
    if policy.mode == "ref" or dev.type == "cpu":
        if policy.mode != "ref":
            resolve_pipe("ff_layer_matmul", policy, dt,
                         *ff_layer_workload(m, k, n, dtype=dt),
                         lambda dep, st: ff_layer_matmul_ref(a, b, **kw),
                         {"m": m, "k": k, "n": n})
        return ff_layer_matmul_ref(a, b, **kw)
    _check_cuda_layout((a, norm_weight, bias, residual), (b,))
    freqs = pos = None
    if rope:
        if (head_dim // 2) % _VEC[dt]:
            raise ValueError(f"head_dim/2={head_dim // 2} is not a multiple "
                             f"of {_VEC[dt]} columns (one 16-byte load)")
        freqs = rope_freqs(float(rope_theta), head_dim // 2, dev)
        pos = positions.to(torch.int32).contiguous()
    epi = "rope" if rope else "residual" if residual is not None else "none"

    def run(depth, streams):
        out = torch.empty(m, n, dtype=dt, device=dev)
        _launch_matmul(a, b, out, norm_weight=norm_weight, eps=eps,
                       epilogue=epi, bias=bias, pos=pos, freqs=freqs,
                       head_dim=head_dim, residual=residual, depth=depth,
                       streams=streams)
        return out

    out = run(*resolve_pipe("ff_layer_matmul", policy, dt,
                            *ff_layer_workload(m, k, n, dtype=dt), run,
                            {"m": m, "k": k, "n": n}))
    ff_layer_matmul.launches += 1
    return out


def _apply_swiglu(x, wg, wu, *, norm_weight=None, eps: float = 1e-6,
                  policy: PipePolicy) -> torch.Tensor:
    """``silu(maybe_rmsnorm(x) @ wg) * (maybe_rmsnorm(x) @ wu)`` in f32,
    rounded once. x: [m, k]; wg, wu: [k, f] with one row stride (the two
    halves of ``wi`` are taken as they are); ``norm_weight``: [k] f32;
    ``policy`` as :func:`ff_layer_matmul`'s. Returns [m, f]. mode="ref"
    and CPU tensors run :func:`ff_layer_swiglu_ref`; CUDA tensors launch
    the kernel."""
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} is not [m, k]")
    m, k = x.shape
    dt = x.dtype
    _check_weight("wg", wg, dt, k)
    _check_weight("wu", wu, dt, k, wg.shape[1])
    _check_norm(norm_weight, k)
    dev = _device_of(x, wg, wu, norm_weight)
    f = wg.shape[1]
    site = {"m": m, "k": k, "f": f}
    if policy.mode == "ref" or dev.type == "cpu":
        def ref(*_):
            return ff_layer_swiglu_ref(x, wg, wu, norm_weight=norm_weight,
                                       eps=eps)
        if policy.mode != "ref":
            resolve_pipe("ff_layer_swiglu", policy, dt,
                         *ff_layer_workload(m, k, f, dtype=dt, gated=True),
                         ref, site)
        return ref()
    _check_cuda_layout((x, norm_weight), (wg, wu))
    if wg.stride(0) != wu.stride(0):
        raise ValueError("wg and wu need one row stride")

    def run(depth, streams):
        out = torch.empty(m, f, dtype=dt, device=dev)
        _launch_swiglu(x, wg, wu, out, norm_weight=norm_weight, eps=eps,
                       depth=depth, streams=streams)
        return out

    out = run(*resolve_pipe("ff_layer_swiglu", policy, dt,
                            *ff_layer_workload(m, k, f, dtype=dt,
                                               gated=True), run, site))
    ff_layer_swiglu.launches += 1
    return out


def _apply_tail(a, wo, x, nw2, wg, wu, wo2, *, eps: float = 1e-6,
                policy: PipePolicy) -> torch.Tensor:
    """The decode layer after attention, in one launch:
    ``h = round(a @ wo) + x``; ``act = swiglu(rmsnorm(h, nw2))``;
    ``out = round(act @ wo2) + h``.

    a: [m, hq] attention output (heads flattened); wo: [hq, d]; x: [m, d]
    the layer input; nw2: [d] f32; wg, wu: [d, f] (one row stride); wo2:
    [f, d]; ``policy`` as :func:`ff_layer_matmul`'s, one plan for all
    three stages (their workloads summed). Returns [m, d]. mode="ref" and
    CPU tensors run :func:`ff_layer_mlp_tail_ref`; CUDA tensors launch the
    cooperative kernel, whose grid is sized to what can be resident at
    once (a refused launch raises)."""
    if a.dim() != 2:
        raise ValueError(f"a {tuple(a.shape)} is not [m, hq]")
    m, hq = a.shape
    dt = a.dtype
    _check_weight("wo", wo, dt, hq)
    d = wo.shape[1]
    _check_act("x", x, dt, (m, d))
    _check_norm(nw2, d)
    _check_weight("wg", wg, dt, d)
    f = wg.shape[1]
    _check_weight("wu", wu, dt, d, f)
    _check_weight("wo2", wo2, dt, f, d)
    dev = _device_of(a, wo, x, nw2, wg, wu, wo2)
    wl, tile = autotune.graph_workload(mlp_tail_nodes(m, hq, d, f,
                                                      dtype=dt))
    site = {"m": m, "hq": hq, "d": d, "f": f}
    if policy.mode == "ref" or dev.type == "cpu":
        def ref(*_):
            return ff_layer_mlp_tail_ref(a, wo, x, nw2, wg, wu, wo2,
                                         eps=eps)
        if policy.mode != "ref":
            resolve_pipe("ff_layer_mlp_tail", policy, dt, wl, tile, ref,
                         site)
        return ref()
    _check_cuda_layout((a, x, nw2), (wo, wg, wu, wo2))
    if wg.stride(0) != wu.stride(0):
        raise ValueError("wg and wu need one row stride")

    def run(depth, streams):
        scratch = torch.empty(m * (d + f), dtype=dt, device=dev)
        out = torch.empty(m, d, dtype=dt, device=dev)
        _launch_tail(a, wo, x, nw2, wg, wu, wo2, out, scratch, eps=eps,
                     depth=depth, streams=streams)
        return out

    out = run(*resolve_pipe("ff_layer_mlp_tail", policy, dt, wl, tile, run,
                            site))
    ff_layer_mlp_tail.launches += 1
    return out


ff_layer_matmul = make_entrypoint("ff_layer_matmul", _apply_matmul)
ff_layer_swiglu = make_entrypoint("ff_layer_swiglu", _apply_swiglu)
ff_layer_mlp_tail = make_entrypoint("ff_layer_mlp_tail", _apply_tail)
