"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a: H100/H200); elsewhere each
test skips, decided inside the ``cuda`` fixture, never at import. Run them
on the card with (``--noconftest``: the tests' conftest imports JAX, which
the card's machine need not have):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: float32 2e-4 (the reference registry's), bfloat16 2e-2; the
paged kernel equals the contiguous one bit for bit at block_kv == page,
both decode kernels equal themselves across the ring's depth and streams
bit for bit (short and split rows, zamba2's head dim 80, pages of 1 to
32 rows, unaligned caches), the decode layer's three kernels (bf16 and
f32: one ring body) too, and the one-launch MLP tail equals its three
staged launches bit for bit at every ring setting.
The library kernels and graphs (matmul, gather, attention_proj,
moe_dispatch_ffn) are held at float32 5e-4 (the reference registry's tol
of both graphs) and bfloat16 2e-2, each relative and absolute and chosen
by the output's type; the gather (at every ring depth and streams, and
on rows cut into slabs), every fused launch against its staged
composition, and the product (bf16, f32 and the mixed pairs), the
gathered product, attention and attention_proj (bf16 and f32) across the
ring's depth and streams at exactly 0. The chunk scan is held at float32 3e-5 and
bfloat16 2e-2 of max |plain| (the reference kernel test's bound) at every
chunk up to 256 (N = P = 128 and 256 too, and odd N and P), its
strong-decay case at rtol 1e-4 / atol 1e-5, and the bf16 scan (the
tensor-core body) and the f32 scan (the f32 ring body) across the ring's
depth and streams at exactly 0. These
tests take small and ragged shapes; chip_smoke.py checks the same kernels
at full model width.
"""

import pytest
import torch

from repro_torch.kernels.ff_attention import (attention, attention_proj,
                                             attention_proj_ref,
                                             attention_ref)
from repro_torch.kernels.ff_chunk_scan import (chunk_scan, chunk_scan_plain,
                                               chunk_scan_ref, f32_max_depth,
                                               max_depth)
from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                     decode_attention_ref)
from repro_torch.kernels.ff_layer import ops as layer_ops
from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                          ff_layer_matmul_ref,
                                          ff_layer_mlp_tail,
                                          ff_layer_mlp_tail_ref,
                                          ff_layer_swiglu,
                                          ff_layer_swiglu_ref,
                                          mlp_tail_staged)
from repro_torch.kernels.ff_gather import gather, gather_ref
from repro_torch.kernels.ff_gather import max_depth as gather_max_depth
from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                           dispatch_matmul_ref, matmul,
                                           matmul_ref)
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.runtime import paged_kv

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_prefill_kernel_matches_plain(cuda, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(8, 77, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(4, 77, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(4, 77, 64, generator=g, device=cuda).to(dtype)
    n = attention.launches
    out = attention(q, k, v, kv_groups=2, causal=causal)
    assert attention.launches == n + 1
    ref = attention_ref(q, k, v, kv_groups=2, causal=causal)
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("d", [64, 80, 128, 20, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_attention_at_every_head_dim(cuda, d, causal):
    """The tensor-core body at qwen's 64, zamba2's 80 (padded to 128), the
    dense configs' 128, 256 (four slabs) and 20 (element copies: TMA cannot
    describe a 40-byte row), GQA 2, ragged S, within 2e-2 of the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(15)
    bf = torch.bfloat16
    q = torch.randn(6, 150, d, generator=g, device=cuda).to(bf)
    k = torch.randn(3, 150, d, generator=g, device=cuda).to(bf)
    v = torch.randn(3, 150, d, generator=g, device=cuda).to(bf)
    out = attention(q, k, v, kv_groups=2, causal=causal)
    ref = attention_ref(q, k, v, kv_groups=2, causal=causal)
    assert out.isfinite().all() and _err(out, ref) <= TOL[bf]


def test_bf16_attention_takes_unaligned_operands(cuda):
    """Operands whose base is not 16-byte aligned go through element
    copies and give the same bits as aligned copies of them."""
    g = torch.Generator(device=cuda).manual_seed(16)
    bf = torch.bfloat16
    n = 4 * 77 * 64
    buf = torch.randn(3 * n + 1, generator=g, device=cuda).to(bf)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(4, 77, 64)
               for i in range(3))
    out = attention(q, k, v)
    assert torch.equal(out, attention(q.clone(), k.clone(), v.clone()))
    assert _err(out, attention_ref(q, k, v)) <= TOL[bf]


@pytest.mark.parametrize("s,skv,causal", [(256, 256, True), (77, 77, True),
                                          (100, 70, False)])
def test_bf16_attention_is_bitwise_across_depth_and_streams(cuda, s, skv,
                                                            causal):
    """The ring's depth and streams change when a K/V tile lands, not what
    is computed: the same bits at every (depth, streams)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    bf = torch.bfloat16
    q = torch.randn(8, s, 64, generator=g, device=cuda).to(bf)
    k = torch.randn(4, skv, 64, generator=g, device=cuda).to(bf)
    v = torch.randn(4, skv, 64, generator=g, device=cuda).to(bf)
    base = attention(q, k, v, kv_groups=2, causal=causal, depth=1, streams=1)
    for depth in (1, 2, 4):
        for streams in (1, 2):
            assert torch.equal(attention(q, k, v, kv_groups=2, causal=causal,
                                         depth=depth, streams=streams), base)
    assert _err(base, attention_ref(q, k, v, kv_groups=2,
                                    causal=causal)) <= TOL[bf]


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_ragged_kv_never_reads_the_next_head(cuda, causal):
    """Skv = 70 is ragged against the 64-row tiles: the second tile of KV
    head 0 ends where KV head 1 begins. Head 1 is all inf; the outputs of
    the q heads that read head 0 stay finite and within tolerance."""
    g = torch.Generator(device=cuda).manual_seed(18)
    bf = torch.bfloat16
    q = torch.randn(4, 100, 64, generator=g, device=cuda).to(bf)
    k = torch.randn(2, 70, 64, generator=g, device=cuda).to(bf)
    v = torch.randn(2, 70, 64, generator=g, device=cuda).to(bf)
    k[1], v[1] = float("inf"), float("inf")
    out = attention(q, k, v, kv_groups=2, causal=causal)
    ref = attention_ref(q[:2], k[:1], v[:1], kv_groups=2, causal=causal)
    assert out[:2].isfinite().all() and _err(out[:2], ref) <= TOL[bf]


PIPES = [(d, st) for d in (1, 2, 4) for st in (1, 2)]


def _decode_case(dev, dtype, seed, nb, page, kvh, d, b, h, npg, lens):
    """A pool of stale values, a permuted table (row i's pages past its
    length are sentinels), the same K/V gathered into a contiguous
    cache."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randn(nb, 2, page, kvh, d, generator=g, device=dev)
    pool = pool.to(dtype)
    tables = torch.randperm(nb, generator=g, device=dev)[:b * npg]
    tables = tables.view(b, npg).int()
    for i, n in enumerate(lens):
        tables[i, -(-n // page):] = nb                 # sentinels
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    k, v = paged_kv.paged_gather(pool, tables)
    return q, pool, tables, lens, k, v


def _decode_both(q, pool, tables, lens, k, v, **pipe):
    page = pool.shape[2]
    dense = decode_attention(q, k, v, lens, block_kv=page, **pipe)
    paged = paged_kv.paged_decode_attention(q, pool, tables, lens, **pipe)
    return dense, paged


@pytest.mark.parametrize("pipe", PIPES, ids=[f"d{d}s{s}" for d, s in PIPES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernels_match_plain_and_each_other(cuda, dtype, pipe):
    """At every ring depth x streams: paged == contiguous, both equal to
    the default setting bit for bit, within tolerance of the plain
    version, inactive rows exactly 0, sentinel entries clipped."""
    nb, page, kvh, d, b, h, npg = 20, 16, 2, 64, 3, 4, 5
    q, pool, tables, lens, k, v = _decode_case(
        cuda, dtype, 1, nb, page, kvh, d, b, h, npg, [37, npg * page, 0])
    tables[2] = nb                                  # inactive slot
    dense, paged = _decode_both(q, pool, tables, lens, k, v,
                                depth=pipe[0], streams=pipe[1])
    want, _ = _decode_both(q, pool, tables, lens, k, v)
    assert torch.equal(dense, paged) and torch.equal(dense, want)
    assert _err(dense, decode_attention_ref(q, k, v, lens,
                                            block_kv=page)) <= TOL[dtype]
    assert paged[2].eq(0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_at_zamba2_head_dim(cuda, dtype):
    """Zamba2's attention: 32 heads of 80 (MHA), a cache of 272 rows
    (17 pages of 16), one row past the cache; split over blocks."""
    from repro_torch.kernels.ff_decode_attention import ops as DO
    b, h, d, page, npg = 4, 32, 80, 16, 17
    q, pool, tables, lens, k, v = _decode_case(
        cuda, dtype, 5, b * npg, page, h, d, b, h, npg, [257, 263, 272, 259])
    lens[3] = 300                                   # past the cache
    assert DO._plan(b, h, d, dtype, npg * page, 132).split > 1
    want, paged = _decode_both(q, pool, tables, lens, k, v)
    assert torch.equal(want, paged)
    assert _err(want, decode_attention_ref(q, k, v, lens,
                                           block_kv=page)) <= TOL[dtype]
    for depth, st in PIPES:
        assert all(torch.equal(o, want) for o in _decode_both(
            q, pool, tables, lens, k, v, depth=depth, streams=st))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("page", [16, 8, 32, 1])
def test_long_decode_takes_the_split_path(cuda, dtype, page):
    """A long cache (2048 rows, GQA 3) split over many blocks a row; the
    tickets reset themselves, so a second launch gives the same bits."""
    from repro_torch.kernels.ff_decode_attention import ops as DO
    b, kvh, h, d, npg = 3, 2, 6, 64, 2048 // page
    q, pool, tables, lens, k, v = _decode_case(
        cuda, dtype, 6, b * npg + 3, page, kvh, d, b, h, npg,
        [2048, 1500, 33])
    assert DO._plan(b, kvh, d, dtype, npg * page, 132).split > 1
    want, paged = _decode_both(q, pool, tables, lens, k, v)
    assert torch.equal(want, paged)
    assert _err(want, decode_attention_ref(q, k, v, lens,
                                           block_kv=page)) <= TOL[dtype]
    for depth, st in PIPES:
        if page % st == 0:                          # as the reference's Pipe
            assert all(torch.equal(o, want) for o in _decode_both(
                q, pool, tables, lens, k, v, depth=depth, streams=st))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_takes_unaligned_caches(cuda, dtype):
    """Head dim 70 (rows not a multiple of 16 bytes) and a cache view at
    an odd offset: the producer's element copies, against the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, kvh, h, s, d = 2, 2, 4, 96, 70
    q = torch.randn(b, h, d, generator=g, device=cuda).to(dtype)
    big = torch.randn(b, kvh, s, d + 3, generator=g, device=cuda).to(dtype)
    k, v = big[..., 1:d + 1], big[..., 2:d + 2]
    lens = torch.tensor([95, 40], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lens, block_kv=32)
    ref = decode_attention_ref(q, k, v, lens, block_kv=32)
    assert _err(out, ref) <= TOL[dtype]
    for depth, st in PIPES:
        assert torch.equal(decode_attention(q, k, v, lens, block_kv=32,
                                            depth=depth, streams=st), out)


def test_decode_refuses_a_pipe_the_reference_refuses(cuda):
    q, pool, tables, lens, k, v = _decode_case(
        cuda, torch.bfloat16, 1, 8, 16, 2, 64, 2, 4, 2, [20, 5])
    for bad in (dict(depth=0), dict(streams=0), dict(streams=3),
                dict(depth=10 ** 4)):
        with pytest.raises(ValueError):
            decode_attention(q, k, v, lens, block_kv=16, **bad)
        with pytest.raises(ValueError):
            paged_kv.paged_decode_attention(q, pool, tables, lens, **bad)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 8, 300, device=cuda)          # head dim > 256
    with pytest.raises(ValueError):
        attention(q, q, q)
    with pytest.raises(ValueError):                  # mixed devices
        attention(torch.zeros(2, 8, 64, device=cuda), torch.zeros(2, 8, 64),
                  torch.zeros(2, 8, 64))


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g, device=g.device) * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 4, 13])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "rmsnorm"])
@pytest.mark.parametrize("epilogue", ["none", "rope", "residual"])
def test_ff_layer_matmul_matches_plain(cuda, dtype, m, norm, epilogue):
    g = torch.Generator(device=cuda).manual_seed(2)
    k, n, hd = 1024, 1024, 64
    a = _randn(g, m, k).to(dtype)
    b = _randn(g, k, n, scale=k ** -0.5).to(dtype)
    kw = {}
    if norm:
        kw["norm_weight"] = 1 + 0.1 * _randn(g, k)
    if epilogue == "rope":
        kw.update(bias=_randn(g, n, scale=0.1).to(dtype), rope_theta=1e6,
                  head_dim=hd, positions=torch.randint(
                      0, 4096, (m,), generator=g, device=cuda))
    elif epilogue == "residual":
        kw["residual"] = _randn(g, m, n).to(dtype)
    n0 = ff_layer_matmul.launches
    out = ff_layer_matmul(a, b, **kw)
    assert ff_layer_matmul.launches == n0 + 1
    assert _err(out, ff_layer_matmul_ref(a, b, **kw)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 4, 16])
def test_ff_layer_swiglu_matches_plain(cuda, dtype, m):
    g = torch.Generator(device=cuda).manual_seed(3)
    k, f = 1024, 2816
    x = _randn(g, m, k).to(dtype)
    wi = _randn(g, k, 2 * f, scale=k ** -0.5).to(dtype)
    nw = 1 + 0.1 * _randn(g, k)
    out = ff_layer_swiglu(x, wi[:, :f], wi[:, f:], norm_weight=nw)
    ref = ff_layer_swiglu_ref(x, wi[:, :f], wi[:, f:], norm_weight=nw)
    assert _err(out, ref) <= TOL[dtype]


def _tail_inputs(g, dtype, m, hq=1024, d=1024, f=2816):
    wi = _randn(g, d, 2 * f, scale=d ** -0.5).to(dtype)
    return (_randn(g, m, hq).to(dtype),
            _randn(g, hq, d, scale=hq ** -0.5).to(dtype),
            _randn(g, m, d).to(dtype), 1 + 0.1 * _randn(g, d),
            wi[:, :f], wi[:, f:], _randn(g, f, d, scale=f ** -0.5).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 4, 13, 16])
def test_mlp_tail_is_one_launch_equal_to_the_staged_kernels(cuda, dtype, m):
    args = _tail_inputs(torch.Generator(device=cuda).manual_seed(4), dtype, m)
    n_tail, n_mm, n_sw = (ff_layer_mlp_tail.launches,
                          ff_layer_matmul.launches, ff_layer_swiglu.launches)
    fused = ff_layer_mlp_tail(*args)
    assert (ff_layer_mlp_tail.launches, ff_layer_matmul.launches,
            ff_layer_swiglu.launches) == (n_tail + 1, n_mm, n_sw)
    staged = mlp_tail_staged(*args)
    torch.cuda.synchronize()
    assert torch.equal(fused, staged)
    assert _err(fused, ff_layer_mlp_tail_ref(*args)) <= TOL[dtype]


PIPES = [(d, st) for d in (1, 2, 4) for st in (1, 2)]


def _layer_calls(g, m, k=1024, n=1024, f=2816, hd=64,
                 dtype=torch.bfloat16):
    """The decode-layer kernels at m rows: the qproj (RMSNorm, q bias,
    RoPE), SwiGLU (RMSNorm) and the MLP tail, each as (call(**pipe),
    plain())."""
    bf = dtype
    x = _randn(g, m, k).to(bf)
    wq = _randn(g, k, n, scale=k ** -0.5).to(bf)
    q_kw = dict(norm_weight=1 + 0.1 * _randn(g, k),
                bias=_randn(g, n, scale=0.1).to(bf), rope_theta=1e6,
                head_dim=hd, positions=torch.randint(0, 4096, (m,),
                                                     generator=g,
                                                     device=g.device))
    wi = _randn(g, k, 2 * f, scale=k ** -0.5).to(bf)
    nw = 1 + 0.1 * _randn(g, k)
    tail = _tail_inputs(g, bf, m, n, k, f)
    return {
        "qproj": (lambda **p: ff_layer_matmul(x, wq, **q_kw, **p),
                  lambda: ff_layer_matmul_ref(x, wq, **q_kw)),
        "swiglu": (lambda **p: ff_layer_swiglu(x, wi[:, :f], wi[:, f:],
                                               norm_weight=nw, **p),
                   lambda: ff_layer_swiglu_ref(x, wi[:, :f], wi[:, f:],
                                               norm_weight=nw)),
        "tail": (lambda **p: ff_layer_mlp_tail(*tail, **p),
                 lambda: ff_layer_mlp_tail_ref(*tail)),
    }


# the f32 ring (one body with bf16): the bf16 grid, the deepest ring and
# the most sub-copies a stage
LAYER_PIPES = {torch.bfloat16: PIPES,
               torch.float32: PIPES + [(layer_ops.MAX_DEPTH, 1), (2, 8)]}
LAYER_KERNELS = ["qproj", "swiglu", "tail"]


@pytest.mark.parametrize(
    "kernel,dtype", [(k, torch.bfloat16) for k in LAYER_KERNELS]
    + [(k, torch.float32) for k in LAYER_KERNELS],
    ids=LAYER_KERNELS + [f"f32-{k}" for k in LAYER_KERNELS])
def test_bf16_layer_kernels_are_bitwise_across_depth_and_streams(cuda,
                                                                 kernel,
                                                                 dtype):
    """The serve shape (4 rows, d 1024, 16 heads of 64, f 2816), bf16 and
    f32: the weight ring's depth and streams change when rows land, not
    what is summed."""
    call, plain = _layer_calls(torch.Generator(device=cuda).manual_seed(21),
                               4, dtype=dtype)[kernel]
    base = call(depth=1, streams=1)
    for depth, streams in LAYER_PIPES[dtype]:
        assert torch.equal(call(depth=depth, streams=streams), base)
    assert _err(base, plain()) <= TOL[dtype]


TAIL_ROWS = [1, 4, 13, 16]


@pytest.mark.parametrize(
    "m,dtype", [(m, torch.bfloat16) for m in TAIL_ROWS]
    + [(m, torch.float32) for m in TAIL_ROWS],
    ids=[str(m) for m in TAIL_ROWS] + [f"f32-{m}" for m in TAIL_ROWS])
def test_bf16_mlp_tail_equals_staged_at_every_pipe(cuda, m, dtype):
    args = _tail_inputs(torch.Generator(device=cuda).manual_seed(22),
                        dtype, m)
    pipes = ((1, 1), (2, 1), (4, 2)) + (
        ((layer_ops.MAX_DEPTH, 8),) if dtype == torch.float32 else ())
    for depth, streams in pipes:
        fused = ff_layer_mlp_tail(*args, depth=depth, streams=streams)
        assert torch.equal(fused, mlp_tail_staged(*args, depth=depth,
                                                  streams=streams))


@pytest.mark.parametrize("kind", ["matmul", "swiglu"])
def test_f32_layer_at_qwen2_72b_down_k_matches_plain(cuda, kind):
    """k 29568 (qwen2-72b's down-projection): the f32 ring splits k into
    pieces of at most 2048 rows, no slabs; a SwiGLU at the same depth
    too. 64 + 5 output columns keep the weights small."""
    g = torch.Generator(device=cuda).manual_seed(26)
    f32 = torch.float32
    m, k, n = 4, 29568, 69
    a = _randn(g, m, k)
    b = _randn(g, k, 2 * n, scale=k ** -0.5)
    if kind == "matmul":
        res = _randn(g, m, n)
        out = ff_layer_matmul(a, b[:, :n], residual=res)
        ref = ff_layer_matmul_ref(a, b[:, :n], residual=res)
    else:
        nw = 1 + 0.1 * _randn(g, k)
        out = ff_layer_swiglu(a, b[:, :n], b[:, n:], norm_weight=nw)
        ref = ff_layer_swiglu_ref(a, b[:, :n], b[:, n:], norm_weight=nw)
    assert out.dtype == f32 and _err(out, ref) <= TOL[f32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(1000, 1024), (1024, 1000), (777, 100),
                                 (3000, 72)],
                         ids=["ragged_k", "ragged_n", "both", "split_93"])
def test_ff_layer_ragged_k_and_n_match_plain(cuda, dtype, k, n):
    """A k the split does not divide evenly, n not a multiple of the
    64-column tile (the ragged tile masked): every epilogue's columns and
    SwiGLU's, against the plain versions; the tail at the same widths."""
    g = torch.Generator(device=cuda).manual_seed(23)
    m = 5
    a = _randn(g, m, k).to(dtype)
    b = _randn(g, k, n, scale=k ** -0.5).to(dtype)
    nw = 1 + 0.1 * _randn(g, k)
    for kw in ({}, {"norm_weight": nw},
               {"residual": _randn(g, m, n).to(dtype)}):
        assert _err(ff_layer_matmul(a, b, **kw),
                    ff_layer_matmul_ref(a, b, **kw)) <= TOL[dtype]
    wi = _randn(g, k, 2 * n, scale=k ** -0.5).to(dtype)
    assert _err(ff_layer_swiglu(a, wi[:, :n], wi[:, n:], norm_weight=nw),
                ff_layer_swiglu_ref(a, wi[:, :n], wi[:, n:],
                                    norm_weight=nw)) <= TOL[dtype]
    tail = _tail_inputs(g, dtype, m, hq=k, d=n, f=k)
    fused = ff_layer_mlp_tail(*tail)
    assert torch.equal(fused, mlp_tail_staged(*tail))
    assert _err(fused, ff_layer_mlp_tail_ref(*tail)) <= TOL[dtype]


def test_bf16_layer_weights_of_any_row_stride(cuda):
    """Weights whose row stride is not a multiple of 16 bytes (and a base
    off 16 bytes) take the producer's element path into the same ring:
    the same bits as the contiguous copy, which takes cp.async."""
    g = torch.Generator(device=cuda).manual_seed(24)
    bf = torch.bfloat16
    m, k, n, f = 4, 1024, 1024, 2816
    x = _randn(g, m, k).to(bf)
    b = _randn(g, k, n + 3, scale=k ** -0.5).to(bf)[:, 1:n + 1]
    q_kw = dict(positions=torch.arange(m, device=cuda), rope_theta=1e6,
                head_dim=64)
    for kw in ({}, q_kw):
        assert torch.equal(ff_layer_matmul(x, b, **kw),
                           ff_layer_matmul(x, b.contiguous(), **kw))
    wi = _randn(g, k, 2 * f + 5, scale=k ** -0.5).to(bf)
    wg, wu = wi[:, 1:f + 1], wi[:, f + 1:2 * f + 1]
    assert torch.equal(ff_layer_swiglu(x, wg, wu),
                       ff_layer_swiglu(x, wg.contiguous(), wu.contiguous()))
    assert _err(ff_layer_swiglu(x, wg, wu),
                ff_layer_swiglu_ref(x, wg, wu)) <= TOL[bf]


def test_bf16_layer_tickets_leave_no_state(cuda):
    """The split reduction's tickets reset themselves: the same launch
    twice in a row, and after launches of other shapes, gives the same
    bits."""
    calls = _layer_calls(torch.Generator(device=cuda).manual_seed(25), 4)
    first = {name: call() for name, (call, _) in calls.items()}
    for _ in range(2):
        for name, (call, _) in calls.items():
            assert torch.equal(call(), first[name])
    torch.cuda.synchronize()


def test_ff_layer_refuses_a_pipe_the_reference_refuses(cuda):
    a = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
    for depth, streams in ((0, 1), (2, 0), (2, 3)):
        with pytest.raises(ValueError):
            ff_layer_matmul(a, b, depth=depth, streams=streams)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_layer_on_card_matches_plain(cuda, dtype):
    """Full-width qwen1.5-0.5B decode layer (16 heads of 64, d 1024, f
    2816), a cache of 48 rows at block 16, one inactive row."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, h, hd, d, f, s = 4, 16, 64, 1024, 2816, 48
    lengths = torch.tensor([14, 48, 0, 31], dtype=torch.int32, device=cuda)
    tail = _tail_inputs(g, dtype, b, h * hd, d, f)
    cache = _randn(g, b, s, 2 * h, hd).to(dtype)     # [B, S, KVH, hd] views
    args = (tail[2], 1 + 0.1 * _randn(g, d),
            _randn(g, d, h * hd, scale=d ** -0.5).to(dtype),
            _randn(g, h * hd, scale=0.1).to(dtype),
            (lengths - 1).clamp(min=0), cache[:, :, :h].transpose(1, 2),
            cache[:, :, h:].transpose(1, 2), lengths, tail[1], tail[3],
            tail[4], tail[5], tail[6])
    out = TL.decode_layer(*args, rope_theta=1e6, block_kv=16)
    ref = TL.decode_layer_ref(*args, rope_theta=1e6).float()
    tol = TOL[dtype]                         # relative and absolute
    assert ((out.float() - ref).abs() <= tol + tol * ref.abs()).all()


LIB_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _within(out, ref, tol):
    """|out - ref| <= tol + tol * |ref| everywhere (relative and absolute:
    an output of magnitude 4 or more has a bfloat16 step above 2e-2)."""
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= tol + tol * ref.abs()).all())


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("a_dtype,b_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=["f32_f32", "f32_bf16", "bf16_f32", "bf16_bf16"])
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (77, 133, 70),
                                   (1, 5, 3), (300, 1000, 1024)])
def test_matmul_matches_plain(cuda, a_dtype, b_dtype, out_dtype, m, n, k):
    g = torch.Generator(device=cuda).manual_seed(6)
    a = _randn(g, m, k).to(a_dtype)
    b = _randn(g, k, n, scale=k ** -0.5).to(b_dtype)
    n0 = matmul.launches
    out = matmul(a, b, out_dtype=out_dtype)
    assert matmul.launches == n0 + 1 and out.dtype == out_dtype
    # both sides get the same operand values and differ only in the order
    # of the f32 sums, so the output's type alone sets the tolerance
    assert _within(out, matmul_ref(a, b, out_dtype), LIB_TOL[out_dtype])


def test_matmul_takes_row_strided_operands(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    a = _randn(g, 40, 96)[:, 8:72]                   # row stride 96
    b = _randn(g, 64, 200, scale=0.125)[:, 3:131]    # row stride 200
    assert _within(matmul(a, b), matmul_ref(a, b), LIB_TOL[torch.float32])


@pytest.mark.parametrize("m,n,k", [(200, 257, 130), (64, 384, 2048)],
                         ids=["ragged", "split_k"])
def test_bf16_matmul_is_bitwise_across_depth_and_streams(cuda, m, n, k):
    """The ring's depth and streams change when a tile lands, not what is
    summed: the bf16 product and the gathered launch give the same bits
    at every (depth, streams)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    a = _randn(g, m, k).to(torch.bfloat16)
    b = _randn(g, k, n, scale=k ** -0.5).to(torch.bfloat16)
    idx = torch.randint(0, m, (m,), generator=g, device=cuda)
    base = matmul(a, b, depth=1, streams=1)
    base_g = dispatch_matmul(a, idx, b, depth=1, streams=1)
    for depth in (1, 2, 4):
        for streams in (1, 2):
            assert torch.equal(matmul(a, b, depth=depth, streams=streams),
                               base)
            assert torch.equal(dispatch_matmul(a, idx, b, depth=depth,
                                               streams=streams), base_g)
    assert _within(base, matmul_ref(a, b), LIB_TOL[torch.bfloat16])


def test_bf16_matmul_takes_unaligned_and_row_strided_operands(cuda):
    """Rows TMA cannot describe (k = 70: 140-byte rows; a row-strided A
    and B at odd element offsets) are copied into the same ring by the
    producer's element path."""
    g = torch.Generator(device=cuda).manual_seed(13)
    bf = torch.bfloat16
    a = _randn(g, 333, 70).to(bf)
    b = _randn(g, 70, 517, scale=70 ** -0.5).to(bf)
    assert _within(matmul(a, b), matmul_ref(a, b), LIB_TOL[bf])
    a = _randn(g, 150, 203).to(bf)[:, 3:195]          # row stride 203
    b = _randn(g, 192, 300, scale=0.07).to(bf)[:, 1:261]
    for out_dtype in DTYPES:
        assert _within(matmul(a, b, out_dtype=out_dtype),
                       matmul_ref(a, b, out_dtype), LIB_TOL[out_dtype])


def test_split_k_matmul_matches_plain(cuda):
    """Few output tiles: k is split over the SMs and the partials summed
    in split order; the gathered launch takes the same split."""
    from repro_torch.kernels.ff_matmul.ops import _plan, _sm_count
    g = torch.Generator(device=cuda).manual_seed(14)
    m, n, k = 64, 1408, 2048
    assert _plan(m, n, k, torch.bfloat16, torch.bfloat16,
                 _sm_count(0)).split > 1
    tokens = _randn(g, 512, k).to(torch.bfloat16)
    idx = torch.randint(0, 512, (m,), generator=g, device=cuda)
    w = _randn(g, k, n, scale=k ** -0.5).to(torch.bfloat16)
    a = gather(tokens, idx)
    for out_dtype in DTYPES:
        assert _within(matmul(a, w, out_dtype=out_dtype),
                       matmul_ref(a, w, out_dtype), LIB_TOL[out_dtype])
    assert torch.equal(dispatch_matmul(tokens, idx, w), matmul(a, w))


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("depth", [1, 2, 4, "max"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c", [(1, 128), (333, 64), (1000, 7), (64, 1024)])
def test_gather_is_an_exact_copy(cuda, dtype, n, c, depth, streams):
    """Repeated, unsorted indices; odd n; a row of 7 elements (copied in
    4- or 2-byte units) and rows of 16-byte multiples; at every ring depth
    up to the deepest that fits, one and two streams."""
    g = torch.Generator(device=cuda).manual_seed(8)
    table = _randn(g, 500, c).to(dtype)
    idx = torch.randint(0, 500, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    if depth == "max":
        depth = gather_max_depth(c, dtype, max(1, min(streams, n // 8)))
    n0 = gather.launches
    out = gather(table, idx, depth=depth, streams=streams)
    assert gather.launches == n0 + 1
    assert torch.equal(out, gather_ref(table, idx))


@pytest.mark.parametrize("depth", [4, "max"])
@pytest.mark.parametrize("c,dtype", [(2816, torch.float32),
                                     (30001, torch.float32),
                                     (70001, torch.bfloat16)])
def test_gather_rows_wider_than_a_slab_are_exact(cuda, c, dtype, depth):
    """Rows cut into slabs (the MoE combine's d_ff in f32, and odd widths
    copied in 4- or 2-byte units across the cuts), a ragged last word."""
    from repro_torch.kernels.ff_gather.ops import _plan
    g = torch.Generator(device=cuda).manual_seed(16)
    table = _randn(g, 40, c).to(dtype)
    idx = torch.randint(0, 40, (37,), generator=g, device=cuda,
                        dtype=torch.int32)
    if depth == "max":
        depth = gather_max_depth(c, dtype, 1)
    assert _plan(37, c, dtype, depth, 1, 132).slabs > 1
    n0 = gather.launches
    out = gather(table, idx, depth=depth)
    assert gather.launches == n0 + 1
    assert torch.equal(out, gather_ref(table, idx))


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c", [(6144, 64), (1 << 17, 64), (1 << 17, 7)])
def test_gather_words_of_many_short_rows_are_exact(cuda, dtype, n, c, depth):
    """Short rows take words of more than 8 rows (the staged paged
    baseline's 6,144 rows; past the 64 rows whose indices a producer
    holds in registers; 7-element rows in element units)."""
    from repro_torch.kernels.ff_gather.ops import _plan
    g = torch.Generator(device=cuda).manual_seed(24)
    table = _randn(g, 3000, c).to(dtype)
    idx = torch.randint(0, 3000, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    assert _plan(n, c, dtype, depth, 1, 132).rows > 8
    n0 = gather.launches
    out = gather(table, idx, depth=depth)
    assert gather.launches == n0 + 1
    assert torch.equal(out, gather_ref(table, idx))


def test_gather_of_no_rows_launches_nothing(cuda):
    table = torch.ones(10, 64, device=cuda)
    n0 = gather.launches
    out = gather(table, torch.zeros(0, dtype=torch.int32, device=cuda),
                 depth=2, streams=2)
    assert out.shape == (0, 64) and out.device.type == "cuda"
    assert gather.launches == n0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,f", [(40, 96, 77), (24, 70, 130)])
def test_dispatch_matmul_equals_gather_then_matmul(cuda, dtype, n, d, f):
    g = torch.Generator(device=cuda).manual_seed(9)
    tokens = _randn(g, 512, d).to(dtype)
    idx = torch.randint(0, 512, (n,), generator=g, device=cuda)
    w = _randn(g, d, f, scale=d ** -0.5).to(dtype)
    n0, m0, g0 = (dispatch_matmul.launches, matmul.launches,
                  gather.launches)
    fused = dispatch_matmul(tokens, idx, w)
    assert (dispatch_matmul.launches, matmul.launches,
            gather.launches) == (n0 + 1, m0, g0)
    assert torch.equal(fused, matmul(gather(tokens, idx), w))
    assert _within(fused, dispatch_matmul_ref(tokens, idx, w),
                   LIB_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,s,d,d_out,causal", [
    (3, 100, 64, 96, True), (4, 45, 32, 64, False), (2, 128, 64, 256, True),
    (3, 70, 80, 130, True)])
def test_attention_proj_equals_staged_launches(cuda, dtype, bh, s, d, d_out,
                                               causal):
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (_randn(g, bh, s, d).to(dtype) for _ in range(3))
    w = _randn(g, d, d_out, scale=d ** -0.5).to(dtype)
    n0, a0, m0 = (attention_proj.launches, attention.launches,
                  matmul.launches)
    fused = attention_proj(q, k, v, w, causal=causal)
    assert (attention_proj.launches, attention.launches,
            matmul.launches) == (n0 + 1, a0, m0)
    staged = matmul(attention(q, k, v, causal=causal).reshape(bh * s, d), w)
    torch.cuda.synchronize()
    assert torch.equal(fused, staged)
    assert _within(fused, attention_proj_ref(q, k, v, w, causal=causal),
                   LIB_TOL[dtype])


def test_attention_proj_is_bitwise_across_depth_and_streams(cuda):
    """The projection's words of w ride the attention's ring: the fused
    launch gives the same bits at every (depth, streams), equal to the
    staged launches."""
    g = torch.Generator(device=cuda).manual_seed(19)
    bf = torch.bfloat16
    q, k, v = (_randn(g, 4, 200, 64).to(bf) for _ in range(3))
    w = _randn(g, 64, 300, scale=0.125).to(bf)
    staged = matmul(attention(q, k, v).reshape(800, 64), w)
    for depth in (1, 2, 4):
        for streams in (1, 2):
            assert torch.equal(attention_proj(q, k, v, w, depth=depth,
                                              streams=streams), staged)


F32_PIPES = [(d, st) for d in (1, 2, 4) for st in (1, 2, 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 20, 64, 80, 128, 256])
def test_f32_attention_is_bitwise_across_depth_and_streams(cuda, d, causal):
    """The f32 body on its ring (K/V tiles of 32 rows): the same bits at
    every depth that fits the head dim x streams {1, 2, 4}, GQA 2, ragged
    S, within 2e-4 of the plain version; d = 20 takes element copies (an
    80-byte row TMA cannot stride)."""
    from repro_torch.kernels.ff_attention import max_depth
    g = torch.Generator(device=cuda).manual_seed(30)
    q = _randn(g, 6, 150, d)
    k, v = _randn(g, 3, 150, d), _randn(g, 3, 150, d)
    base = attention(q, k, v, kv_groups=2, causal=causal, depth=1,
                     streams=1)
    deepest = max_depth(d, torch.float32)
    for depth, streams in F32_PIPES + [(deepest, 2)]:
        if depth <= deepest:
            assert torch.equal(attention(q, k, v, kv_groups=2, causal=causal,
                                         depth=depth, streams=streams), base)
    assert _err(base, attention_ref(q, k, v, kv_groups=2,
                                    causal=causal)) <= TOL[torch.float32]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("a_dtype,b_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32_f32", "f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("case", ["ragged", "row_strided"])
def test_f32_and_mixed_matmul_is_bitwise_across_depth_and_streams(
        cuda, a_dtype, b_dtype, out_dtype, case):
    """The CUDA-core product on its ring: the same bits at every (depth,
    streams), at a shape ragged against the 128 x 128 tile and the 32-deep
    slab (TMA boxes, zeros past the edges) and at row-strided operands
    that TMA cannot describe (element loads), within 5e-4 of the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(31)
    if case == "ragged":
        a = _randn(g, 200, 136).to(a_dtype)
        b = _randn(g, 136, 264, scale=136 ** -0.5).to(b_dtype)
    else:
        a = _randn(g, 150, 203).to(a_dtype)[:, 3:195]
        b = _randn(g, 192, 301, scale=0.07).to(b_dtype)[:, 1:261]
    base = matmul(a, b, out_dtype=out_dtype, depth=1, streams=1)
    for depth, streams in F32_PIPES + [(9 if a_dtype != b_dtype else 7, 16)]:
        assert torch.equal(matmul(a, b, out_dtype=out_dtype, depth=depth,
                                  streams=streams), base)
    assert _within(base, matmul_ref(a, b, out_dtype), LIB_TOL[out_dtype])


@pytest.mark.parametrize("n,d,f", [(64, 2048, 1408), (40, 96, 77),
                                   (24, 70, 130)])
def test_gathered_f32_matmul_equals_gather_then_matmul(cuda, n, d, f):
    """The gathered f32 launch (per-row cp.async, or element loads where a
    row of 70 floats is not 16-byte strided) equals gather then matmul bit
    for bit at every (depth, streams)."""
    g = torch.Generator(device=cuda).manual_seed(32)
    tokens = _randn(g, 512, d)
    idx = torch.randint(0, 512, (n,), generator=g, device=cuda)
    w = _randn(g, d, f, scale=d ** -0.5)
    staged = matmul(gather(tokens, idx), w)
    for depth, streams in F32_PIPES:
        assert torch.equal(dispatch_matmul(tokens, idx, w, depth=depth,
                                           streams=streams), staged)
    assert _within(staged, dispatch_matmul_ref(tokens, idx, w),
                   LIB_TOL[torch.float32])


@pytest.mark.parametrize("bh,s,d,d_out,causal", [
    (4, 200, 64, 300, True), (3, 70, 80, 130, True), (4, 45, 32, 64, False),
    (2, 64, 256, 96, True)])
def test_f32_attention_proj_equals_staged_at_every_pipe(cuda, bh, s, d,
                                                        d_out, causal):
    """The f32 fused launch runs the prefill kernel's f32 body on its ring,
    then the product: equal to attention then matmul bit for bit at every
    (depth, streams) that fits the head dim."""
    from repro_torch.kernels.ff_attention import max_depth
    g = torch.Generator(device=cuda).manual_seed(33)
    q, k, v = (_randn(g, bh, s, d) for _ in range(3))
    w = _randn(g, d, d_out, scale=d ** -0.5)
    staged = matmul(attention(q, k, v, causal=causal).reshape(bh * s, d), w)
    for depth, streams in F32_PIPES:
        if depth <= max_depth(d, torch.float32):
            assert torch.equal(attention_proj(q, k, v, w, causal=causal,
                                              depth=depth, streams=streams),
                               staged)
    assert _within(staged, attention_proj_ref(q, k, v, w, causal=causal),
                   LIB_TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_entry_points_on_card(cuda, dtype):
    """attention_proj and moe_dispatch_ffn equal their unfused
    compositions bit for bit, and are within tolerance of the plain
    versions; the MoE entry keeps the reference's multiple-of-8 rule."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_randn(g, 4, 96, 64, scale=0.5).to(dtype) for _ in range(3))
    w = _randn(g, 64, 256, scale=0.125).to(dtype)
    out = TL.attention_proj(q, k, v, w)
    assert torch.equal(out, TL._attention_proj_unfused(q, k, v, w))
    assert _within(out, attention_proj_ref(q, k, v, w), LIB_TOL[dtype])
    tokens = _randn(g, 96, 128).to(dtype)
    idx = torch.randint(0, 96, (64,), generator=g, device=cuda)
    w1 = _randn(g, 128, 256, scale=128 ** -0.5).to(dtype)
    comb = torch.randint(0, 64, (40,), generator=g, device=cuda)
    out = TM.moe_dispatch_ffn(idx, tokens, w1, comb)
    assert torch.equal(out, TM._moe_graph_unfused(idx, tokens, w1, comb))
    assert _within(out, TM.moe_dispatch_ffn_ref(idx, tokens, w1, comb),
                   LIB_TOL[dtype])
    with pytest.raises(ValueError):
        TM.moe_dispatch_ffn(idx[:60], tokens, w1, comb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_paged_decode_equals_fused(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(12)
    nb, page, kvh, d, b, h, npg = 20, 16, 2, 64, 3, 4, 5
    pool = _randn(g, nb, 2, page, kvh, d).to(dtype)
    tables = torch.randperm(nb, generator=g, device=cuda)[:b * npg]
    tables = tables.view(b, npg).int()
    tables[2] = nb                                  # inactive slot
    lens = torch.tensor([37, npg * page, 0], dtype=torch.int32, device=cuda)
    q = _randn(g, b, h, d).to(dtype)
    idx = paged_kv.gather_indices(tables, page=page, kv_heads=kvh,
                                  n_blocks=nb)
    staged = paged_kv.paged_decode_unfused(q, pool, idx, lens)
    fused = paged_kv.paged_decode_attention(q, pool, tables, lens)
    assert torch.equal(staged, fused)


def _scan_inputs(g, bh, s, n, p, exclusive):
    q = _randn(g, bh, s, n, scale=0.5)
    k = _randn(g, bh, s, n, scale=0.5)
    v = _randn(g, bh, s, p)
    lw = -0.5 * torch.exp(_randn(g, bh, s, n))
    u = _randn(g, bh, n, scale=0.3) if exclusive else None
    return q, k, v, lw, u


def _scan_err(out, plain):
    return _err(out, plain) / (plain.float().abs().max().item() + 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("exclusive", [False, True],
                         ids=["inclusive", "exclusive_u"])
@pytest.mark.parametrize("bh,s,n,p,chunk", [
    (3, 200, 64, 64, 64), (2, 77, 16, 32, 32), (2, 300, 64, 64, 128),
    (1, 64, 16, 16, 16), (2, 600, 64, 64, 256), (2, 200, 128, 128, 128),
    (2, 300, 128, 128, 256), (2, 300, 256, 256, 256), (2, 70, 17, 20, 32),
    (2, 150, 320, 64, 64), (1, 200, 512, 64, 128)])
def test_chunk_scan_kernel_matches_plain(cuda, dtype, exclusive, bh, s, n, p,
                                         chunk):
    """float32 within 3e-5 of max |plain| (the reference kernel test's
    bound), bfloat16 streams within 2e-2 of it. N = P = 256 runs the f32
    ring body in both types; N = 17, P = 20 its element copies (rows not
    16-byte aligned); N = 320 and 512 its 16 state rows a thread (five and
    eight consumer warps, one stage at N = 512)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, lw, u = _scan_inputs(g, bh, s, n, p, exclusive)
    q, k, v, lw = (x.to(dtype) for x in (q, k, v, lw))
    n0 = chunk_scan.launches
    out = chunk_scan(q, k, v, lw, u, inclusive=not exclusive, chunk=chunk)
    assert chunk_scan.launches == n0 + 1
    plain = chunk_scan_plain(q, k, v, lw, u, inclusive=not exclusive,
                             chunk=chunk)
    assert out.dtype == dtype and out.shape == (bh, s, p)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    assert _scan_err(out, plain) < tol
    if dtype == torch.float32:
        ref = chunk_scan_ref(q, k, v, lw, u, inclusive=not exclusive)
        assert _scan_err(out, ref) < tol


@pytest.mark.parametrize("exclusive", [False, True],
                         ids=["mamba2_types", "rwkv6_types"])
def test_chunk_scan_takes_a_type_per_stream(cuda, exclusive):
    """Mamba2: bf16 q/k/v, f32 log_w, q and k shared by the 4 heads of a
    row and log_w one value per head and step (expanded views); RWKV6:
    bf16 q/k/v/log_w, f32 u."""
    g = torch.Generator(device=cuda).manual_seed(14)
    bf = torch.bfloat16
    q, k, v, lw, u = _scan_inputs(g, 8, 130, 64, 64, exclusive)
    q, k, v = q.to(bf), k.to(bf), v.to(bf)
    if exclusive:
        lw = lw.to(bf)
    else:
        q, k = (x[:2, None].expand(2, 4, 130, 64).reshape(8, 130, 64)
                for x in (q, k))
        lw = lw[:, :, :1].expand(8, 130, 64)
    out = chunk_scan(q, k, v, lw, u, inclusive=not exclusive)
    plain = chunk_scan_plain(q, k, v, lw, u, inclusive=not exclusive)
    assert _scan_err(out, plain) < 2e-2


@pytest.mark.parametrize("exclusive", [False, True],
                         ids=["mamba2_types", "rwkv6_types"])
def test_chunk_scan_runs_at_chunk_256(cuda, exclusive):
    """The largest chunk the reference's autotuner tries, at N = P = 64 on
    both models' stream types (as test_chunk_scan_takes_a_type_per_stream),
    S = 300 (a ragged second chunk): within 2e-2 of max |plain|."""
    g = torch.Generator(device=cuda).manual_seed(20)
    bf = torch.bfloat16
    q, k, v, lw, u = _scan_inputs(g, 8, 300, 64, 64, exclusive)
    q, k, v = q.to(bf), k.to(bf), v.to(bf)
    if exclusive:
        lw = lw.to(bf)
    else:
        q, k = (x[:2, None].expand(2, 4, 300, 64).reshape(8, 300, 64)
                for x in (q, k))
        lw = lw[:, :, :1].expand(8, 300, 64)
    kw = dict(inclusive=not exclusive, chunk=256)
    out = chunk_scan(q, k, v, lw, u, **kw)
    assert _scan_err(out, chunk_scan_plain(q, k, v, lw, u, **kw)) < 2e-2


def test_chunk_scan_strong_decay_stays_finite(cuda):
    """lw = -3: a chunk decays by e^-192; every exponent stays <= 0."""
    ones = torch.ones(2, 256, 64, device=cuda)
    lw = torch.full((2, 256, 64), -3.0, device=cuda)
    for exclusive in (False, True):
        u = torch.ones(2, 64, device=cuda) if exclusive else None
        out = chunk_scan(ones, ones, ones, lw, u, inclusive=not exclusive)
        assert out.isfinite().all()
        ref = chunk_scan_ref(ones, ones, ones, lw, u,
                             inclusive=not exclusive)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def test_chunk_scan_refuses_what_does_not_fit(cuda):
    """f32 N = 1024: not one 16-row stage of the f32 ring body fits in a
    block's shared memory with its derived tiles (``f32_max_depth`` is
    0); and a bf16 ring deeper than ``max_depth``.
    (N = P = 128 and 256 at chunk 256 run: the f32 ring body at up to 3
    stages, test_chunk_scan_kernel_matches_plain and chip_smoke.py.)"""
    x = torch.zeros(1, 256, 1024, device=cuda)
    v = torch.zeros(1, 256, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        chunk_scan(x, x, v, x, chunk=256)
    b = torch.zeros(1, 256, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        chunk_scan(b, b, b, b, depth=max_depth(64, 64, b.dtype) + 1)
    with pytest.raises(ValueError):                  # mixed devices
        chunk_scan(x, x.cpu(), x, x)


@pytest.mark.parametrize("case", [
    (False, "bf16", 64), (True, "bf16", 64), (False, "f32", 64),
    (True, "f32", 64), (True, "f32", 256), (True, "f32", 512)],
    ids=["mamba2_types", "rwkv6_types", "f32_inclusive", "f32_exclusive_u",
         "f32_n_p_256", "f32_n_p_512"])
def test_chunk_scan_is_bitwise_across_depth_and_streams(cuda, case):
    """The bf16 ring body at both models' stream types and N = P = 64 over
    four 64-row chunks, and the f32 ring body at N = P = 64, 256 and 512
    (chunk 256; depth {1, 2, 4} up to its f32_max_depth and the deepest;
    N = 512 takes one stage, 16 state rows a thread): the ring's depth and
    streams change when a word lands, not what is computed."""
    exclusive, types, n = case
    g = torch.Generator(device=cuda).manual_seed(21)
    bf = torch.bfloat16
    q, k, v, lw, u = _scan_inputs(g, 8 if n == 64 else 4, 256, n, n,
                                  exclusive)
    if types == "bf16":
        q, k, v = q.to(bf), k.to(bf), v.to(bf)
        lw = lw.to(bf) if exclusive else lw
        depths = (1, 2, 4)
    else:
        deepest = f32_max_depth(n, n)
        depths = sorted({d for d in (1, 2, 4) if d <= deepest} | {deepest})
    kw = dict(inclusive=not exclusive, chunk=64 if n == 64 else 256)
    want = chunk_scan(q, k, v, lw, u, **kw)
    for depth in depths:
        for streams in (1, 2):
            got = chunk_scan(q, k, v, lw, u, depth=depth, streams=streams,
                             **kw)
            assert torch.equal(got, want), (depth, streams)


def test_chunk_scan_bf16_streams_at_the_widest_n(cuda):
    """N = 784 in bf16 streams: the widest N the f32 ring body takes (one
    stage; 13 consumer warps of 64 state rows, the most its launch bound
    allows), within 2e-2 of max |plain|; one more state row is refused."""
    g = torch.Generator(device=cuda).manual_seed(24)
    bf = torch.bfloat16
    assert f32_max_depth(784, 32, (bf,) * 4) == 1
    assert f32_max_depth(785, 32, (bf,) * 4) == 0
    for exclusive in (False, True):
        q, k, v, lw, u = _scan_inputs(g, 1, 80, 784, 32, exclusive)
        q, k, v, lw = (x.to(bf) for x in (q, k, v, lw))
        kw = dict(inclusive=not exclusive, chunk=16)
        out = chunk_scan(q, k, v, lw, u, **kw)
        assert _scan_err(out, chunk_scan_plain(q, k, v, lw, u, **kw)) < 2e-2


def _scan_f64(q, k, v, lw, u, inclusive):
    """The naive scan in float64: the exact result to f32's eyes."""
    q, k, v, lw = q.double(), k.double(), v.double(), lw.double()
    lw = torch.clamp(lw, max=0.0)
    h = torch.zeros(q.shape[0], q.shape[2], v.shape[2], dtype=torch.float64,
                    device=q.device)
    ys = []
    for t in range(q.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        h_new = torch.exp(lw[:, t])[:, :, None] * h + kv
        eff = h_new if inclusive else h + u.double()[:, :, None] * kv
        ys.append(torch.einsum("bn,bnp->bp", q[:, t], eff))
        h = h_new
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("lw", [-1e-3, -1e-4], ids=["lw_1e-3", "lw_1e-4"])
@pytest.mark.parametrize("exclusive", [False, True],
                         ids=["inclusive", "exclusive_u"])
def test_chunk_scan_f32_does_not_drift_over_a_long_row(cuda, lw, exclusive):
    """S = 4096 with one decay near 1 in every row and channel: the f32
    ring body's per-row decays are rounded ex2's, and carried from block to
    block their error would grow with the rows the state remembers; each
    word's correction keeps the carried decay exact. Within 3e-5 of the
    float64 scan, and no further from it than chunk_scan_ref: the f32
    naive scan is no yardstick at 3e-5 here, as the rounding of its
    per-row exp compounds the same way (on the H100 it lies about as far
    off the float64 scan as the tolerance at lw = -1e-3, further at
    -1e-4)."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, _, u = _scan_inputs(g, 2, 4096, 64, 64, exclusive)
    log_w = torch.full_like(q, lw)
    out = chunk_scan(q, k, v, log_w, u, inclusive=not exclusive)
    exact = _scan_f64(q, k, v, log_w, u, not exclusive)
    assert _scan_err(out, exact) < 3e-5
    ref = chunk_scan_ref(q, k, v, log_w, u, inclusive=not exclusive)
    assert _scan_err(out, exact) <= _scan_err(ref, exact)


def test_chunk_scan_f32_clocks_time_the_passes(cuda):
    """The f32 ring body with its clock counters: the same bits as
    without, and for every block positive cycles in passes AB, C1 and C2
    (thread 0's clock64 deltas; the measurement chip_smoke.py reports)."""
    from repro_torch.kernels.ff_chunk_scan import ops as SO
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, lw, u = _scan_inputs(g, 4, 96, 64, 64, True)
    want = SO._launch(q, k, v, lw, u, 64, 16, False, 2, 1)
    blocks = SO._f32_plan(4, 64).blocks
    clocks = torch.zeros(blocks, 4, dtype=torch.int64, device=cuda)
    got = SO._launch(q, k, v, lw, u, 64, 16, False, 2, 1, clocks=clocks)
    assert torch.equal(got, want)
    assert (clocks[:, 1:] > 0).all()


def test_chunk_scan_checks_depth_and_streams(cuda):
    x = torch.zeros(1, 64, 16, device=cuda, dtype=torch.bfloat16)
    for bad in (dict(depth=0), dict(streams=0), dict(streams=3)):
        with pytest.raises(ValueError):
            chunk_scan(x, x, x, x, **bad)


# ---------------------------------------------------------------------------
# the compiled step: CUDA graphs of the serve steps
# ---------------------------------------------------------------------------


def _serve_smoke(cuda, layer_graph=False):
    """The smoke qwen in bf16 (KV tile 8, the page), weights cast once, and
    two prompts (lengths 5 and 19) prefilled eagerly."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = smoke_config("qwen1_5_0p5b").replace(
        compute_dtype="bfloat16", decode_block_kv=8, layer_graph=layer_graph)
    model = build_model(cfg)
    params = model.cast_params(
        model.init(torch.Generator(device=cuda).manual_seed(0), cuda))
    lens = torch.tensor([5, 19], dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab, (2, 19), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    _, dense = steps.make_prefill_step(model, compiled=False)(
        params, {"tokens": toks.to(cuda)})
    first = {"token": toks[torch.arange(2), lens - 1].to(cuda),
             "lengths": (lens - 1).to(cuda)}
    return cfg, model, params, dense, first


def _paged(cfg, cuda, dense, lens=(5, 19), slots=3):
    kv = paged_kv.PagedKVCache(n_layers=cfg.n_layers, n_blocks=10, page=8,
                               kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                               n_slots=slots, n_pages_max=3,
                               dtype=cfg.cdtype, device=cuda)
    for i, n in enumerate(lens):
        kv.admit(i, dense["k"][:, i], dense["v"][:, i], n, 24)
    return kv


def _cache(kind, cfg, cuda, dense):
    from repro_torch.launch import serve
    if kind == "paged":
        return _paged(cfg, cuda, dense).cache_view()
    return serve.pad_cache_to(dense, 19, 24, 2)


def _batch(first, kind):
    if kind != "paged":
        return dict(first)
    return {"token": torch.cat([first["token"], first["token"][:1] * 0]),
            "lengths": torch.cat([first["lengths"],
                                  first["lengths"][:1] * 0])}


def _leaves(tree):
    from repro_torch.launch.steps import _flatten
    out = []
    _flatten(tree, out)
    return out


@pytest.mark.parametrize("kind", ["dense", "paged", "layer-graph"])
def test_replayed_decode_step_equals_eager_bitwise(cuda, kind):
    from repro_torch.launch import steps
    cfg, model, params, dense, first = _serve_smoke(
        cuda, layer_graph=kind == "layer-graph")
    outs = {}
    for compiled in (True, False):
        decode = steps.make_decode_step(model, compiled=compiled)
        b, cache, seen = _batch(first, kind), _cache(kind, cfg, cuda,
                                                     dense), []
        for _ in range(3):
            nxt, lg, cache = decode(params, b, cache)
            seen.append([t.clone() for t in _leaves((nxt, lg, cache))])
            b = {"token": nxt,
                 "lengths": b["lengths"] + (b["lengths"] > 0).int()}
        outs[compiled] = seen
    assert len(steps.make_decode_step(model).graphs) == 1
    for got, want in zip(outs[True], outs[False]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_replay_after_admit_and_retire_reads_the_new_table(cuda):
    """Slot 0 retires and a new request takes slot 2 between replays: the
    graph reads the table buffer the cache rewrote, as the eager step
    reads it."""
    from repro_torch.launch import steps
    cfg, model, params, dense, first = _serve_smoke(cuda)
    logits = {}
    for compiled in (True, False):
        decode = steps.make_decode_step(model, compiled=compiled)
        kv = _paged(cfg, cuda, dense)
        b = _batch(first, "paged")
        seen = []
        for i in range(4):
            if i == 2:
                kv.retire(0)
                kv.admit(2, dense["k"][:, 1], dense["v"][:, 1], 19, 24)
                # slot 2 re-feeds prompt 1's last token at its position,
                # as slot 1 did at step 0
                b = {"token": torch.stack([b["token"][0] * 0,
                                           b["token"][1],
                                           first["token"][1]]),
                     "lengths": torch.stack([b["lengths"][0] * 0,
                                             b["lengths"][1],
                                             first["lengths"][1]])}
            nxt, lg, cache = decode(params, b, kv.cache_view())
            kv.update(cache)
            seen.append(lg.clone())
            b = {"token": nxt,
                 "lengths": b["lengths"] + (b["lengths"] > 0).int()}
        logits[compiled] = seen
    for got, want in zip(logits[True], logits[False]):
        assert torch.equal(got, want)
    # slot 2 now decodes prompt 1 through its new blocks: its row equals
    # slot 1's at step 0
    assert torch.equal(logits[True][2][2], logits[True][0][1])


def test_launch_counters_count_replays(cuda):
    from repro_torch.kernels import launch_counters
    from repro_torch.launch import steps
    cfg, model, params, dense, first = _serve_smoke(cuda)
    decode = steps.make_decode_step(model)
    eager = steps.make_decode_step(model, compiled=False)
    cache = _cache("dense", cfg, cuda, dense)
    decode(params, dict(first), cache)                # capture
    counters = launch_counters()

    def counts(fn, n):
        for w in counters:
            w.launches = 0
        for _ in range(n):
            fn()
        return {w.__name__: w.launches for w in counters if w.launches}

    one = counts(lambda: eager(params, dict(first),
                               _cache("dense", cfg, cuda, dense)), 1)
    assert one.get("decode_attention") == cfg.n_layers
    three = counts(lambda: decode(params, dict(first), cache), 3)
    assert three == {name: 3 * n for name, n in one.items()}


def test_a_later_graphs_outputs_survive_an_earlier_graphs_replay(cuda):
    """The graphs share one pool, where a later capture may take an earlier
    graph's intermediates: the outputs live in buffers of their own, so
    the paged step's next token survives the dense step's replay (the
    parity probe's order)."""
    from repro_torch.launch import steps
    cfg, model, params, dense, first = _serve_smoke(cuda)
    decode = steps.make_decode_step(model)
    dense_cache = _cache("dense", cfg, cuda, dense)
    decode(params, dict(first), dense_cache)          # captured first
    b = _batch(first, "paged")
    nxt, lg, _ = decode(params, b, _cache("paged", cfg, cuda, dense))
    kept = (nxt.clone(), lg.clone())
    decode(params, dict(first), dense_cache)          # the earlier graph
    torch.cuda.synchronize()
    assert torch.equal(nxt, kept[0]) and torch.equal(lg, kept[1])


# ---------------------------------------------------------------------------
# AdamW (kernels/adamw): the hand-fused update against its plain version
# ---------------------------------------------------------------------------

# chip_smoke.py's ADAMW_TOL: the kernel sums the norm in double in another
# order than the plain version's f32 sums, so a clipped step's scale moves
# by their rounding
ADAMW_TOL = 1e-5
ADAMW_SHAPES = {"ragged": [(4097,), (5,), (1,), (3, 4115), (64, 64)],
                "groups": [(7 * i + 1,) for i in range(70)]}


def _adamw_operands(cuda, shapes, p_dtype, g_dtype, grad_scale, offset=0):
    """Params (``offset`` elements into a larger buffer: unaligned when
    odd), gradients at ``grad_scale``, random moments at step 4."""
    from repro_torch.optim import adamw
    gen = torch.Generator(device=cuda).manual_seed(len(shapes))

    def rn(shape, dtype, scale=1.0):
        n = 1
        for s in shape:
            n *= s
        buf = torch.empty(n + offset, dtype=dtype, device=cuda)
        out = buf[offset:].view(shape)
        out.copy_(torch.randn(shape, generator=gen, device=cuda) * scale)
        return out
    params = {f"l{i:03d}": rn(s, p_dtype) for i, s in enumerate(shapes)}
    grads = {k: rn(p.shape, g_dtype, grad_scale) for k, p in params.items()}
    state = adamw.init(params)
    for m in state["m"].values():
        m.normal_(generator=gen).mul_(grad_scale)
    for v in state["v"].values():
        v.uniform_(generator=gen).mul_(grad_scale ** 2)
    state["step"].fill_(4)
    return params, grads, state


def _adamw_pair(cuda, shapes, p_dtype, g_dtype, grad_scale, offset=0):
    """(kernel's, plain's) (params, state, metrics) after one update of
    the same operands, and the kernel's launches."""
    from repro_torch.kernels.adamw import adamw_ref, adamw_update
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=30)
    p, g, s = _adamw_operands(cuda, shapes, p_dtype, g_dtype, grad_scale,
                              offset)
    p2 = {k: v.clone() for k, v in p.items()}
    s2 = {"m": {k: v.clone() for k, v in s["m"].items()},
          "v": {k: v.clone() for k, v in s["v"].items()},
          "step": s["step"].clone()}
    adamw_update.launches = 0
    _, _, mk = adamw_update(cfg, g, s, p)
    _, _, mp = adamw_ref(cfg, g, s2, p2)
    torch.cuda.synchronize()
    return (p, s, mk), (p2, s2, mp), adamw_update.launches


def _adamw_rel(got, want):
    scale = max(w.float().abs().max().item() for w in want.values())
    return max(_err(got[k], want[k]) for k in want) / scale


@pytest.mark.parametrize("shapes", sorted(ADAMW_SHAPES))
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_adamw_kernel_matches_plain(cuda, shapes, p_dtype, g_dtype, offset):
    (p, s, mk), (p2, s2, mp), launches = _adamw_pair(
        cuda, ADAMW_SHAPES[shapes], p_dtype, g_dtype, 1.0, offset)
    assert mk["grad_norm"].item() > 1.0          # the step clips
    assert launches == 2 * (2 if shapes == "groups" else 1)
    assert int(s["step"]) == int(s2["step"]) == 5
    # a bf16 parameter rounds its update: one ulp of it at most
    p_tol = ADAMW_TOL if p_dtype == torch.float32 else 2 ** -7
    assert _adamw_rel(p, p2) <= p_tol
    assert _adamw_rel(s["m"], s2["m"]) <= ADAMW_TOL
    assert _adamw_rel(s["v"], s2["v"]) <= ADAMW_TOL
    for k in ("grad_norm", "lr"):
        assert abs(mk[k].item() - mp[k].item()) <= \
            ADAMW_TOL * abs(mp[k].item()), k


def test_adamw_unclipped_update_is_the_plain_versions_bit_for_bit(cuda):
    """With the norm under ``clip_norm`` both scales are 1 exactly, and the
    kernel's update, each operation rounded as PyTorch rounds it, equals
    the plain version's bit for bit."""
    (p, s, mk), (p2, s2, mp), _ = _adamw_pair(
        cuda, ADAMW_SHAPES["ragged"], torch.float32, torch.float32, 1e-4)
    assert mk["grad_norm"].item() < 1.0
    assert mk["lr"].item() == mp["lr"].item()
    for k in p2:
        assert torch.equal(p[k], p2[k]), k
        assert torch.equal(s["m"][k], s2["m"][k]), k
        assert torch.equal(s["v"][k], s2["v"][k]), k


def test_adamw_kernel_on_a_one_rank_mesh_equals_it_on_plain_tensors(
        cuda, tmp_path):
    """DTensor operands on a (1, 1) mesh (one gloo rank): the kernel runs
    on the local shards, writes through to the DTensors, and its
    zero-padded partial sums give the plain tensors' update bit for bit
    (a clipped step)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.adamw import adamw_update
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=30)
    p, g, s = _adamw_operands(cuda, ADAMW_SHAPES["ragged"], torch.float32,
                              torch.float32, 1.0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))

        def placed(t, k):
            pl = [Replicate(), Shard(0) if k.endswith("0") else Replicate()]
            return distribute_tensor(t.clone(), mesh, pl)
        pd = {k: placed(v, k) for k, v in p.items()}
        gd = {k: placed(v, k) for k, v in g.items()}
        sd = {"m": {k: placed(v, k) for k, v in s["m"].items()},
              "v": {k: placed(v, k) for k, v in s["v"].items()},
              "step": s["step"].clone()}
        adamw_update.launches = 0
        _, _, md = adamw_update(cfg, gd, sd, pd)
        assert adamw_update.launches == 2
        _, _, mp = adamw_update(cfg, g, s, p)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert md["grad_norm"].item() > 1.0 and int(sd["step"]) == 5
    assert md["grad_norm"].item() == mp["grad_norm"].item()
    for k in p:
        assert torch.equal(pd[k].to_local(), p[k]), k
        assert torch.equal(sd["m"][k].to_local(), s["m"][k]), k
        assert torch.equal(sd["v"][k].to_local(), s["v"][k]), k


def test_adamw_kernel_is_captured_and_replayed_bit_for_bit(cuda):
    """Both launches captured in a CUDA graph: three replays equal three
    eager updates bit for bit (the norm's sums in a fixed order)."""
    from repro_torch.kernels.adamw import adamw_update
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    shapes = ADAMW_SHAPES["ragged"]
    p, g, s = _adamw_operands(cuda, shapes, torch.float32, torch.float32,
                              1.0)
    p2, g2, s2 = _adamw_operands(cuda, shapes, torch.float32, torch.float32,
                                 1.0)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        adamw_update(cfg, g, s, p)                 # warm-up: update 1
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = adamw_update(cfg, g, s, p)[2]
    eager = [adamw_update(cfg, g2, s2, p2)[2]["grad_norm"].item()]
    replayed = []
    for _ in range(3):
        graph.replay()
        replayed.append(out["grad_norm"].item())
        eager.append(adamw_update(cfg, g2, s2, p2)[2]["grad_norm"].item())
    torch.cuda.synchronize()
    assert int(s["step"]) == int(s2["step"]) == 4 + 4
    assert replayed == eager[1:]
    for k in p2:
        assert torch.equal(p[k], p2[k]), k
        assert torch.equal(s["v"][k], s2["v"][k]), k
