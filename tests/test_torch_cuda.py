"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a: H100/H200); elsewhere each
test skips, decided inside the ``cuda`` fixture, never at import. Run them
on the card with (``--noconftest``: the tests' conftest imports JAX, which
the card's machine need not have):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: float32 2e-4 (the reference registry's), bfloat16 2e-2; the
paged kernel equals the contiguous one bit for bit at block_kv == page,
and the one-launch MLP tail equals its three staged launches bit for bit.
"""

import pytest
import torch

from repro_torch.kernels.ff_attention import attention, attention_ref
from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                     decode_attention_ref)
from repro_torch.kernels.ff_layer import (ff_layer_matmul,
                                          ff_layer_matmul_ref,
                                          ff_layer_mlp_tail,
                                          ff_layer_mlp_tail_ref,
                                          ff_layer_swiglu,
                                          ff_layer_swiglu_ref,
                                          mlp_tail_staged)
from repro_torch.models import layers as TL
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernels_match_plain_and_each_other(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    nb, page, kvh, d, b, h, npg = 20, 16, 2, 64, 3, 4, 5
    pool = torch.randn(nb, 2, page, kvh, d, generator=g, device=cuda).to(dtype)
    tables = torch.randperm(nb, generator=g, device=cuda)[:b * npg]
    tables = tables.view(b, npg).int()
    tables[2] = nb                                  # inactive slot
    lens = torch.tensor([37, npg * page, 0], dtype=torch.int32, device=cuda)
    q = torch.randn(b, h, d, generator=g, device=cuda).to(dtype)
    k, v = paged_kv.paged_gather(pool, tables)
    dense = decode_attention(q, k, v, lens, block_kv=page)
    paged = paged_kv.paged_decode_attention(q, pool, tables, lens)
    assert torch.equal(dense, paged)
    assert _err(dense, decode_attention_ref(q, k, v, lens,
                                            block_kv=page)) <= TOL[dtype]
    assert paged[2].eq(0).all()


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
@pytest.mark.parametrize("m", [1, 4, 13])
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
