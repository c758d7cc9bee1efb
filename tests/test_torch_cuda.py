"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a: H100/H200); elsewhere each
test skips, decided inside the ``cuda`` fixture, never at import. Run them
on the card with (``--noconftest``: the tests' conftest imports JAX, which
the card's machine need not have):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: float32 2e-4 (the reference registry's), bfloat16 2e-2; the
paged kernel equals the contiguous one bit for bit at block_kv == page.
"""

import pytest
import torch

from repro_torch.kernels.ff_attention import attention, attention_ref
from repro_torch.kernels.ff_decode_attention import (decode_attention,
                                                     decode_attention_ref)
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
