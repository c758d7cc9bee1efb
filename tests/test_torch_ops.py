"""The port's library entry points ``repro_torch.ops.matmul`` and
``repro_torch.ops.gather`` (their plain versions, which the wrappers run
for CPU tensors) against the reference's ``repro.ops.matmul`` and
``repro.ops.gather`` in interpret mode, on the same numpy inputs.

Tolerances: float32 5e-4 relative and absolute (the reference registry's
``tol`` for ff_matmul; both sides accumulate in f32, in other orders);
bfloat16 outputs 2e-2 relative and absolute (both round the same f32 sum
once, and may land one bfloat16 step apart); the gather exactly (it is a
copy). The reference's ``ff`` mode takes k only in multiples of 8 (its
pipe tiles), so ragged k is held against its ``matmul_ref`` oracle alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.program import PipePolicy
from repro.kernels.ff_matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch import ops
from repro_torch.kernels.ff_attention import attention
from repro_torch.kernels.ff_chunk_scan import chunk_scan
from repro_torch.kernels.ff_decode_attention import decode_attention
from repro_torch.kernels.ff_gather import gather, gather_ref
from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                           dispatch_matmul_ref, matmul,
                                           matmul_ref)

POLICY = PipePolicy(mode="ff", interpret=True)
F32_TOL, BF16_TOL = 5e-4, 2e-2
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _pair(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    return t, jnp.asarray(t.float().numpy(), _JNP[dtype])


@pytest.mark.parametrize("m,k,n", [(40, 64, 24), (77, 136, 53)],
                         ids=["aligned", "ragged_m_n"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_matmul_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(0)
    a, ja = _pair(rng.standard_normal((m, k)), dtype)
    b, jb = _pair(rng.standard_normal((k, n)) / np.sqrt(k), dtype)
    out = ops.matmul(a, b)
    ref = repro.ops.matmul(ja, jb, policy=POLICY)
    assert out.dtype == dtype and out.shape == (m, n)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _close(out, ref, tol)
    _close(out, jax_matmul_ref(ja, jb), tol)


def test_mixed_matmul_returns_a_type_as_the_reference():
    """bf16 A with f32 B: the reference returns A's type; so does the
    port, and ``out_dtype`` overrides it in both."""
    rng = np.random.default_rng(1)
    a, ja = _pair(rng.standard_normal((40, 64)), torch.bfloat16)
    b, jb = _pair(rng.standard_normal((64, 24)) / 8, torch.float32)
    out = matmul(a, b)
    ref = repro.ops.matmul(ja, jb, policy=POLICY)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(out, ref, BF16_TOL)
    out32 = matmul(a, b, out_dtype=torch.float32)
    ref32 = repro.ops.matmul(ja, jb, out_dtype=jnp.float32, policy=POLICY)
    assert out32.dtype == torch.float32 and ref32.dtype == jnp.float32
    _close(out32, ref32, F32_TOL)


@pytest.mark.parametrize("m,k,n", [(33, 70, 17), (5, 3, 1)])
def test_ragged_k_matches_the_reference_oracle(m, k, n):
    rng = np.random.default_rng(2)
    a, ja = _pair(rng.standard_normal((m, k)), torch.float32)
    b, jb = _pair(rng.standard_normal((k, n)), torch.float32)
    _close(matmul(a, b), jax_matmul_ref(ja, jb), F32_TOL)


@pytest.fixture(scope="module")
def gather_case():
    """Repeated and unsorted indices, n = 52 (the reference pads it to its
    8-row bundle; the port takes it as it is)."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((96, 128)).astype(np.float32)
    idx = rng.integers(0, 96, 52).astype(np.int32)
    idx[:4] = [90, 3, 90, 3]
    return table, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gather_equals_reference_exactly(gather_case, dtype):
    table, idx = gather_case
    t, jt = _pair(table, dtype)
    out = ops.gather(t, torch.from_numpy(idx))
    ref = repro.ops.gather(jt, jnp.asarray(idx), policy=POLICY)
    assert out.dtype == dtype and out.shape == (52, 128)
    assert np.array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_gather_takes_int64_indices_and_raises_out_of_range(gather_case):
    table, idx = gather_case
    t = torch.from_numpy(table)
    assert torch.equal(gather(t, torch.from_numpy(idx).long()),
                       gather(t, torch.from_numpy(idx)))
    with pytest.raises(IndexError):
        gather_ref(t, torch.tensor([96], dtype=torch.int32))


@pytest.mark.parametrize("bad", [-1, -96], ids=["minus1", "minusR"])
def test_gather_rejects_negative_indices(gather_case, bad):
    """A negative index lies outside the contract [0, R): the CPU path
    raises rather than wrap to a row from the end of the table."""
    table, idx = gather_case
    t = torch.from_numpy(table)
    i = torch.from_numpy(idx).clone()
    i[7] = bad
    with pytest.raises(IndexError):
        gather(t, i)
    with pytest.raises(IndexError):
        dispatch_matmul(t, i, torch.zeros(128, 8))


def test_dispatch_matmul_wants_one_type(gather_case):
    """Tokens and weight share one type, as the reference graph's expert
    matmul (built with the tokens' dtype) has it."""
    table, idx = gather_case
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(TypeError):
        dispatch_matmul(t, i, torch.zeros(128, 8, dtype=torch.bfloat16))


def test_dispatch_matmul_plain_is_gather_then_matmul(gather_case):
    table, idx = gather_case
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (128, 40)).astype(np.float32))
    out = dispatch_matmul(t, i, w)
    assert torch.equal(out, matmul(gather(t, i), w))
    assert torch.equal(out, dispatch_matmul_ref(t, i, w))


def test_ops_names_are_the_reference_entry_points_ported_so_far():
    """Every reference entry point, each the kernel wrapper itself."""
    assert ops.names() == tuple(repro.ops.names())
    assert (ops.matmul, ops.gather, ops.attention, ops.decode_attention,
            ops.chunk_scan) == (matmul, gather, attention, decode_attention,
                                chunk_scan)


def test_wrappers_reject_what_they_do_not_take():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(9, 3))                 # k mismatch
    with pytest.raises(TypeError):
        matmul(a.half(), torch.zeros(8, 3))          # float16
    with pytest.raises(TypeError):
        gather(a, torch.zeros(2))                    # float indices
    with pytest.raises(ValueError):
        gather(a, torch.zeros(2, 1, dtype=torch.int32))
    assert torch.equal(matmul_ref(a, torch.ones(8, 3)), torch.zeros(4, 3))
