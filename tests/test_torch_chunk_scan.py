"""The port's gated linear-attention scan ``repro_torch.ops.chunk_scan``
(its plain version, which the wrapper runs for CPU tensors) against the
reference's ``repro.ops.chunk_scan`` in ``ff`` interpret mode (its Pallas
kernel) and in ``ref`` mode (its naive scan), on the same numpy inputs.

Tolerances: at float32, max error over max |reference| below 3e-5, the
bound the reference's own kernel test holds itself to
(``tests/test_kernels.py:test_chunk_scan``); the strong-decay case within
rtol 1e-4 / atol 1e-5, as there; bfloat16 streams within 2e-2 (both sides
read the same bf16 values, compute in f32 and round the output once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.program import PipePolicy
from repro_torch import ops
from repro_torch.kernels.ff_chunk_scan import (chunk_scan, chunk_scan_plain,
                                               chunk_scan_ref,
                                               f32_max_depth,
                                               f32_ring_smem_bytes)
from repro_torch.kernels.ff_chunk_scan import ops as scan_ops

FF = PipePolicy(mode="ff", interpret=True)
REF = PipePolicy(mode="ref")
F32_REL_TOL, BF16_TOL = 3e-5, 2e-2


def _inputs(bh, s, n, p, inclusive, seed=0):
    """The reference test's input distributions, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    k = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    v = rng.standard_normal((bh, s, p)).astype(np.float32)
    lw = (-0.5 * np.exp(rng.standard_normal((bh, s, n)))).astype(np.float32)
    u = None if inclusive else (0.3 * rng.standard_normal((bh, n))).astype(
        np.float32)
    return q, k, v, lw, u


def _torch(xs, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(xs)
    return [None if x is None else torch.from_numpy(x).to(dt)
            for x, dt in zip(xs, dtypes)]


def _jax(ts):
    """The torch operands' exact values as jax arrays of the same types."""
    out = []
    for t in ts:
        if t is None:
            out.append(None)
        else:
            jt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
            out.append(jnp.asarray(t.float().numpy(), jt))
    return out


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return (np.abs(port.float().numpy() - ref).max()
            / (np.abs(ref).max() + 1e-6))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
@pytest.mark.parametrize("bh,s,n,p", [(2, 128, 32, 64), (3, 200, 64, 64),
                                      (1, 64, 16, 32)])
def test_chunk_scan_matches_reference_kernel_and_oracle(bh, s, n, p,
                                                        inclusive, chunk):
    ts = _torch(_inputs(bh, s, n, p, inclusive))
    js = _jax(ts)
    out = ops.chunk_scan(*ts, inclusive=inclusive, chunk=chunk)
    assert out.shape == (bh, s, p) and out.dtype == torch.float32
    ff = repro.ops.chunk_scan(*js, inclusive=inclusive, chunk=chunk,
                              policy=FF)
    ref = repro.ops.chunk_scan(*js, inclusive=inclusive, policy=REF)
    assert _rel(out, ff) < F32_REL_TOL
    assert _rel(out, ref) < F32_REL_TOL
    assert _rel(chunk_scan_ref(*ts, inclusive=inclusive), ref) < F32_REL_TOL


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
def test_plain_version_at_chunk_256_matches_the_oracle(inclusive):
    """Chunk 256, the largest the reference's autotuner tries, with S = 300
    (a ragged second chunk), against the reference's naive scan."""
    ts = _torch(_inputs(2, 300, 16, 16, inclusive, seed=11))
    out = chunk_scan_plain(*ts, inclusive=inclusive, chunk=256)
    ref = repro.ops.chunk_scan(*_jax(ts), inclusive=inclusive, policy=REF)
    assert _rel(out, ref) < F32_REL_TOL


def test_strong_decay_stays_finite():
    """lw = -3 everywhere: a chunk decays by e^-192; every exponent of the
    factorization is <= 0, so nothing overflows."""
    bh, s, n, p = 1, 128, 16, 16
    ts = [torch.ones(bh, s, n), torch.ones(bh, s, n), torch.ones(bh, s, p),
          torch.full((bh, s, n), -3.0)]
    out = chunk_scan(*ts, inclusive=True)
    assert torch.isfinite(out).all()
    ref = repro.ops.chunk_scan(*_jax(ts), inclusive=True, policy=REF)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    ff = repro.ops.chunk_scan(*_jax(ts), inclusive=True, policy=FF)
    np.testing.assert_allclose(out.numpy(), np.asarray(ff), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["mamba2_types", "rwkv6_types"])
def test_bf16_streams_with_their_own_types(inclusive):
    """The two models' operand types: Mamba2 bf16 q/k/v with an f32
    log_w; RWKV6 bf16 q/k/v/log_w with an f32 u, which the reference does
    not round to q's type (its BlockIn declares it, the plain lowering keeps
    the operand's own type), and neither does the port."""
    bh, s, n, p = 2, 96, 16, 32
    xs = _inputs(bh, s, n, p, inclusive, seed=3)
    bf, f32 = torch.bfloat16, torch.float32
    types = [bf, bf, bf, f32, None] if inclusive else [bf, bf, bf, bf, f32]
    ts = _torch(xs, types)
    out = chunk_scan(*ts, inclusive=inclusive)
    assert out.dtype == bf
    ff = repro.ops.chunk_scan(*_jax(ts), inclusive=inclusive, policy=FF)
    assert ff.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ff, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_ragged_s_is_padded_and_cut_back():
    """S = 70 with chunk 32: the plain version pads to 96 with lw = 0 and
    k = v = 0, which adds nothing, and returns 70 rows equal to the scan of
    the first 70 rows of a longer sequence."""
    ts = _torch(_inputs(2, 96, 16, 16, False, seed=5))
    short = [t[:, :70] if t.dim() == 3 else t for t in ts]
    out = chunk_scan(*short, inclusive=False, chunk=32)
    assert out.shape == (2, 70, 16)
    full = chunk_scan(*ts, inclusive=False, chunk=32)
    torch.testing.assert_close(out, full[:, :70], rtol=1e-6, atol=1e-6)


def test_log_w_is_clamped_at_zero():
    ts = _torch(_inputs(1, 64, 16, 16, True, seed=7))
    pos = ts[3].abs()                        # a growth the scan refuses
    zero = torch.zeros_like(ts[3])
    a = chunk_scan(ts[0], ts[1], ts[2], pos)
    b = chunk_scan(ts[0], ts[1], ts[2], zero)
    assert torch.equal(a, b)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(2, 64, 16)
    v = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="subtile"):
        chunk_scan(q, q, v, q, chunk=48, subtile=32)
    with pytest.raises(ValueError):                  # k of another shape
        chunk_scan(q, torch.zeros(2, 64, 8), v, q)
    with pytest.raises(ValueError):                  # v of another length
        chunk_scan(q, q, torch.zeros(2, 60, 32), q)
    with pytest.raises(ValueError):                  # u not [BH, N]
        chunk_scan(q, q, v, q, torch.zeros(2, 8), inclusive=False)
    with pytest.raises(ValueError, match="bonus"):   # u in inclusive mode
        chunk_scan(q, q, v, q, torch.zeros(2, 16), inclusive=True)
    with pytest.raises(TypeError):
        chunk_scan(q.half(), q, v, q)
    # a subtile larger than the chunk is cut to the chunk, as in the
    # reference
    out = chunk_scan(q, q, v, q, chunk=8, subtile=16)
    assert out.shape == (2, 64, 32)


def test_plain_version_is_the_wrapper_on_the_cpu_and_counts_no_launch():
    ts = _torch(_inputs(2, 80, 16, 16, False, seed=9))
    before = chunk_scan.launches
    out = ops.chunk_scan(*ts, inclusive=False)
    assert torch.equal(out, chunk_scan_plain(*ts, inclusive=False))
    assert chunk_scan.launches == before == 0


def test_shared_memory_fits_the_path_shapes():
    """Neither body's shared memory grows with the chunk (both stream 16
    rows a word and carry the state on chip): the f32 ring body's block
    of 32 columns fits N = P = 64 and 128 at deep rings and N = P = 256 at
    three stages of 51 KB; the tensor-core body fits N = P = 128 at its
    default depth."""
    assert f32_ring_smem_bytes(64, 32, 2) == 47584
    assert f32_max_depth(64, 64) == 14
    assert f32_max_depth(128, 128) >= 4
    assert f32_ring_smem_bytes(256, 32, 3) <= 232448 < f32_ring_smem_bytes(
        256, 32, 4)
    assert scan_ops._f32_plan(2, 256).slices == 8
    assert scan_ops.ring_smem_bytes(128, 128, 4, 2) <= 232448
