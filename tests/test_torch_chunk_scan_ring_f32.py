"""The chunk scan's f32 ring body (``csrc/ff_chunk_scan.cu``
``f32_ring_scan_kernel``, picked by ``kernels/ff_chunk_scan/ops.py``
``_body`` for every call the bf16 tensor-core body does not take): which
calls it takes, its plan, its shared-memory layout and deepest ring, the
cost model and the pipe policy's cap, and a PyTorch transcription of its
arithmetic held against the reference's Pallas kernel (``chunk_scan_ff``
through ``repro.ops.chunk_scan`` in interpret mode) and the naive scan.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); the transcription here proves its factorization
first: words of 16 rows, the state carried at every 4-row boundary, every
decay a product of a_t = exp(min(lw_t, 0)), the state's decay over a word
made exact once a word, the pair scores of a 4-row block summed over N. Tolerance: float32 within 3e-5 of max |reference|,
the reference kernel test's own bound; the strong-decay case within rtol
1e-4 / atol 1e-5 of the naive scan, as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.program import PipePolicy
from repro_torch.core import autotune
from repro_torch.kernels.ff_chunk_scan import (chunk_scan, chunk_scan_ref,
                                               f32_max_depth,
                                               f32_ring_smem_bytes,
                                               max_depth)
from repro_torch.kernels.ff_chunk_scan import ops as O

FF = PipePolicy(mode="ff", interpret=True)
F32_REL_TOL = 3e-5
H100_SMS = 132
SMEM = 232448
# (bh, n, p) of the scans the card times: the f32 N = P = 256 row, and both
# models' prefill (batch 4: rwkv6-7b 64 heads of 64, zamba2-2.7b 80 heads,
# d_state 64, head dim 64)
WIDE = (16, 256, 256)
RWKV6_7B = (256, 64, 64)
ZAMBA2_2P7B = (320, 64, 64)


def _kernel_scan(q, k, v, log_w, u=None, *, inclusive=True):
    """The f32 ring body's arithmetic, row block by row block: S padded to
    whole 16-row words (q = k = v = 0, a = 1); per 4-row block b..e, q
    decayed from the block's start (a_b..a_l inclusive, a_b..a_{l-1}
    exclusive) against the carried state, the pair scores (the a's
    between l and s; exclusive: the bonus q_l u k_l on the diagonal) times
    v, then h = (a_b..a_e) h + sum_s (k_s a_{s+1}..a_e) v_s; after each
    word's four blocks h = h + cr h, cr = X - ln(the blocks' decays), X
    the word's summed log_w, the log as log1p of the product less one (0
    where the word decays below 1/2)."""
    q, k, v = q.float(), k.float(), v.float()
    lw = torch.clamp(log_w.float(), max=0.0)
    a = torch.exp(lw)
    bh, s, n = q.shape
    pad = -s % 16
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    lw = torch.nn.functional.pad(lw, (0, 0, 0, pad))
    diag = torch.ones(bh, n) if inclusive else u.float()
    h = torch.zeros(bh, n, v.shape[2])
    ys = []
    for b in range(0, s + pad, 4):
        qb, kb, ab, vb = (x[:, b:b + 4] for x in (q, k, a, v))
        pr = torch.ones(bh, n)
        for i in range(4):
            if inclusive:
                pr = pr * ab[:, i]
            y = torch.einsum("bn,bnp->bp", qb[:, i] * pr, h)
            if not inclusive:
                pr = pr * ab[:, i]
            y = y + (qb[:, i] * diag * kb[:, i]).sum(-1)[:, None] * vb[:, i]
            f = ab[:, i] if inclusive else torch.ones(bh, n)
            for s2 in range(i - 1, -1, -1):
                y = y + ((qb[:, i] * f) * kb[:, s2]).sum(-1)[:, None] \
                    * vb[:, s2]
                f = f * ab[:, s2]
            ys.append(y)
        sf = torch.ones(bh, n)
        upd = torch.zeros_like(h)
        for i in range(3, -1, -1):
            upd = upd + (kb[:, i] * sf)[:, :, None] * vb[:, i][:, None, :]
            sf = sf * ab[:, i]
        h = pr[:, :, None] * h + upd
        if b % 16 == 0:
            pm1 = torch.zeros(bh, n)
        pm1 = pm1 + (pr - 1.0) + pm1 * (pr - 1.0)
        if b % 16 == 12:
            x = lw[:, b - 12:b + 4].double().sum(1).float()
            cr = torch.where(pm1 > -0.5, x - torch.log1p(pm1), 0.0)
            h = h + cr[:, :, None] * h
    return torch.stack(ys, dim=1)[:, :s]


def _inputs(bh, s, n, p, inclusive, seed, lw_scale=0.5):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    k = (0.5 * rng.standard_normal((bh, s, n))).astype(np.float32)
    v = rng.standard_normal((bh, s, p)).astype(np.float32)
    lw = (-lw_scale * np.exp(rng.standard_normal((bh, s, n)))).astype(
        np.float32)
    u = None if inclusive else (0.3 * rng.standard_normal((bh, n))).astype(
        np.float32)
    return q, k, v, lw, u


def _rel(out, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(out.numpy() - ref).max() / (np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
def test_transcription_matches_reference_kernel_and_naive_scan(inclusive):
    """S = 37 at chunk 16: two whole words, then a ragged one that ends
    inside a 4-row block."""
    xs = _inputs(2, 37, 24, 40, inclusive, seed=3)
    ts = [None if x is None else torch.from_numpy(x) for x in xs]
    js = [None if x is None else jnp.asarray(x) for x in xs]
    out = _kernel_scan(*ts, inclusive=inclusive)
    ff = repro.ops.chunk_scan(*js, inclusive=inclusive, chunk=16, policy=FF)
    assert _rel(out, ff) < F32_REL_TOL
    naive = chunk_scan_ref(*ts, inclusive=inclusive)
    assert _rel(out, naive.numpy()) < F32_REL_TOL


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
@pytest.mark.parametrize("bh,s,n,p", [(1, 16, 16, 16), (2, 128, 64, 32),
                                      (3, 100, 32, 48)])
def test_transcription_matches_naive_scan(bh, s, n, p, inclusive):
    """Small shapes: one word, eight, and a ragged 100 rows."""
    xs = _inputs(bh, s, n, p, inclusive, seed=bh * 100 + s + n)
    ts = [None if x is None else torch.from_numpy(x) for x in xs]
    out = _kernel_scan(*ts, inclusive=inclusive)
    naive = chunk_scan_ref(*ts, inclusive=inclusive)
    assert _rel(out, naive.numpy()) < F32_REL_TOL


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
def test_transcription_at_odd_n_and_p(inclusive):
    """N = 33, P = 17 (rows the body copies element by element; the
    reference's Pipe wants lane dims of 8, so the naive scan and the
    port's plain version at chunk 48 are the references)."""
    xs = _inputs(2, 50, 33, 17, inclusive, seed=7)
    ts = [None if x is None else torch.from_numpy(x) for x in xs]
    out = _kernel_scan(*ts, inclusive=inclusive)
    naive = chunk_scan_ref(*ts, inclusive=inclusive)
    assert _rel(out, naive.numpy()) < F32_REL_TOL
    plain = O.chunk_scan_plain(*ts, inclusive=inclusive, chunk=48)
    assert _rel(out, plain.numpy()) < F32_REL_TOL


@pytest.mark.parametrize("inclusive", [True, False],
                         ids=["inclusive", "exclusive_u"])
def test_transcription_stays_finite_under_strong_decay(inclusive):
    """lw = -3: a 16-row word decays by e^-48, a 256-row row by e^-768
    (0 in f32); every factor is a product of a's <= 1."""
    ones = torch.ones(2, 256, 64)
    lw = torch.full((2, 256, 64), -3.0)
    u = None if inclusive else torch.ones(2, 64)
    out = _kernel_scan(ones, ones, ones, lw, u, inclusive=inclusive)
    assert out.isfinite().all()
    ref = chunk_scan_ref(ones, ones, ones, lw, u, inclusive=inclusive)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def _scan_f64(q, k, v, log_w, u, inclusive):
    """The naive scan in float64: the exact result to f32's eyes."""
    q, k, v = q.double(), k.double(), v.double()
    lw = torch.clamp(log_w.double(), max=0.0)
    h = torch.zeros(q.shape[0], q.shape[2], v.shape[2], dtype=torch.float64)
    ys = []
    for t in range(q.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        h_new = torch.exp(lw[:, t])[:, :, None] * h + kv
        eff = h_new if inclusive else h + u.double()[:, :, None] * kv
        ys.append(torch.einsum("bn,bnp->bp", q[:, t], eff))
        h = h_new
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("lw,inclusive", [(-1e-3, True), (-1e-4, False)],
                         ids=["lw_1e-3_inclusive", "lw_1e-4_exclusive_u"])
def test_transcription_does_not_drift_over_a_long_row(lw, inclusive):
    """S = 4096 at a decay near 1, the same every row (an RWKV6 channel
    that remembers thousands of rows): each word's correction keeps the
    carried state's decay exact, so the error does not grow with S. Held
    within 3e-5 of the float64 scan; at lw = -1e-3 also of the f32 naive
    scan, whose own per-row rounding of exp(lw) drifts too: on the CPU
    well inside the tolerance there, past it at lw = -1e-4, where only
    float64 is the yardstick."""
    g = torch.Generator().manual_seed(5)
    bh, s, n, p = 1, 4096, 8, 8
    q = 0.5 * torch.randn(bh, s, n, generator=g)
    k = 0.5 * torch.randn(bh, s, n, generator=g)
    v = torch.randn(bh, s, p, generator=g)
    log_w = torch.full((bh, s, n), lw)
    u = None if inclusive else 0.3 * torch.randn(bh, n, generator=g)
    out = _kernel_scan(q, k, v, log_w, u, inclusive=inclusive)
    exact = _scan_f64(q, k, v, log_w, u, inclusive)
    assert _rel(out, exact.numpy()) < F32_REL_TOL
    if lw == -1e-3:
        naive = chunk_scan_ref(q, k, v, log_w, u, inclusive=inclusive)
        assert _rel(out, naive.numpy()) < F32_REL_TOL


def test_body_takes_every_call_the_tensor_core_body_does_not():
    bf, f32 = torch.bfloat16, torch.float32

    def t(n, dt, p=None, s=8):
        return torch.zeros(1, s, n if p is None else p, dtype=dt)

    for n in O.RING_N:
        assert O._body(t(n, bf), t(n, bf), t(n, bf, 32), 64, 16) == "ring"
    # f32, mixed, bf16 at N = 256 or odd N, P off 16, chunk off 16,
    # subtile other than 16
    for args in [(t(256, f32), t(256, f32), t(256, f32, 256), 256, 16),
                 (t(64, f32), t(64, bf), t(64, bf, 64), 64, 16),
                 (t(64, bf), t(64, bf), t(64, f32, 64), 64, 16),
                 (t(256, bf), t(256, bf), t(256, bf, 256), 256, 16),
                 (t(17, bf), t(17, bf), t(17, bf, 32), 64, 16),
                 (t(64, bf), t(64, bf), t(64, bf, 20), 64, 16),
                 (t(64, bf), t(64, bf), t(64, bf, 64), 24, 8),
                 (t(64, bf), t(64, bf), t(64, bf, 64), 64, 64)]:
        assert O._body(*args) == "f32_ring"


def _covered(bh, p):
    plan = O._f32_plan(bh, p)
    seen = np.zeros((bh, p), np.int64)
    for row in range(bh):
        for sl in range(plan.slices):
            seen[row, sl * plan.cols:min(p, (sl + 1) * plan.cols)] += 1
    return plan, seen


@pytest.mark.parametrize("bh,p", [(16, 256), (256, 64), (320, 64), (2, 1),
                                  (3, 20), (2, 33), (1, 100), (4, 300)])
def test_plan_covers_every_row_and_column_once(bh, p):
    plan, seen = _covered(bh, p)
    assert (seen == 1).all()
    assert plan.cols <= 32 and plan.cols % 8 == 0
    assert plan.blocks == bh * plan.slices
    assert (plan.slices - 1) * plan.cols < p <= plan.slices * plan.cols


@pytest.mark.parametrize("shape", [WIDE, RWKV6_7B, ZAMBA2_2P7B],
                         ids=["n_p_256", "rwkv6_7b", "zamba2_2p7b"])
def test_plan_fills_the_sms(shape):
    """The timing shape's 16 rows in 8 slices of 32 columns: 128 blocks
    for 132 SMs; the models' prefill rows alone cover the card."""
    bh, _, p = shape
    plan = O._f32_plan(bh, p)
    assert plan.cols == 32
    assert plan.blocks >= 0.95 * H100_SMS
    assert O._f32_plan(*WIDE[::2]) == O.Plan(slices=8, cols=32, blocks=128)


def test_smem_layout_is_pinned_by_hand():
    """``F32Layout`` at N = 256, 32 columns, all f32: a stage is q, k and
    log_w 16 x 256 x 4 each and v 16 x 32 x 4 = 51,200 bytes; eight warps
    of 32 state rows: qd and ke 16 x 256, the block decays 4 x 256, the
    word's decay correction and u 256 floats each, the pair scores 8 x 48 and 48, the partial outputs 8 x 16
    x 32; 16 bytes of mbarriers a stage. At N = 64 (four warps of 16), 32
    columns: stages of 14,336 bytes. bf16 streams halve their stage
    rows."""
    stage = 16 * (3 * 256 * 4 + 32 * 4)
    derived = 4 * (38 * 256 + 8 * 48 + 48 + 8 * 16 * 32)
    assert stage == 51200 and derived == 57024
    assert f32_ring_smem_bytes(256, 32, 2) == 2 * stage + derived + 32 \
        == 159456
    assert f32_ring_smem_bytes(256, 32, 3) == 210672
    assert f32_ring_smem_bytes(64, 32, 2) == 2 * 14336 + 4 * (
        38 * 64 + 4 * 48 + 48 + 4 * 16 * 32) + 32 == 47584
    bf = 16 * (3 * 256 * 2 + 32 * 2)
    assert f32_ring_smem_bytes(256, 32, 1, (2, 2, 2, 2)) == bf + derived + 16
    # N = 17: NS rounds to 24, three warps of 8 state rows (NP = 24)
    assert f32_ring_smem_bytes(17, 20, 1) == 16 * (3 * 24 * 4 + 24 * 4) \
        + 4 * (38 * 24 + 3 * 48 + 48 + 3 * 16 * 32) + 16


@pytest.mark.parametrize("n,p,dtypes", [
    (256, 256, None), (64, 64, None), (128, 128, None),
    (256, 256, (torch.bfloat16,) * 4), (17, 20, None),
    (512, 64, None), (64, 64, (torch.bfloat16, torch.bfloat16,
                               torch.float32, torch.bfloat16))])
def test_max_depth_is_the_deepest_f32_ring_that_fits(n, p, dtypes):
    d = f32_max_depth(n, p, dtypes)
    cols = O._f32_plan(1, p).cols
    sizes = tuple(O.itemsize(x) for x in (dtypes or (torch.float32,) * 4))
    assert d >= 1
    assert f32_ring_smem_bytes(n, cols, d, sizes) <= SMEM
    assert f32_ring_smem_bytes(n, cols, d + 1, sizes) > SMEM


def test_deepest_rings_by_hand_and_the_refusals():
    """N = P = 256 in f32 takes three stages (two or three, as a 51 KB
    stage leaves room for); N = 512 one; N = 1024, f32 or bf16, not one:
    the launch refuses it, naming shared memory, before any CUDA call."""
    assert f32_max_depth(256, 256) == 3
    assert f32_max_depth(512, 64) == 1
    assert f32_max_depth(1024, 64) == 0
    assert f32_max_depth(1024, 64, (torch.bfloat16,) * 4) == 0
    x, v = torch.zeros(1, 32, 1024), torch.zeros(1, 32, 64)
    with pytest.raises(ValueError, match="shared memory"):
        O._launch(x, x, v, x, None, 256, 16, True, 1, 1)
    x, v = torch.zeros(1, 32, 256), torch.zeros(1, 32, 256)
    with pytest.raises(ValueError, match="shared memory"):
        O._launch(x, x, v, x, None, 256, 16, True, 4, 1)


def test_cost_model_follows_the_body():
    """bf16 at N in {16..128}, P and chunk multiples of 16: the tensor-core
    body's layout; f32, or N = 256: the f32 ring body's."""
    bf, f32 = torch.bfloat16, torch.float32
    c = O.chunk_scan_cost(256, 256, 64, 64, chunk=64, depth=2, dtype=bf)
    assert c.smem_bytes == O.ring_smem_bytes(64, 64, 4, 2)
    c = O.chunk_scan_cost(16, 256, 256, 256, chunk=256, depth=3, dtype=f32)
    assert c.smem_bytes == f32_ring_smem_bytes(256, 32, 3) == 210672
    c = O.chunk_scan_cost(16, 256, 256, 256, chunk=256, depth=2, dtype=bf)
    assert c.smem_bytes == f32_ring_smem_bytes(256, 32, 2, (2, 2, 2, 2))


def test_policy_cap_follows_the_body(monkeypatch):
    """The deepest ring handed to the pipe policy is the picked body's:
    f32 N = P = 256 caps at 3, bf16 N = P = 64 at the tensor-core body's
    max_depth."""
    caps = []
    resolve = autotune.resolve_call

    def spy(*args, **kw):
        caps.append(kw["depth_cap"])
        return resolve(*args, **kw)

    monkeypatch.setattr(autotune, "resolve_call", spy)
    x = torch.zeros(1, 16, 256)
    chunk_scan(x, x, x, x, chunk=256)
    b = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    chunk_scan(b, b, b, b, chunk=64)
    assert caps == [3, max_depth(64, 64, torch.bfloat16)]
