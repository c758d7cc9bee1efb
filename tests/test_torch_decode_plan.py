"""The launch plan and the ring-pipe arguments of the port's decode
attention (``repro_torch.kernels.ff_decode_attention``), on the CPU.

``_plan`` picks the launch's split from B, KVH, the cache rows and the SM
count alone, so the contiguous cache and the paged pool split alike at
``block_kv == page``; ``_split_words`` mirrors how the kernel cuts a row's
live words over the splits it uses. The ring's shared memory is ``depth``
words of 16, 32 or 64 rows (by the row's size, never by ``block_kv`` or
the page), and ``max_depth`` is the deepest that fits. ``depth`` and ``streams`` are
checked as the reference's ``Pipe`` checks them on the K/V stream. The
wrappers' CPU path (the plain version) is held against the reference's
``decode_attention_ff`` and ``paged_decode_attention`` in interpret mode at
the same ``depth`` and ``streams``: float32 2e-4 (the reference
registry's tolerance), bfloat16 2e-2.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipe import Pipe
from repro.core.program import PipePolicy
from repro.kernels.ff_decode_attention.kernel import decode_attention_ff
from repro.runtime import paged_kv as jpk
from repro_torch.kernels.ff_decode_attention import decode_attention
from repro_torch.kernels.ff_decode_attention import ops as D
from repro_torch.runtime import paged_kv as tpk

SMS = 132                      # the H100's SM count, passed in
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BF16 = torch.bfloat16
MAX_SMEM = 232448
PIPES = [(d, s) for d in (1, 2, 4) for s in (1, 2)]
# (label, b, kvh, cache rows): the serve runs' shapes (qwen1.5-0.5B, 4
# slots, page 16), the long cache of chip_smoke.py, zamba2-2.7b's
# attention (32 heads of 80, 272 rows), a small GQA case
SHAPES = [("serve", 4, 16, 64, 48), ("serve-256", 4, 16, 64, 240),
          ("long", 4, 16, 64, 4096), ("zamba2", 4, 32, 80, 272),
          ("gqa", 3, 2, 128, 320), ("one-row", 1, 1, 256, 2048)]
IDS = [x[0] for x in SHAPES]
DTYPES = [torch.float32, BF16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,b,kvh,d,s", SHAPES, ids=IDS)
def test_plan_covers_every_live_word_once_in_split_order(label, b, kvh, d,
                                                         s, dtype):
    plan = D._plan(b, kvh, d, dtype, s, SMS)
    assert plan.rows == D._word_rows(d, dtype) in (16, 32, 64)
    assert plan.words == -(-s // plan.rows) and plan.split >= 1
    for live in range(plan.words + 1):
        parts = D._split_words(live, plan.split, plan.rows)
        assert len(parts) <= plan.split
        covered = [w for lo, hi in parts for w in range(lo, hi)]
        assert covered == list(range(live))          # once, ascending
        assert all(hi > lo for lo, hi in parts)      # no empty split merged
        if live * plan.rows < 2 * D._MIN_SPLIT_ROWS:
            assert len(parts) <= 1                   # short rows: one block


def test_plan_fills_the_card_and_leaves_short_caches_whole():
    long = D._plan(4, 16, 64, BF16, 4096, SMS)
    assert long.rows == 64 and 4 * 16 * long.split >= 4 * SMS
    for s in (16, 32, 48, 112, 192):                # under 4 words
        assert D._plan(4, 16, 64, BF16, s, SMS).split == 1
    assert D._plan(4, 16, 64, BF16, 4096, 2 * SMS).split > long.split
    assert D._plan(4, 32, 80, BF16, 272, SMS).split > 1     # zamba2


@pytest.mark.parametrize("d,dtype,rows", [
    (64, BF16, 64), (80, BF16, 32), (128, BF16, 32), (256, BF16, 16),
    (64, torch.float32, 32), (256, torch.float32, 16), (70, BF16, 32)])
def test_a_word_holds_16_kb_of_rows_at_most(d, dtype, rows):
    assert D._word_rows(d, dtype) == rows
    assert D.ring_smem_bytes(1, d, dtype) <= 16384 or rows == 16


def _record(monkeypatch):
    """Fake the C entries: every launch's (paged, args) is recorded."""
    seen = []

    def fake_entry(paged, dtype):
        return lambda *args: seen.append((paged, args)) or 0

    monkeypatch.setattr(D, "_entry", fake_entry)
    monkeypatch.setattr(D, "_sms", lambda index: SMS)
    monkeypatch.setattr(D._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(D, "_SCRATCH", {})
    return seen


def _pool_case(dtype, b, kvh, g, d, page, n_pages):
    pool = torch.zeros(b * n_pages, 2, page, kvh, d, dtype=dtype)
    tables = torch.arange(b * n_pages, dtype=torch.int32).view(b, n_pages)
    q = torch.zeros(b, kvh * g, d, dtype=dtype)
    lens = torch.full((b,), page * n_pages, dtype=torch.int32)
    return q, pool, tables, lens


@pytest.mark.parametrize("label,b,kvh,d,s", SHAPES, ids=IDS)
@pytest.mark.parametrize("depth,streams", [(2, 1), (1, 2), (4, 2)])
def test_both_launchers_pass_one_plan_depth_and_streams(monkeypatch, label, b,
                                                        kvh, d, s, depth,
                                                        streams):
    seen = _record(monkeypatch)
    page, g = 16, 2
    q, pool, tables, lens = _pool_case(BF16, b, kvh, g, d, page, s // page)
    k, v = tpk.paged_gather(pool, tables)
    D.launch_contiguous(q, k, v, lens, depth=depth, streams=streams)
    D.launch_paged(q, pool, tables, lens, depth=depth, streams=streams)
    (c_paged, c), (p_paged, p) = seen
    assert (c_paged, p_paged) == (False, True)
    # ... b, kvh, group, d, then each layout's sizes, then scale, depth,
    # streams, split, rows, ws, tickets, stream
    assert c[5:9] == p[5:9] == (b, kvh, g, d)
    assert c[-8:-3] == p[-8:-3]
    plan = D._plan(b, kvh, d, BF16, s, SMS)
    assert c[-7:-3] == (depth, streams, plan.split, plan.rows)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_ring_fits_227_kb_up_to_max_depth(dtype, d):
    """Every depth up to max_depth fits; the ring is depth words of K and
    V rows, with no term in block_kv or the page."""
    deepest = D.max_depth(d, dtype)
    assert deepest >= 6                    # the depth sweep's deepest
    for depth in range(1, deepest + 1):
        assert D.smem_bytes(depth, d, dtype) <= MAX_SMEM
    assert D.smem_bytes(deepest + 1, d, dtype) > MAX_SMEM
    item = 4 if dtype == torch.float32 else 2
    pitch = -(-d * item // 16) * 16
    rows = D._word_rows(d, dtype)
    assert D.ring_smem_bytes(1, d, dtype) == 2 * rows * pitch
    # q, each warp's acc, m and l in f32, two mbarriers a stage, a flag
    dp = pitch // item
    assert D.smem_bytes(3, d, dtype, 2) == (
        3 * 2 * rows * pitch + 4 * 2 * dp * 5 + 8 * 4 * 2 + 16 * 3 + 16)
    with pytest.raises(ValueError, match="shared memory"):
        D._pipe(deepest + 1, 1, 16, d, dtype, 1)


def _pipe_raises(**kw):
    try:
        Pipe(**kw)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams", list(itertools.product(
    (-1, 0, 1, 2, 6), (0, 1, 2, 3, 4, 5, 8, 16, 32))))
def test_depth_and_streams_checked_as_the_reference_pipe(depth, streams):
    q, pool, tables, lens = _pool_case(BF16, 2, 2, 1, 64, 16, 4)
    k, v = tpk.paged_gather(pool, tables)
    for rows, call in (
            (16, lambda: decode_attention(q, k, v, lens, block_kv=16,
                                          depth=depth, streams=streams)),
            (32, lambda: decode_attention(q, k, v, lens, block_kv=32,
                                          depth=depth, streams=streams)),
            (32, lambda: tpk.paged_decode_attention(
                q, pool, tables, lens, depth=depth, streams=streams))):
        want = _pipe_raises(tile=(rows, 64), dtype=jnp.bfloat16,
                            depth=depth, streams=streams)
        if want:
            with pytest.raises(ValueError):
                call()
        else:
            assert call().shape == q.shape


def _case(seed, dtype, b=3, kvh=2, g=2, d=16, page=8, n_pages=4):
    """Numpy inputs: a pool of stale values, a permuted table with
    sentinels past row 0's reservation, an inactive row (length 0)."""
    rng = np.random.default_rng(seed)
    nb = b * n_pages + 2
    pool = rng.standard_normal((nb, 2, page, kvh, d)).astype(np.float32)
    bt = rng.permutation(nb)[:b * n_pages].reshape(b, n_pages)
    bt = bt.astype(np.int32)
    bt[0, 2:] = nb                                   # sentinels
    bt[2, :] = nb
    lens = np.array([13, n_pages * page, 0], np.int32)[:b]
    q = rng.standard_normal((b, kvh * g, d)).astype(np.float32)
    tq, tpool = (torch.from_numpy(x).to(dtype) for x in (q, pool))
    # the reference sees the same values, rounded to the type first
    jq, jpool = (jnp.asarray(x.float().numpy(),
                             dtype=jnp.float32 if dtype == torch.float32
                             else jnp.bfloat16) for x in (tq, tpool))
    return (tq, tpool, torch.from_numpy(bt), torch.from_numpy(lens),
            jq, jpool, jnp.asarray(bt), jnp.asarray(lens))


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("depth,streams", PIPES)
def test_contiguous_cpu_path_matches_reference(dtype, depth, streams):
    tq, tpool, bt, lens, jq, jpool, jbt, jlens = _case(1, dtype)
    k, v = tpk.paged_gather(tpool, bt)
    b, h, d = tq.shape
    kvh = k.shape[1]
    port = decode_attention(tq, k, v, lens, block_kv=8, depth=depth,
                            streams=streams)
    # the reference's layout: q [B, KVH, G padded to 8, D]
    qg = jnp.pad(jq.reshape(b, kvh, h // kvh, d),
                 ((0, 0), (0, 0), (0, 8 - h // kvh), (0, 0)))
    jk = jnp.asarray(k.float().numpy(), dtype=jq.dtype)
    jv = jnp.asarray(v.float().numpy(), dtype=jq.dtype)
    ref = decode_attention_ff(qg, jk, jv, jlens, block_kv=8, depth=depth,
                              streams=streams, interpret=True)
    _close(port, ref[:, :, :h // kvh].reshape(b, h, d), dtype)
    assert port[2].eq(0).all()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("depth,streams", PIPES)
def test_paged_cpu_path_matches_reference(dtype, depth, streams):
    tq, tpool, bt, lens, jq, jpool, jbt, jlens = _case(2, dtype)
    port = tpk.paged_decode_attention(tq, tpool, bt, lens, depth=depth,
                                      streams=streams)
    ref = jpk.paged_decode_attention(
        jq, jpool, jbt, jlens,
        policy=PipePolicy(mode="ff", depth=depth, streams=streams,
                          interpret=True))
    _close(port, ref, dtype)
    assert port[2].eq(0).all()
