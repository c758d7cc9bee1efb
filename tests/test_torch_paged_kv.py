"""repro_torch.runtime.paged_kv against repro.runtime.paged_kv: the
allocator's LIFO recycling and atomic failure, and the pool after the
scatters, which must equal the reference's exactly (they only copy
values), sentinel drops included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import paged_kv as jpk
from repro_torch.runtime import paged_kv as tpk


def test_allocator_lifo_matches_reference():
    ours, ref = tpk.BlockAllocator(8), jpk.BlockAllocator(8)
    first = ours.alloc(3)
    assert first == ref.alloc(3)
    ours.free(first)
    ref.free(first)
    again = ours.alloc(3)
    assert again == list(reversed(first)) == ref.alloc(3)
    assert ours.n_free == ref.n_free == 5


def test_allocator_out_of_blocks_is_atomic():
    a = tpk.BlockAllocator(4)
    a.alloc(3)
    with pytest.raises(tpk.OutOfBlocks):
        a.alloc(2)
    assert a.n_free == 1
    assert len(a.alloc(1)) == 1


def _kv(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_scatter_prefill_matches_reference_exactly():
    rng = np.random.default_rng(0)
    n_layers, nb, page, kvh, hd = 2, 7, 4, 2, 8
    b, s_p, npg = 3, 12, 3
    pool = _kv(rng, n_layers, nb, 2, page, kvh, hd)
    k = _kv(rng, n_layers, b, s_p, kvh, hd)
    v = _kv(rng, n_layers, b, s_p, kvh, hd)
    bt = np.array([[4, 0, nb], [2, 6, 1], [nb, nb, nb]], np.int32)
    lens = np.array([7, 12, 5], np.int32)    # row 0 reaches its sentinel
    ref = jpk.scatter_prefill(jnp.asarray(pool), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(bt),
                              jnp.asarray(lens), page=page, n_blocks=nb)
    ours = tpk.scatter_prefill(torch.from_numpy(pool.copy()),
                               torch.from_numpy(k), torch.from_numpy(v),
                               bt, lens, page=page, n_blocks=nb)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # blocks no row owns are untouched
    np.testing.assert_array_equal(ours.numpy()[:, [3, 5]], pool[:, [3, 5]])


def test_scatter_token_matches_reference_exactly():
    rng = np.random.default_rng(1)
    nb, page, kvh, hd = 6, 4, 2, 8
    pool = _kv(rng, nb, 2, page, kvh, hd)
    bt = np.array([[3, 1], [5, nb], [nb, nb]], np.int32)
    # row 1 writes past its one reserved page (sentinel: dropped); row 2
    # is an inactive slot
    lens = np.array([6, 4, 0], np.int32)
    k_new, v_new = _kv(rng, 3, kvh, hd), _kv(rng, 3, kvh, hd)
    ref = jpk.scatter_token(jnp.asarray(pool), jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(k_new),
                            jnp.asarray(v_new), n_blocks=nb)
    ours = tpk.scatter_token(torch.from_numpy(pool.copy()),
                             torch.from_numpy(bt), torch.from_numpy(lens),
                             torch.from_numpy(k_new), torch.from_numpy(v_new),
                             n_blocks=nb)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    changed = np.argwhere((ours.numpy() != pool).any(axis=(3, 4)))
    assert {tuple(c) for c in changed} == {(1, 0, 2), (1, 1, 2)}


def _caches(n_blocks=6):
    kw = dict(n_layers=2, n_blocks=n_blocks, page=4, kv_heads=2,
              head_dim=8, n_slots=3, n_pages_max=3)
    return (tpk.PagedKVCache(**kw, dtype=torch.float32),
            jpk.PagedKVCache(**kw, dtype=jnp.float32))


def test_cache_admit_retire_and_utilization_match_reference():
    """The same admission/append/retire sequence leaves the same pool,
    tables, lengths and utilization in both packages; a refused admission
    changes nothing."""
    rng = np.random.default_rng(2)
    ours, ref = _caches()
    seq = [(0, 5, 9), (1, 3, 8), (2, 7, 12)]   # (slot, length, reserve)
    for slot, length, reserve in seq[:2]:
        k, v = _kv(rng, 2, 8, 2, 8), _kv(rng, 2, 8, 2, 8)
        ours.admit(slot, torch.from_numpy(k), torch.from_numpy(v), length,
                   reserve)
        ref.admit(slot, jnp.asarray(k), jnp.asarray(v), length, reserve)
    with pytest.raises(tpk.OutOfBlocks):       # 3 pages wanted, 1 free
        ours.admit(2, torch.zeros(2, 8, 2, 8), torch.zeros(2, 8, 2, 8),
                   7, 12)
    assert ours.allocator.n_free == 1
    ours.append(np.array([1, 1, 0]))
    ref.append(np.array([1, 1, 0]))
    assert ours.utilization() == ref.utilization()
    ours.retire(0)
    ref.retire(0)
    assert ours.utilization() == ref.utilization()
    np.testing.assert_array_equal(ours.pool.numpy(), np.asarray(ref.pool))
    view, ref_view = ours.cache_view(), ref.cache_view()
    np.testing.assert_array_equal(view["block_tables"].numpy(),
                                  np.asarray(ref_view["block_tables"]))
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
