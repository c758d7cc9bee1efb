"""The port's stream-program contract (``repro_torch.core.feedforward``)
against the reference's (``repro.core.feedforward``) on the same numpy
inputs, and the port's kernels' plain versions against ``run_reference``
of two specs (``ktiled_product_spec``, ``row_gather_spec``): a k-tiled
product and a row gather (``chip_smoke.py`` holds the kernels to them on
the card).

Tolerances: the stream folds within 1e-6 relative on small-integer data,
whose f32 sums are exact in any order (so only the word order the spec
fixes can differ), and within 1e-5 relative on normal data (XLA and
PyTorch sum a tile's elements in other orders inside ``sum``); the
products within 1e-5 relative and absolute (the plain matmul sums k whole,
the spec a tile at a time); the gather exactly (a copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feedforward as jff
from repro_torch.core import feedforward as tff
from repro_torch.kernels.ff_gather import gather_ref
from repro_torch.kernels.ff_matmul import matmul_ref


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ints(shape, seed=0):
    """Small integers as f32: every partial sum is exact."""
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(
        np.float32)


DATA = {"ints": (_ints, 1e-6), "normal": (_x, 1e-5)}


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("tile_rows", [1, 8, 16])
def test_reduction_stream_matches_the_reference(tile_rows, data):
    make, tol = DATA[data]
    x = make((64, 128))
    port = tff.run_reference(tff.reduction_stream(torch.from_numpy(x),
                                                  tile_rows),
                             torch.from_numpy(x))
    ref = jff.run_reference(jff.reduction_stream(jnp.asarray(x), tile_rows),
                            jnp.asarray(x))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol)


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("streams", [1, 2, 3, 5])
def test_multistream_reference_matches_the_reference(streams, data):
    make, tol = DATA[data]
    x = make((80, 32), seed=1)
    port = tff.run_multistream_reference(
        tff.reduction_stream(torch.from_numpy(x), 8), torch.from_numpy(x),
        streams, combine=lambda outs: sum(outs))
    ref = jff.run_multistream_reference(
        jff.reduction_stream(jnp.asarray(x), 8), jnp.asarray(x), streams,
        combine=lambda outs: sum(outs))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol)
    single = tff.run_reference(tff.reduction_stream(torch.from_numpy(x), 8),
                               torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), single.numpy(), rtol=1e-5)


def test_finalize_runs_after_the_fold():
    x = _x((32, 4), seed=2)
    base = tff.reduction_stream(torch.from_numpy(x), 8)
    spec = tff.StreamSpec(base.n_words, base.producer, base.consumer,
                          base.init, finalize=lambda c: 2 * c)
    out = tff.run_reference(spec, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), 2 * x.sum(), rtol=1e-5)


def test_reduction_stream_refuses_ragged_tiles():
    with pytest.raises(ValueError, match="tile_rows"):
        tff.reduction_stream(torch.zeros(10, 4), 8)


def _footprint_cases():
    """The reference test's footprints (tests/test_core_feedforward.py):
    a RAW chain, disjoint reads, a WAR pair; and a RAW two words apart."""
    return {
        "raw": lambda F: [F(reads=(("out", t - 1, t),) if t else (),
                            writes=(("out", t, t + 1),)) for t in range(4)],
        "disjoint": lambda F: [F(reads=(("inp", 8 * t, 8 * t + 8),),
                                 writes=(("out", t, t + 1),))
                               for t in range(8)],
        "war": lambda F: [F(reads=(("buf", 0, 8),), writes=()),
                          F(reads=(), writes=(("buf", 0, 8),))],
        "raw_skip": lambda F: [F(reads=(), writes=(("a", 0, 4),)),
                               F(reads=(("b", 0, 4),), writes=()),
                               F(reads=(("a", 3, 9),), writes=())],
    }


@pytest.mark.parametrize("case", sorted(_footprint_cases()))
def test_check_no_mlcd_gives_the_reference_verdict_and_reason(case):
    make = _footprint_cases()[case]
    assert tff.check_no_mlcd(make(tff.Footprint)) == \
        jff.check_no_mlcd(make(jff.Footprint))


@pytest.mark.parametrize("n,s", [(10, 3), (1, 4), (64, 8), (7, 7)])
def test_split_words_static_matches_the_reference(n, s):
    assert tff.split_words_static(n, s) == jff.split_words_static(n, s)


@pytest.mark.parametrize("m,k,n,tk", [(4, 64, 32, 16), (17, 128, 40, 32),
                                      (1, 256, 8, 64)])
def test_matmul_plain_version_holds_to_the_ktiled_spec(m, k, n, tk):
    a, b = torch.from_numpy(_x((m, k), 3)), torch.from_numpy(_x((k, n), 4))
    want = tff.run_reference(tff.ktiled_product_spec(m, k, n, tk),
                              (a, b))
    got = matmul_ref(a, b, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,rows", [(24, 8), (13, 8), (64, 16)])
def test_gather_plain_version_holds_to_the_row_gather_spec(n, rows):
    table = torch.from_numpy(_x((50, 12), 5))
    idx = torch.from_numpy(
        np.random.default_rng(6).integers(0, 50, n).astype(np.int32))
    want = tff.run_reference(tff.row_gather_spec(n, 12, rows),
                              (table, idx))
    got = gather_ref(table, idx)
    assert torch.equal(got, want)
