"""The launch plan and the ring-pipe arguments of the port's matmul
(``repro_torch.kernels.ff_matmul``), on the CPU.

``_plan`` picks the path (tensor cores for bf16 x bf16, CUDA cores for the
rest), the tile and the k split from the shapes, types and SM count alone;
``depth`` and ``streams`` are checked as the reference's ``Pipe`` checks
them. The wrappers' CPU path (the plain version) is held against the
reference's ``matmul_ff`` at the same ``depth`` and ``streams`` within the
reference registry's float32 tolerance, 5e-4 relative and absolute.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipe import Pipe
from repro.kernels.ff_matmul.kernel import matmul_ff
from repro_torch.kernels.ff_matmul import (dispatch_matmul,
                                           dispatch_matmul_ref, matmul,
                                           matmul_ref)
from repro_torch.kernels.ff_matmul import ops as M

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132                      # the H100's SM count, passed in
F32_TOL = 5e-4


@pytest.mark.parametrize("m,n,k", [(64, 1408, 2048), (1, 5, 3000),
                                   (77, 133, 70), (300, 1000, 1024),
                                   (4096, 4096, 4096)])
def test_gathered_and_plain_launch_take_the_same_plan(monkeypatch, m, n, k):
    """The wrapper hands the kernel the same split whether A's rows come
    through an index or not (the gathered launch then sums as the plain
    one does)."""
    seen = []

    def fake_entry(*key):
        return lambda *args: seen.append((key, args)) or 0

    monkeypatch.setattr(M, "_entry", fake_entry)
    monkeypatch.setattr(M, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(M._build, "stream_ptr", lambda device: 0)
    a, b = torch.zeros(m, k, dtype=BF16), torch.zeros(k, n, dtype=BF16)
    M._launch(a, None, b, m, BF16, 4, 1)
    M._launch(a, torch.zeros(m, dtype=torch.int32), b, m, BF16, 4, 1)
    (plain_key, plain), (gath_key, gath) = seen
    assert plain_key[0] == gath_key[0] == "wgmma"
    split = M._plan(m, n, k, BF16, BF16, SMS).split
    # (..., depth, streams, split, stream): the same split, depth, streams
    assert plain[-4:-1] == gath[-4:-1] == (4, 1, split)


def test_moe_dispatch_shape_fills_the_sms():
    """deepseek-v2-lite's dispatch (64 rows, d_model 2048 into d_ff 1408,
    chip_smoke.py LIB["moe"]) has 11 output tiles; the split fills the
    SMs it is given."""
    for sms in (SMS, 114, 80):
        plan = M._plan(64, 1408, 2048, BF16, BF16, sms)
        tiles = -(-64 // plan.tile[0]) * -(-1408 // plan.tile[1])
        assert plan.split > 1 and tiles * plan.split >= sms


@pytest.mark.parametrize("k", [1, 64, 70, 128, 256])
@pytest.mark.parametrize("m,n", [(1, 1), (64, 128), (8192, 64)])
def test_small_k_is_never_split(m, n, k):
    """attention_proj's head dims (k <= 128, and up to the attention's 256)
    never split: its fused launch must equal the staged matmul."""
    assert M._plan(m, n, k, BF16, BF16, SMS).split == 1


def test_large_outputs_are_not_split():
    assert M._plan(4096, 4096, 4096, BF16, BF16, SMS).split == 1
    assert M._plan(1024, 5632, 1024, BF16, BF16, SMS).split == 1


@pytest.mark.parametrize("ta,tb", [(BF16, BF16), (F32, F32), (F32, BF16),
                                   (BF16, F32)])
def test_types_choose_the_path(ta, tb):
    plan = M._plan(64, 1408, 2048, ta, tb, SMS)
    if ta == tb == BF16:
        assert plan.path == "wgmma" and plan.tile == (128, 128, 64)
    else:
        assert plan.path == "fma" and plan.split == 1


def _pipe_raises(depth, streams):
    """Does the reference's Pipe refuse these values for either of this
    kernel's tiles (A [128, 64], B [64, 128])?"""
    try:
        Pipe(tile=(128, 64), dtype=jnp.bfloat16, depth=depth,
             streams=streams)
        Pipe(tile=(64, 128), dtype=jnp.bfloat16, depth=depth,
             streams=streams)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("depth,streams", itertools.product(
    [-1, 0, 1, 2, 3, M.MAX_DEPTH], [-2, 0, 1, 2, 3, 4, 5, 8, 48, 128]))
def test_depth_and_streams_are_checked_as_the_reference_pipe(depth,
                                                              streams):
    a, b = torch.ones(4, 8, dtype=BF16), torch.ones(8, 3, dtype=BF16)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    kw = dict(depth=depth, streams=streams)
    calls = ((lambda: matmul(a, b, **kw), matmul_ref(a, b)),
             (lambda: matmul(a.float(), b, **kw), matmul_ref(a.float(), b)),
             (lambda: dispatch_matmul(a, idx, b, **kw),
              dispatch_matmul_ref(a, idx, b)))
    for call, want in calls:
        if _pipe_raises(depth, streams):
            with pytest.raises(ValueError):
                call()
        elif streams <= 8:         # sub-copies of at least 8 rows
            assert torch.equal(call(), want)


def test_depth_beyond_shared_memory_raises():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    assert M._smem_bytes(M.MAX_DEPTH) <= M._MAX_SMEM
    assert M._smem_bytes(M.MAX_DEPTH + 1) > M._MAX_SMEM
    with pytest.raises(ValueError):
        matmul(a, b, depth=M.MAX_DEPTH + 1)


@pytest.mark.parametrize("depth,streams", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_matmul_matches_reference_matmul_ff(depth, streams):
    rng = np.random.default_rng(depth * 10 + streams)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    out = matmul(torch.from_numpy(a), torch.from_numpy(b), depth=depth,
                 streams=streams)
    ref = matmul_ff(jnp.asarray(a), jnp.asarray(b), depth=depth,
                    streams=streams, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)
