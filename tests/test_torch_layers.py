"""repro_torch.models.layers against repro.models.layers on the same numpy
inputs (f32, CPU). Tolerance 1e-5: the two frameworks reduce in other
orders (rsqrt, mean, matmul), nothing else differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ref = JL.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w))
    port = TL.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w))
    assert port.dtype == getattr(torch, dtype)
    # bf16 output: one bf16 ulp of slack for a rounding-boundary flip
    tol = TOL if dtype == "float32" else 2 ** -7
    _close(port.float(), np.asarray(ref.astype(jnp.float32)), tol)


@pytest.mark.parametrize("decode", [False, True])
def test_rope(decode):
    rng = _rng(1)
    b, s, h, d = 2, 6, 4, 16
    theta = 1e6
    if decode:
        s = 1
        pos = np.array([[7], [30]], np.int32)          # [B, 1]
    else:
        pos = np.arange(s, dtype=np.int32)              # [S]
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    port = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(port, ref)


def test_swiglu_mlp():
    rng = _rng(2)
    d, f = 64, 128
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {"wi": (rng.standard_normal((d, 2 * f)) / 8).astype(np.float32),
         "wo": (rng.standard_normal((f, d)) / 11).astype(np.float32)}
    ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), "swiglu")
    port = TL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), "swiglu")
    _close(port, ref)


def test_embed_and_unembed_padded_vocab():
    rng = _rng(3)
    vocab, d = 256, 32
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    toks = rng.integers(0, vocab, size=(2, 5)).astype(np.int32)
    ref = JL.embed_lookup(jnp.asarray(table), jnp.asarray(toks), jnp.float32)
    port = TL.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks),
                           torch.float32)
    _close(port, ref)
    un = rng.standard_normal((vocab, d)).astype(np.float32)
    ref_l = JL.unembed_logits(ref, jnp.asarray(un))
    port_l = TL.unembed_logits(port, torch.from_numpy(un))
    assert tuple(port_l.shape) == (2, 5, vocab)
    _close(port_l, ref_l)


def test_param_spec_init_scales_and_order():
    """Same fan-in scales as the reference (stacked layer dim skipped);
    the tree is drawn in the reference's sorted-key order."""
    specs = {"b": TL.ParamSpec((4, 64, 8), ("layers", "embed", None)),
             "a": TL.ParamSpec((16,), ("embed",), init="ones"),
             "c": TL.ParamSpec((1000, 32), ("vocab", "embed"), scale=0.02)}
    params = TL.init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert [p for p, _ in TL.tree_leaves(params)] == [("a",), ("b",), ("c",)]
    assert torch.equal(params["a"], torch.ones(16))
    assert abs(params["b"].std().item() - 1 / 8) < 0.01     # 1/sqrt(64)
    assert abs(params["c"].std().item() - 0.02) < 0.002
    again = TL.init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["b"], again["b"])
