"""The port's encoder-decoder (whisper-tiny at smoke size: stubbed frame
embeddings, a non-causal encoder, a decoder with cross-attention) against
the JAX reference, with the reference's parameters carried across by
``params_from_jax``.

- ``sinusoidal_positions`` equal to the reference's bit for bit, at the
  smoke and the full-width shapes and at the size of ``dec_pos``;
- ``encode`` within 2e-4;
- prefill (logits, the self and cross K/V caches) and 3 greedy decode
  steps within 2e-4 with the same tokens; the cache's shapes are
  ``cache_spec``'s;
- ``cast_params`` keeps every LayerNorm leaf in f32 (bf16 compute), and
  the cast-once logits equal the per-use-cast ones bit for bit;
- the port's copy of the reference's
  ``test_serving.py::test_decode_matches_full_forward`` for whisper-tiny.

Every attention of the reference's ``encdec`` is its unfused "xla" path
whatever ``attn_impl`` says; so is the port's (no kernel on this path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import encdec as t_encdec
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_jax

ARCH = "whisper_tiny"
TOL = 2e-4
N_STEPS = 3
B, S = 2, 7
SEQ_DIMS = {"self": 2, "cross": None}


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,d", [(16, 64), (1500, 384), (29, 6),
                                 (36864, 384)])
def test_sinusoidal_positions_bitwise(s, d):
    want = np.asarray(j_layers.sinusoidal_positions(s, d))
    got = t_layers.sinusoidal_positions(s, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(ARCH).replace(remat="none")
    tcfg = t_smoke(ARCH)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jcfg.vocab, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.n_frames, jcfg.d_model)
                                 ).astype(np.float32)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                tmodel=t_build(tcfg), tparams=tparams, tokens=toks,
                frames=frames)


def test_encode_matches_reference(pair):
    want = j_encdec.encode(pair["jcfg"], pair["jparams"]["encdec"],
                           jnp.asarray(pair["frames"]))
    got = t_encdec.encode(pair["tcfg"], pair["tparams"]["encdec"],
                          torch.from_numpy(pair["frames"]))
    assert got.shape == (B, pair["tcfg"].n_frames, pair["tcfg"].d_model)
    _close(got, want)


def _flat(cache):
    return {f"{kind}.{name}": np.asarray(x)
            for kind, sub in cache.items() for name, x in sub.items()}


def test_prefill_and_decode_match_reference(pair):
    jpre = jax.jit(j_steps.make_prefill_step(pair["jmodel"]))
    jdec = jax.jit(j_steps.make_decode_step(pair["jmodel"]))
    tpre = t_steps.make_prefill_step(pair["tmodel"])
    tdec = t_steps.make_decode_step(pair["tmodel"])
    jl, jc = jpre(pair["jparams"], {"tokens": jnp.asarray(pair["tokens"]),
                                    "frames": jnp.asarray(pair["frames"])})
    tl, tc = tpre(pair["tparams"], {"tokens": torch.from_numpy(
        pair["tokens"]), "frames": torch.from_numpy(pair["frames"])})
    _close(tl, jl)
    spec, _ = t_encdec.cache_spec(pair["tcfg"], B, S)
    got, want = _flat(tc), _flat(jc)
    assert set(got) == set(want) == {"self.k", "self.v", "cross.k",
                                     "cross.v"}
    for key, x in got.items():
        kind, name = key.split(".")
        assert x.shape == spec[kind][name].shape == want[key].shape
        _close(x, want[key])
    jc = {"self": jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, N_STEPS), (0, 0),
                              (0, 0)]), jc["self"]), "cross": jc["cross"]}
    tc = t_serve.pad_cache_to(tc, S, S + N_STEPS, SEQ_DIMS)
    jcur = jnp.argmax(jl, -1).astype(jnp.int32)
    tcur = torch.argmax(tl, -1).to(torch.int32)
    lengths = np.full(B, S, np.int32)
    for _ in range(N_STEPS):
        jcur, jl, jc = jdec(pair["jparams"], {
            "token": jcur, "lengths": jnp.asarray(lengths)}, jc)
        tcur, tl, tc = tdec(pair["tparams"], {
            "token": tcur, "lengths": torch.from_numpy(lengths)}, tc)
        _close(tl, jl)
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        lengths = lengths + 1
    for key, x in _flat(tc).items():
        _close(x, _flat(jc)[key])


def test_cast_params_keeps_every_layernorm_f32():
    """At bf16 compute the 7 LayerNorm groups (encoder norm1/norm2 and
    final norm, decoder norm1/norm_x/norm2 and final norm: 14 leaves)
    stay f32; every other leaf is cast; the logits of the cast tree equal
    the uncast tree's bit for bit (prefill and one decode step)."""
    cfg = t_smoke(ARCH).replace(compute_dtype="bfloat16")
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for path, leaf in t_layers.tree_leaves(params):
        if len(path) > 1 and "norm" in path[-2]:
            leaf.normal_(generator=gen)      # not the ones/zeros init
    cast = model.cast_params(params)
    kept = [p for p, x in t_layers.tree_leaves(cast)
            if x.dtype == torch.float32]
    assert len(kept) == 14 and all("norm" in "".join(p) for p in kept)
    assert all(x.dtype == torch.bfloat16
               for p, x in t_layers.tree_leaves(cast) if p not in kept)
    toks = torch.tensor([[3, 17, 9, 40], [2, 5, 8, 1]], dtype=torch.int32)
    frames = torch.randn(2, cfg.n_frames, cfg.d_model, generator=gen
                         ).to(cfg.cdtype)   # the reference's input spec
    batch = {"tokens": toks, "frames": frames}
    step = {"token": toks[:, -1], "lengths": torch.tensor([4, 4],
                                                          dtype=torch.int32)}
    outs = []
    for prm in (params, cast):
        logits, cache = model.prefill(prm, batch)
        cache = t_serve.pad_cache_to(cache, 4, 5, SEQ_DIMS)
        outs.append((logits, model.decode_step(prm, step, cache)[0]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# the port's copy of test_serving.py::test_decode_matches_full_forward
# ---------------------------------------------------------------------------


PROMPT, TOTAL = 24, 29


def test_decode_matches_full_forward():
    cfg = t_smoke(ARCH)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (2, TOTAL), generator=gen,
                           dtype=torch.int32)
    frames = torch.randn(2, cfg.n_frames, cfg.d_model, generator=gen)
    ref = torch.stack([
        model.prefill(params, {"tokens": tokens[:, :t],
                               "frames": frames})[0]
        for t in range(PROMPT, TOTAL)], dim=1)
    logits, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT],
                                           "frames": frames})
    cache = t_serve.pad_cache_to(cache, PROMPT, TOTAL, SEQ_DIMS)
    got = [logits]
    lengths = torch.full((2,), PROMPT, dtype=torch.int32)
    for t in range(PROMPT, TOTAL - 1):
        logits, cache = model.decode_step(
            params, {"token": tokens[:, t], "lengths": lengths}, cache)
        got.append(logits)
        lengths = lengths + 1
    got = torch.stack(got, dim=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree > 0.95, agree


def test_full_width_specs():
    """The full-width tree: ``dec_pos`` [36864, 384] drawn "small", 4
    encoder and 4 decoder layers, a GELU MLP with biases."""
    cfg = t_config(ARCH)
    s = t_build(cfg).param_specs()
    pos = s["encdec"]["dec_pos"]
    assert pos.shape == (36864, 384) and pos.init == "small"
    assert s["encdec"]["enc_layers"]["ffn"]["bi"].shape == (4, 1536)
    assert s["encdec"]["dec_layers"]["cross_attn"]["wq"].shape == (4, 384,
                                                                   6, 64)
