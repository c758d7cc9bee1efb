"""The port's VLM (internvl2-1b at smoke size: stubbed patch embeddings
projected by ``vision_proj`` and put before the tokens) against the JAX
reference, with the reference's parameters carried across by
``params_from_jax``.

- Prefill with ``image_embeds`` (logits and the K/V cache over patches
  plus tokens), then 3 greedy decode steps, under ``attn_impl`` "ff" and
  "xla": f32 logits within 2e-4, the same tokens.
- Prefill without ``image_embeds`` is the dense LM's, bit for bit, and
  the reference's within 2e-4.
- The port's copy of the reference's
  ``test_serving.py::test_decode_matches_full_forward`` for internvl2-1b:
  incremental decode against teacher-forced prefills of each prefix, at
  the reference's tolerance (2e-2) and argmax agreement.

The reference runs its Pallas kernels in interpret mode outside
``use_sharding`` (see test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax

ARCH = "internvl2_1b"
PAGE = 8
TOL = 2e-4
N_STEPS = 3
POLICY = PipePolicy(mode="ff", interpret=True)
B, S = 2, 6


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.fixture(scope="module", params=["ff", "xla"])
def pair(request):
    impl = request.param
    pin = dict(decode_block_kv=PAGE) if impl == "ff" else {}
    jcfg = j_smoke(ARCH).replace(attn_impl=impl, remat="none", **pin)
    tcfg = t_smoke(ARCH).replace(attn_impl=impl, **pin)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jcfg.vocab, size=(B, S)).astype(np.int32)
    image = rng.standard_normal((B, jcfg.n_patches, jcfg.d_model)
                                ).astype(np.float32)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                tmodel=t_build(tcfg), tparams=tparams, tokens=toks,
                image=image)


def _run(prefill, decode, params, batch, n_prefix, put, pad):
    """Prefill ``batch``, then N_STEPS greedy steps from its logits."""
    logits, cache = prefill(params, batch)
    out, toks = [np.asarray(logits)], []
    first = {k: np.asarray(v) for k, v in cache.items()}
    cache = pad(cache, n_prefix, n_prefix + N_STEPS, 2)
    cur = put(np.asarray(np.argmax(np.asarray(logits), -1), np.int32))
    lengths = put(np.full(B, n_prefix, np.int32))
    for _ in range(N_STEPS):
        cur, lg, cache = decode(params, {"token": cur, "lengths": lengths},
                                cache)
        out.append(np.asarray(lg))
        toks.append(np.asarray(cur))
        lengths = lengths + 1
    return out, first, np.stack(toks, 1)


def _both(pair, with_image):
    jb = {"tokens": jnp.asarray(pair["tokens"])}
    tb = {"tokens": torch.from_numpy(pair["tokens"])}
    n = S
    if with_image:
        jb["image_embeds"] = jnp.asarray(pair["image"])
        tb["image_embeds"] = torch.from_numpy(pair["image"])
        n += pair["jcfg"].n_patches
    ref = _run(jax.jit(j_steps.make_prefill_step(pair["jmodel"],
                                                 policy=POLICY)),
               jax.jit(j_steps.make_decode_step(pair["jmodel"],
                                                policy=POLICY)),
               pair["jparams"], jb, n, jnp.asarray, j_serve.pad_cache_to)
    got = _run(t_steps.make_prefill_step(pair["tmodel"]),
               t_steps.make_decode_step(pair["tmodel"]), pair["tparams"], tb,
               n, torch.from_numpy, t_serve.pad_cache_to)
    return ref, got, n


@pytest.mark.parametrize("with_image", [True, False],
                         ids=["image", "text"])
def test_prefill_and_decode_match_reference(pair, with_image):
    (jlog, jcache, jtoks), (tlog, tcache, ttoks), n = _both(pair,
                                                            with_image)
    cfg = pair["tcfg"]
    assert tcache["k"].shape == (cfg.n_layers, B, n, cfg.n_kv_heads, cfg.hd)
    for name in ("k", "v"):
        _close(torch.from_numpy(tcache[name]), jcache[name])
    for t, j in zip(tlog, jlog):
        _close(torch.from_numpy(t), j)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_text_prefill_is_the_dense_lm(pair):
    """Without ``image_embeds`` the VLM is the dense LM on the same
    parameters (``vision_proj`` unread), bit for bit."""
    cfg = pair["tcfg"]
    dense = t_build(cfg.replace(family="dense"))
    params = {k: v for k, v in pair["tparams"].items() if k != "vision_proj"}
    assert set(params) == set(dense.param_specs())
    batch = {"tokens": torch.from_numpy(pair["tokens"])}
    a, ca = pair["tmodel"].prefill(pair["tparams"], batch)
    b, cb = dense.prefill(params, batch)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


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
    image = torch.randn(2, cfg.n_patches, cfg.d_model, generator=gen)
    ref = torch.stack([
        model.prefill(params, {"tokens": tokens[:, :t],
                               "image_embeds": image})[0]
        for t in range(PROMPT, TOTAL)], dim=1)
    extra = cfg.n_patches
    logits, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT],
                                           "image_embeds": image})
    cache = t_serve.pad_cache_to(cache, PROMPT + extra, TOTAL + extra, 2)
    got = [logits]
    lengths = torch.full((2,), PROMPT + extra, dtype=torch.int32)
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
