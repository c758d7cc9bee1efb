"""The port's MLA mixer and the smoke deepseek-v2-lite model (MLA and the
MoE FFN) against the JAX reference, with the reference's own random
parameters carried across.

- ``mla_apply`` at prefill (causal attention under ``"xla"``, v's head
  dim 16 against q's 24) and at three decode steps on the latent cache
  (written at ``lengths``, including a length past the cache, which both
  sides clamp), within 1e-5 (f32; the same formula, the libraries'
  reduction orders).
- The smoke model through ``launch/steps.py``: prefill logits and both
  cache leaves, then 3 greedy decode steps on the cache padded on its
  sequence axis, logits within 1e-4 and tokens equal.
- The latent cache matches ``cache_spec``; the serve schedulers refuse
  the family (they keep a K/V cache); MLA under ``"ff"`` is refused.

The reference runs outside ``use_sharding`` (see test_torch_model.py).
"""

import argparse

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
from repro.models import layers as JL
from repro.models import mla as jmla
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import mla as tmla
from repro_torch.models.convert import params_from_jax

ARCH = "deepseek_v2_lite_16b"
LAYER_TOL, MODEL_TOL = 1e-5, 1e-4
POLICY = PipePolicy(mode="ff", interpret=True)
B, S, S_MAX, N_STEPS = 2, 12, 16, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def layer():
    jcfg = j_smoke(ARCH)
    tcfg = t_smoke(ARCH)
    jp = JL.init_params(jmla.mla_specs(jcfg), jax.random.key(0))
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_mla_prefill_matches_reference(layer):
    jcfg, tcfg, jp, tp, x = layer
    pos = np.arange(S)
    jout, jcache = jmla.mla_apply(jcfg, jp, jnp.asarray(x),
                                  positions=jnp.asarray(pos))
    tout, tcache = tmla.mla_apply(tcfg, tp, _t(x), positions=_t(pos))
    _close(tout, jout, LAYER_TOL)
    for name in ("c", "k_rope"):
        _close(tcache[name], jcache[name], LAYER_TOL)


def test_mla_decode_matches_reference(layer):
    """Three steps on a cache of 16 rows after a 12-token prefill; row 1
    starts at length 15, so its third write lands past the cache (both
    sides clamp it to the last row)."""
    jcfg, tcfg, jp, tp, x = layer
    _, jcache = jmla.mla_apply(jcfg, jp, jnp.asarray(x),
                               positions=jnp.arange(S))
    jcache = {k: jnp.pad(v, ((0, 0), (0, S_MAX - S), (0, 0)))
              for k, v in jcache.items()}
    tcache = {k: _t(np.asarray(v)) for k, v in jcache.items()}
    lengths = np.array([S, S_MAX - 1], np.int32)
    rng = np.random.default_rng(1)
    for _ in range(N_STEPS):
        xt = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jmla.mla_apply(
            jcfg, jp, jnp.asarray(xt), positions=jnp.asarray(lengths)[:, None],
            cache=jcache, lengths=jnp.asarray(lengths))
        tout, tcache = tmla.mla_apply(
            tcfg, tp, _t(xt), positions=_t(lengths)[:, None], cache=tcache,
            lengths=_t(lengths))
        _close(tout, jout, LAYER_TOL)
        for name in ("c", "k_rope"):
            _close(tcache[name], jcache[name], LAYER_TOL)
        lengths = lengths + 1


@pytest.fixture(scope="module")
def run():
    """Both sides' prefill and three greedy decode steps."""
    jcfg = j_smoke(ARCH).replace(remat="none")
    tcfg = t_smoke(ARCH)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    tmodel = t_build(tcfg)
    toks = np.random.default_rng(2).integers(
        1, jcfg.vocab, size=(B, S)).astype(np.int32)
    jlog, jcache = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlog, tcache = t_steps.make_prefill_step(tmodel)(
        tparams, {"tokens": torch.from_numpy(toks)})
    prefill = (tlog, tcache, jlog, jcache)
    jdecode = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    tdecode = t_steps.make_decode_step(tmodel)
    jc = j_serve.pad_cache_to(jcache, S, S_MAX, 2)
    tc = t_serve.pad_cache_to(tcache, S, S_MAX, 2)
    jcur = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    tcur = torch.argmax(tlog, dim=-1).to(torch.int32)
    lengths = np.full(B, S, np.int32)
    steps = []
    for _ in range(N_STEPS):
        jcur, jl, jc = jdecode(jparams, {"token": jcur,
                                         "lengths": jnp.asarray(lengths)}, jc)
        tcur, tl, tc = tdecode(tparams, {"token": tcur,
                                         "lengths": torch.from_numpy(lengths)},
                               tc)
        steps.append((tl.clone(), tcur.numpy(), np.asarray(jl),
                      np.asarray(jcur)))
        lengths = lengths + 1
    return tcfg, prefill, steps, (tc, jc)


def test_deepseek_prefill_logits_and_cache_match_reference(run):
    _, (tlog, tcache, jlog, jcache), _, _ = run
    _close(tlog, jlog, MODEL_TOL)
    assert sorted(tcache) == sorted(jcache) == ["c", "k_rope"]
    for name in tcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name], MODEL_TOL)


def test_deepseek_decode_steps_match_reference(run):
    _, _, steps, (tc, jc) = run
    for tl, ttok, jl, jtok in steps:
        _close(tl, jl, MODEL_TOL)
        np.testing.assert_array_equal(ttok, jtok)
    for name in tc:
        _close(tc[name], jc[name], MODEL_TOL)


def test_latent_cache_matches_its_spec(run):
    tcfg, (_, tcache, _, _), _, _ = run
    spec, axes = t_build(tcfg).stack.cache_spec(B, S)
    assert {k: (tuple(s.shape), s.dtype) for k, s in spec.items()} == \
        {k: (tuple(c.shape), c.dtype) for k, c in tcache.items()}
    assert axes == {"c": ("layers", "batch", "kv", None),
                    "k_rope": ("layers", "batch", "kv", None)}


def test_serve_refuses_the_latent_cache():
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    args = ap.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="make_prefill_step"):
        t_serve.serve_bench(args)
