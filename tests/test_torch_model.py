"""The port's dense decoder against the JAX reference on the smoke
qwen1.5-0.5B config, with the reference's own random parameters carried
across by ``params_from_jax``.

The reference runs its Pallas kernels in interpret mode outside
``use_sharding`` (under the installed jax its host mesh makes ``constrain``
raise; outside it ``constrain`` is a no-op). Tolerance 2e-4 on logits and
caches: the attention kernels' registry tolerance, carried through two
layers of f32 matmuls. Greedy tokens must be equal.
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
from repro.runtime.paged_kv import PagedKVCache as JPaged
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_config as t_config
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.paged_kv import PagedKVCache as TPaged

ARCH = "qwen1_5_0p5b"
PAGE = 8
TOL = 2e-4
N_STEPS = 3
POLICY = PipePolicy(mode="ff", interpret=True)
LENS = np.array([5, 12], np.int32)


@pytest.fixture(scope="module")
def models():
    jcfg = j_smoke(ARCH).replace(attn_impl="ff", decode_block_kv=PAGE,
                                 remat="none")
    tcfg = t_smoke(ARCH).replace(decode_block_kv=PAGE)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jmodel, jparams, tcfg, t_build(tcfg), tparams


@pytest.fixture(scope="module")
def tokens(models):
    rng = np.random.default_rng(6)
    toks = np.zeros((len(LENS), int(LENS.max())), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, models[0].vocab, size=n)
    return toks


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_params_from_jax_checks_the_tree(models):
    jcfg, _, jparams, tcfg, tmodel, tparams = models
    assert tparams["stack"]["layers"]["mixer"]["wq"].shape == \
        jparams["stack"]["layers"]["mixer"]["wq"].shape
    tree = jax.tree.map(np.asarray, jparams)
    del tree["unembed"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, tcfg)


def test_prefill_logits_and_cache_match_reference(models, tokens):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    jlog, jcache = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))(
        jparams, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = t_steps.make_prefill_step(tmodel)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert tlog.shape == (len(LENS), tcfg.padded_vocab)
    _close(tlog, jlog)
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name])


def _jax_decode(jcfg, jmodel, jparams, tokens, paged):
    prefill = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))
    decode = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    p_max = tokens.shape[1]
    n_pages = -(-(p_max + N_STEPS) // PAGE)
    _, dense = prefill(jparams, {"tokens": jnp.asarray(tokens)})
    if paged:
        kv = JPaged(n_layers=jcfg.n_layers, n_blocks=len(LENS) * n_pages + 1,
                    page=PAGE, kv_heads=jcfg.n_kv_heads, head_dim=jcfg.hd,
                    n_slots=len(LENS), n_pages_max=n_pages,
                    dtype=jcfg.cdtype)
        for i, n in enumerate(LENS):
            kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                     n_pages * PAGE)
        cache = kv.cache_view()
    else:
        cache = j_serve.pad_cache_to(dense, p_max, n_pages * PAGE, 2)
    cur = jnp.asarray(tokens[np.arange(len(LENS)), LENS - 1])
    lengths = jnp.asarray(LENS - 1)
    logits, toks = [], []
    for _ in range(N_STEPS):
        cur, lg, cache = decode(jparams, {"token": cur, "lengths": lengths},
                                cache)
        logits.append(np.asarray(lg))
        toks.append(np.asarray(cur))
        lengths = lengths + 1
    return logits, np.stack(toks, 1)


def _port_decode(tcfg, tmodel, tparams, tokens, paged):
    prefill = t_steps.make_prefill_step(tmodel)
    decode = t_steps.make_decode_step(tmodel)
    p_max = tokens.shape[1]
    n_pages = -(-(p_max + N_STEPS) // PAGE)
    _, dense = prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    if paged:
        kv = TPaged(n_layers=tcfg.n_layers, n_blocks=len(LENS) * n_pages + 1,
                    page=PAGE, kv_heads=tcfg.n_kv_heads, head_dim=tcfg.hd,
                    n_slots=len(LENS), n_pages_max=n_pages,
                    dtype=tcfg.cdtype)
        for i, n in enumerate(LENS):
            kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                     n_pages * PAGE)
        cache = kv.cache_view()
    else:
        cache = t_serve.pad_cache_to(dense, p_max, n_pages * PAGE, 2)
    cur = torch.from_numpy(tokens[np.arange(len(LENS)), LENS - 1])
    lengths = torch.from_numpy(LENS - 1)
    logits, toks = [], []
    for _ in range(N_STEPS):
        cur, lg, cache = decode(tparams, {"token": cur, "lengths": lengths},
                                cache)
        logits.append(lg)
        toks.append(cur.numpy())
        lengths = lengths + 1
    return logits, np.stack(toks, 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_steps_match_reference(models, tokens, paged):
    """Three greedy decode steps: logits within 2e-4 and the same tokens,
    through the dense cache and through the paged pool."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = models
    jlogits, jtoks = _jax_decode(jcfg, jmodel, jparams, tokens, paged)
    tlogits, ttoks = _port_decode(tcfg, tmodel, tparams, tokens, paged)
    for tl, jl in zip(tlogits, jlogits):
        _close(tl, jl)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_port_paged_equals_dense_bitwise(models, tokens):
    _, _, _, tcfg, tmodel, tparams = models
    dense_logits, dense_toks = _port_decode(tcfg, tmodel, tparams, tokens,
                                            paged=False)
    paged_logits, paged_toks = _port_decode(tcfg, tmodel, tparams, tokens,
                                            paged=True)
    for d, p in zip(dense_logits, paged_logits):
        assert torch.equal(d, p)
    np.testing.assert_array_equal(dense_toks, paged_toks)


def test_build_model_refuses_unported_families(models):
    """Every family is ported now: encdec and vlm build (as every config
    of the reference does, smoke and full width); an unknown family,
    attn_impl or scan_impl is an error; MLA runs only under "xla" (its v
    head dim is not q's); serve_bench refuses encdec (whisper-tiny), as
    the reference's does."""
    tcfg = models[3]
    for family, cls in (("encdec", "EncDecLM"), ("vlm", "VLM")):
        assert type(t_build(tcfg.replace(family=family))).__name__ == cls
    for arch in ARCH_IDS:
        for cfg in (t_smoke(arch), t_config(arch)):
            assert t_build(cfg).param_specs()
    with pytest.raises(ValueError, match="family"):
        t_build(tcfg.replace(family="diffusion"))
    with pytest.raises(ValueError, match="attn_impl"):
        t_build(tcfg.replace(attn_impl="pallas"))
    with pytest.raises(ValueError, match="scan_impl"):
        t_build(tcfg.replace(scan_impl="tiled"))
    with pytest.raises(ValueError, match="MLA"):
        t_build(t_smoke("deepseek_v2_lite_16b").replace(attn_impl="ff"))
    assert type(t_build(tcfg.replace(attn_impl="xla"))).__name__ == "DenseLM"
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    with pytest.raises(SystemExit, match="decoder-only"):
        t_serve.serve_bench(ap.parse_args(
            ["--arch", "whisper_tiny", "--smoke", "--device", "cpu"]))
