"""The port's ``--layer-graph`` decode path against the JAX reference on
the smoke qwen1.5-0.5B config, with the reference's own random parameters
carried across by ``params_from_jax``.

With ``layer_graph=True`` every dense-cache decode step runs each layer
through ``decode_layer`` (q-projection, attention, the MLP tail); the
paged scheduler keeps the per-op path. The reference runs in interpret
mode outside ``use_sharding`` (see test_torch_model.py), once per module.

Tolerances: float32 2e-4 on logits (the kernels' registry tolerance
carried through two layers of f32 matmuls), bfloat16 2e-2 (a bf16
rounding either side of a boundary moves a value by 2**-8 relative).
Greedy tokens and the schedulers' token counts and decode steps must be
equal. The graph rounds at other points than the per-op layer, so in bf16
dense and paged decode differ a little (the reference's do too); in
float32 they agree within 1e-5.
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
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax

ARCH = "qwen1_5_0p5b"
PAGE, SLOTS, N_STEPS = 8, 2, 3
POLICY = PipePolicy(mode="ff", interpret=True)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = list(TOL)
LENS = np.array([5, 12], np.int32)
KEYS = ("tokens", "decode_steps")


def _models(dtype):
    jcfg = j_smoke(ARCH).replace(attn_impl="ff", decode_block_kv=PAGE,
                                 remat="none", layer_graph=True,
                                 compute_dtype=dtype)
    tcfg = t_smoke(ARCH).replace(decode_block_kv=PAGE, layer_graph=True,
                                 compute_dtype=dtype)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jmodel, jparams, tcfg, t_build(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return {dtype: _models(dtype) for dtype in DTYPES}


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(6)
    toks = np.zeros((len(LENS), int(LENS.max())), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, j_smoke(ARCH).vocab, size=n)
    return toks


def _jax_decode(jmodel, jparams, tokens):
    prefill = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))
    decode = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    p_max = tokens.shape[1]
    _, dense = prefill(jparams, {"tokens": jnp.asarray(tokens)})
    cache = j_serve.pad_cache_to(dense, p_max,
                                 -(-(p_max + N_STEPS) // PAGE) * PAGE, 2)
    cur = jnp.asarray(tokens[np.arange(len(LENS)), LENS - 1])
    lengths = jnp.asarray(LENS - 1)
    logits, toks = [], []
    for _ in range(N_STEPS):
        cur, lg, cache = decode(jparams, {"token": cur, "lengths": lengths},
                                cache)
        logits.append(np.asarray(lg.astype(jnp.float32)))
        toks.append(np.asarray(cur))
        lengths = lengths + 1
    return logits, np.stack(toks, 1)


def _port_decode(tmodel, tparams, tokens, feed=None):
    """The port's three decode steps; with ``feed`` ([B, N_STEPS]) step i+1
    takes ``feed[:, i]`` as its input token instead of its own greedy
    one."""
    prefill = t_steps.make_prefill_step(tmodel)
    decode = t_steps.make_decode_step(tmodel)
    p_max = tokens.shape[1]
    _, dense = prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    cache = t_serve.pad_cache_to(dense, p_max,
                                 -(-(p_max + N_STEPS) // PAGE) * PAGE, 2)
    cur = torch.from_numpy(tokens[np.arange(len(LENS)), LENS - 1])
    lengths = torch.from_numpy(LENS - 1)
    logits, toks = [], []
    for _ in range(N_STEPS):
        cur, lg, cache = decode(tparams, {"token": cur, "lengths": lengths},
                                cache)
        logits.append(lg.float())
        toks.append(cur.numpy())
        if feed is not None:
            cur = torch.from_numpy(feed[:, len(toks) - 1])
        lengths = lengths + 1
    return logits, np.stack(toks, 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_graph_decode_matches_reference(models, tokens, dtype):
    """Three greedy decode steps through the layer graph, the port fed the
    reference's tokens: logits within the dtype's tolerance, and the same
    greedy token wherever the reference's top two logits are further
    apart than the tolerance allows the two to differ (in bf16 the smoke
    model has near ties)."""
    _, jmodel, jparams, _, tmodel, tparams = models[dtype]
    jlogits, jtoks = _jax_decode(jmodel, jparams, tokens)
    tlogits, ttoks = _port_decode(tmodel, tparams, tokens, feed=jtoks)
    tol = TOL[dtype]
    for step, (tl, jl) in enumerate(zip(tlogits, jlogits)):
        np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol * (1 + np.abs(top2[:, 1]))
        np.testing.assert_array_equal(ttoks[clear, step], jtoks[clear, step])
    if dtype == "float32":
        np.testing.assert_array_equal(ttoks, jtoks)


def test_layer_graph_routes_only_dense_decode(models, tokens, monkeypatch):
    """Each dense decode step calls decode_layer once per layer; prefill
    and the paged pool keep the per-op layer."""
    _, _, _, tcfg, tmodel, tparams = models["float32"]
    calls = []
    real = TL.decode_layer

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(TL, "decode_layer", counted)
    _port_decode(tmodel, tparams, tokens)
    assert calls == [(len(LENS), tcfg.d_model)] * (N_STEPS * tcfg.n_layers)
    calls.clear()
    t_serve.decode_parity_probe(tmodel, tparams, tcfg, page=PAGE,
                                n_steps=1)
    assert len(calls) == tcfg.n_layers          # the dense half only


@pytest.fixture(scope="module")
def served(models):
    """The reference's schedulers under the layer graph, f32, over the
    3-request trace, without and with an EOS that bites."""
    jcfg, jmodel, jparams, _, _, _ = models["float32"]
    reqs = j_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=jcfg.vocab, seed=0)
    prompt = reqs[0].prompt
    toks = np.zeros((1, j_serve._bucket(len(prompt))), np.int32)
    toks[0, :len(prompt)] = prompt
    jt = _jax_first_token(jmodel, jparams, toks, len(prompt))
    ref = {}
    for e in (None, jt):
        kw = dict(n_slots=SLOTS, page=PAGE, eos_id=e, policy=POLICY)
        ref[e] = (j_serve.run_lockstep(jmodel, jparams, jcfg, reqs, **kw),
                  j_serve.run_continuous(jmodel, jparams, jcfg, reqs, **kw))
    return dict(eos=jt, ref=ref)


def _jax_first_token(jmodel, jparams, toks, n):
    """The reference's first greedy token after a prompt of ``n`` tokens,
    through the layer graph (a dense cache)."""
    pre = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))
    dec = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    _, cache = pre(jparams, {"tokens": jnp.asarray(toks)})
    cache = j_serve.pad_cache_to(cache, toks.shape[1], 2 * toks.shape[1], 2)
    nxt, _, _ = dec(jparams, {"token": jnp.asarray([toks[0, n - 1]]),
                               "lengths": jnp.asarray([n - 1])}, cache)
    return int(np.asarray(nxt)[0])


@pytest.mark.parametrize("with_eos", [False, True], ids=["budget", "eos"])
def test_layer_graph_schedulers_match_reference(models, served, with_eos):
    _, _, _, tcfg, tmodel, tparams = models["float32"]
    eos = served["eos"] if with_eos else None
    reqs = t_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=tcfg.vocab, seed=0)
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=eos)
    lock = t_serve.run_lockstep(tmodel, tparams, tcfg, reqs, **kw)
    cont = t_serve.run_continuous(tmodel, tparams, tcfg, reqs, **kw)
    ref_lock, ref_cont = served["ref"][eos]
    assert {k: lock[k] for k in KEYS} == {k: ref_lock[k] for k in KEYS}
    assert {k: cont[k] for k in KEYS} == {k: ref_cont[k] for k in KEYS}
    if with_eos:                 # the EOS bites: request 0 stops at once
        assert lock["tokens"] < served["ref"][None][0]["tokens"]


def test_layer_graph_parity_probe_f32(models):
    """Dense (layer graph) against paged (per-op) decode in float32: the
    two orders of the same sums agree within 1e-5 (the reference's give
    0.0)."""
    _, _, _, tcfg, tmodel, tparams = models["float32"]
    diff = t_serve.decode_parity_probe(tmodel, tparams, tcfg, page=PAGE)
    assert 0.0 <= diff <= 1e-5


def test_serve_bench_cpu_layer_graph():
    """The CLI entry with --layer-graph on the CPU: the same result keys as
    without it, equal token counts, a finite probe difference."""
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    argv = ["--smoke", "--device", "cpu", "--requests", "3", "--max-new",
            "3", "--prompt-len", "10", "--page", str(PAGE), "--slots",
            str(SLOTS)]
    base = t_serve.serve_bench(ap.parse_args(argv))
    out = t_serve.serve_bench(ap.parse_args(argv + ["--layer-graph"]))
    assert set(out) == set(base)
    assert out["token_count_parity"]
    assert out["lockstep"]["tokens"] == base["lockstep"]["tokens"] > 0
    assert np.isfinite(out["bitwise_max_abs_diff"])
