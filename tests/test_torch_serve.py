"""The port's serving slice end to end against the JAX reference: both
schedulers over the same trace emit the same number of tokens in the same
number of decode steps, and the port's paged decode equals its dense
decode bit for bit.

Smoke qwen1.5-0.5B, rate 0, 3 requests, 2 slots, page 8, the reference's
parameters carried across. The reference runs in interpret mode outside
``use_sharding`` (see test_torch_model.py), once per module. Without an
EOS the token counts follow from the budgets alone, so the trace is also
replayed with the EOS set to the first token the reference emits for
request 0: then retirement, and with it every count, depends on the
greedy token values of both implementations.
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
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax

ARCH = "qwen1_5_0p5b"
PAGE, SLOTS = 8, 2
POLICY = PipePolicy(mode="ff", interpret=True)
KEYS = ("tokens", "decode_steps")


def _requests(vocab):
    return j_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=vocab, seed=0)


def _first_token(jmodel, jparams, prompt):
    pre = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))
    dec = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    n = len(prompt)
    toks = np.zeros((1, j_serve._bucket(n)), np.int32)
    toks[0, :n] = prompt
    _, cache = pre(jparams, {"tokens": jnp.asarray(toks)})
    cache = j_serve.pad_cache_to(cache, toks.shape[1], 2 * toks.shape[1], 2)
    nxt, _, _ = dec(jparams, {"token": jnp.asarray([prompt[-1]]),
                              "lengths": jnp.asarray([n - 1])}, cache)
    return int(np.asarray(nxt)[0])


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke(ARCH).replace(attn_impl="ff", decode_block_kv=PAGE,
                                 remat="none")
    tcfg = t_smoke(ARCH).replace(decode_block_kv=PAGE)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    reqs = _requests(jcfg.vocab)
    eos = _first_token(jmodel, jparams, reqs[0].prompt)
    ref = {}
    for e in (None, eos):
        kw = dict(n_slots=SLOTS, page=PAGE, eos_id=e, policy=POLICY)
        ref[e] = (j_serve.run_lockstep(jmodel, jparams, jcfg, reqs, **kw),
                  j_serve.run_continuous(jmodel, jparams, jcfg, reqs, **kw))
    return dict(tcfg=tcfg, tmodel=t_build(tcfg), tparams=tparams,
                reqs=reqs, eos=eos, ref=ref)


@pytest.mark.parametrize("with_eos", [False, True], ids=["budget", "eos"])
def test_schedulers_match_reference(setup, with_eos):
    eos = setup["eos"] if with_eos else None
    # the port's own trace generator replays the reference's trace
    reqs = t_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=setup["tcfg"].vocab, seed=0)
    for ours, theirs in zip(reqs, setup["reqs"]):
        np.testing.assert_array_equal(ours.prompt, theirs.prompt)
        assert (ours.arrival, ours.max_new) == (theirs.arrival,
                                                theirs.max_new)
    args = (setup["tmodel"], setup["tparams"], setup["tcfg"], reqs)
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=eos)
    lock = t_serve.run_lockstep(*args, **kw)
    cont = t_serve.run_continuous(*args, **kw)
    ref_lock, ref_cont = setup["ref"][eos]
    assert {k: lock[k] for k in KEYS} == {k: ref_lock[k] for k in KEYS}
    assert {k: cont[k] for k in KEYS} == {k: ref_cont[k] for k in KEYS}
    assert (cont["pool_blocks"], cont["page"]) == (ref_cont["pool_blocks"],
                                                  ref_cont["page"])
    if with_eos:                 # the EOS bites: request 0 stops at once
        assert cont["tokens"] < setup["ref"][None][1]["tokens"]


def test_port_decode_parity_probe_is_bitwise(setup):
    diff = t_serve.decode_parity_probe(setup["tmodel"], setup["tparams"],
                                       setup["tcfg"], page=PAGE)
    assert diff == 0.0


def test_serve_bench_cpu_result_dict():
    """The CLI entry on the CPU: same result keys as the reference's, with
    ``device`` in place of ``mesh``."""
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    args = ap.parse_args(["--smoke", "--device", "cpu", "--requests", "3",
                          "--max-new", "3", "--prompt-len", "10",
                          "--page", str(PAGE), "--slots", str(SLOTS)])
    out = t_serve.serve_bench(args)
    assert out["device"] == {"type": "cpu", "name": "cpu"}
    assert out["bitwise_identical"] and out["token_count_parity"]
    assert out["lockstep"]["tokens"] == out["paged"]["tokens"] > 0


def test_serve_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.resolve_device("cuda")
