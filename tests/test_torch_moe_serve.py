"""The smoke grok-1 model (attention and the MoE FFN) served by both of the
port's schedulers against the reference's, under ``--impl ff`` and
``--impl xla``, and the smoke llama3.2-1b and starcoder2-15b models (the
dense family's other configs: tied embeddings; LayerNorm and the GELU
MLP) under ``--impl ff``: the same token counts in the same number of
decode steps (rate 0, 3 requests, 2 slots, page 8, the reference's
parameters carried across), the EOS set to the first token the reference
emits for request 0 so that retirement depends on the greedy token
values; and the port's paged decode equal to its dense decode bit for
bit in each case. The reference runs outside ``use_sharding`` (see
test_torch_model.py), its kernels in interpret mode.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import build_model as j_build
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax

ARCH = "grok1_314b"
PAGE, SLOTS = 8, 2
POLICY = PipePolicy(mode="ff", interpret=True)
KEYS = ("tokens", "decode_steps")


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


# case id -> (arch, impl); grok-1's cases keep their ids
SERVED = {"ff": (ARCH, "ff"), "xla": (ARCH, "xla"),
          "llama3_2_1b-ff": ("llama3_2_1b", "ff"),
          "starcoder2_15b-ff": ("starcoder2_15b", "ff")}


@pytest.fixture(scope="module", params=list(SERVED))
def served(request):
    arch, impl = SERVED[request.param]
    pin = dict(decode_block_kv=PAGE) if impl == "ff" else {}
    jcfg = j_smoke(arch).replace(attn_impl=impl, remat="none", **pin)
    tcfg = t_smoke(arch).replace(attn_impl=impl, **pin)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    reqs = j_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=jcfg.vocab, seed=0)
    eos = _first_token(jmodel, jparams, reqs[0].prompt)
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=eos, policy=POLICY)
    ref = (j_serve.run_lockstep(jmodel, jparams, jcfg, reqs, **kw),
           j_serve.run_continuous(jmodel, jparams, jcfg, reqs, **kw))
    return dict(tcfg=tcfg, tmodel=t_build(tcfg), tparams=tparams, eos=eos,
                ref=ref)


def test_schedulers_match_reference(served):
    reqs = t_serve.make_requests(3, prompt_len=12, max_new=4, rate=0.0,
                                 vocab=served["tcfg"].vocab, seed=0)
    args = (served["tmodel"], served["tparams"], served["tcfg"], reqs)
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=served["eos"])
    lock = t_serve.run_lockstep(*args, **kw)
    cont = t_serve.run_continuous(*args, **kw)
    ref_lock, ref_cont = served["ref"]
    assert {k: lock[k] for k in KEYS} == {k: ref_lock[k] for k in KEYS}
    assert {k: cont[k] for k in KEYS} == {k: ref_cont[k] for k in KEYS}
    assert lock["tokens"] == cont["tokens"] > 0


def test_port_decode_parity_probe_is_bitwise(served):
    assert t_serve.decode_parity_probe(served["tmodel"], served["tparams"],
                                       served["tcfg"], page=PAGE) == 0.0


@pytest.mark.parametrize("impl", ["ff", "xla", "cfg"])
def test_serve_bench_takes_the_impl_flag(impl):
    """``--impl`` as the reference's: ``cfg`` keeps the config's value, and
    only ``"ff"`` pins the dense decode tile to the page."""
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    args = ap.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--impl", impl, "--requests", "2", "--max-new",
                          "2", "--prompt-len", "8", "--page", str(PAGE),
                          "--slots", str(SLOTS)])
    out = t_serve.serve_bench(args)
    assert out["impl"] == ("ff" if impl == "cfg" else impl)
    assert out["bitwise_identical"] and out["token_count_parity"]
