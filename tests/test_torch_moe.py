"""The port's MoE FFN and the MoE models against the JAX reference, with
the reference's own random parameters carried across.

- ``moe_ffn_apply``, global and shard-local dispatch, on grok-1's and
  deepseek-v2-lite's smoke FFNs (deepseek's with a shared expert), at the
  smoke capacity factor (no drops) and at 0.25 (drops, and slots past
  the last expert's rows): outputs and the aux loss within 2e-5 (f32; the
  same formula, the libraries' reduction orders), the routing (experts,
  slots, kept) equal.
- ``cast_params`` keeps the router in f32, so the cast model routes and
  computes as the uncast one, bit for bit; ``init_cast`` equals
  ``cast_params(init(...))`` bit for bit.
- The smoke grok-1 model under ``attn_impl`` "ff" and "xla": prefill
  logits and caches, and 3 greedy decode steps through the dense cache and
  the paged pool, logits within 2e-4 (the attention kernels' registry
  tolerance, as tests/test_torch_model.py) and tokens equal.

The reference runs outside ``use_sharding`` (see test_torch_model.py),
its Pallas kernels in interpret mode. Inputs are drawn from numpy seeds,
continuous, so ``top_k`` meets no ties.
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
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.runtime.paged_kv import PagedKVCache as JPaged
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.paged_kv import PagedKVCache as TPaged

FFN_TOL, MODEL_TOL = 2e-5, 2e-4
POLICY = PipePolicy(mode="ff", interpret=True)
ARCHS = ("grok1_314b", "deepseek_v2_lite_16b")
PAGE, N_STEPS = 8, 3
LENS = np.array([6, 13], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _ffn_case(arch, cf, local, seed=0):
    cfg_kw = dict(capacity_factor=cf, moe_local_dispatch=local)
    jcfg = j_smoke(arch).replace(**cfg_kw)
    tcfg = t_smoke(arch).replace(**cfg_kw)
    jp = JL.init_params(jmoe.moe_ffn_specs(jcfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _tree_t(jax.tree.map(np.asarray, jp)), x


CASES = [(arch, cf, local) for arch in ARCHS for cf in (None, 0.25)
         for local in (False, True)]


@pytest.mark.parametrize(
    "arch,cf,local", CASES,
    ids=[f"{a.split('_')[0]}-{'drop' if cf else 'smoke-cf'}-"
         f"{'local' if lo else 'global'}" for a, cf, lo in CASES])
def test_moe_ffn_matches_reference(arch, cf, local):
    cf = cf or j_smoke(arch).capacity_factor
    jcfg, tcfg, jp, tp, x = _ffn_case(arch, cf, local)
    jout, jaux = jmoe.moe_ffn_apply(jcfg, jp, jnp.asarray(x))
    tout, taux = tmoe.moe_ffn_apply(tcfg, tp, _t(x))
    assert tout.shape == x.shape and taux.dtype == torch.float32
    _close(tout, jout, FFN_TOL)
    _close(taux, jaux, FFN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_indices_equal_reference_and_drops_reach_the_dump(arch):
    """At capacity factor 0.25 tokens are dropped; some dropped slots point
    past the buffer (the reference's scatter drops them, the port's goes
    to its dump row) and some into the next expert's rows (a zero
    contribution): the routing is equal, the layer within tolerance."""
    jcfg, tcfg, jp, tp, x = _ffn_case(arch, 0.25, False, seed=3)
    t = x.shape[0] * x.shape[1]
    capacity = tmoe._capacity(t, tcfg, 8)
    xf = x.reshape(t, -1)
    jgates = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    jidx, jprobs, jslot, jkeep = jmoe._dispatch_indices(jgates, jcfg.top_k,
                                                       capacity)
    gates = tmoe.router_gates(tp, _t(xf))
    idx, probs, slot, keep = tmoe._dispatch_indices(gates, tcfg.top_k,
                                                    capacity)
    for port, ref in ((idx, jidx), (slot, jslot), (keep, jkeep)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    _close(probs, jprobs, FFN_TOL)
    flat = (idx * capacity + slot)[~keep]
    n = tcfg.n_experts * capacity
    assert (~keep).any() and (flat >= n).any() and (flat < n).any()


def test_capacity_copies_the_reference_formula():
    """int(t // e * k * cf) + 1 (integer division first), rounded up to
    the granule: 2048 from 2^17 tokens on, else 8."""
    cfg = t_smoke("grok1_314b").replace(capacity_factor=1.25)   # e 4, k 2
    assert tmoe._capacity(7, cfg, 8) == 8                 # 7 // 4 = 1
    assert tmoe._capacity(1000, cfg, 8) == 632           # 625 + 1 -> 632
    assert tmoe._capacity(1 << 17, cfg, 2048) == 83968   # 81921 -> 41 x 2048


def _bf16_model(arch):
    cfg = t_smoke(arch).replace(compute_dtype="bfloat16")
    return cfg, t_build(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_keep_the_router_in_f32_and_route_as_uncast(arch):
    cfg, model = _bf16_model(arch)
    params = model.init(torch.Generator().manual_seed(0))
    cast = model.cast_params(params)
    layers = cast["stack"]["layers"]
    assert layers["ffn"]["router"].dtype == torch.float32
    assert layers["ffn"]["w1"].dtype == torch.bfloat16
    if cfg.kv_lora_rank:
        assert layers["mixer"]["kv_norm"]["w"].dtype == torch.float32
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 9, cfg.d_model))).float().bfloat16()
    for i in range(cfg.n_layers):
        one = {k: v[i] for k, v in params["stack"]["layers"]["ffn"].items()
               if k != "shared"}
        one_cast = {k: v[i] for k, v in layers["ffn"].items()
                    if k != "shared"}
        if "shared" in layers["ffn"]:
            one["shared"] = TL.tree_map(lambda a: a[i],
                                        params["stack"]["layers"]["ffn"]
                                        ["shared"])
            one_cast["shared"] = TL.tree_map(lambda a: a[i],
                                             layers["ffn"]["shared"])
        xf = x.reshape(-1, cfg.d_model)
        assert torch.equal(
            torch.topk(tmoe.router_gates(one, xf), cfg.top_k).indices,
            torch.topk(tmoe.router_gates(one_cast, xf), cfg.top_k).indices)
        want, want_aux = tmoe.moe_ffn_apply(cfg, one, x)
        got, got_aux = tmoe.moe_ffn_apply(cfg, one_cast, x)
        assert torch.equal(got, want) and torch.equal(got_aux, want_aux)
    toks = {"tokens": torch.randint(1, cfg.vocab, (2, 11),
                                    generator=torch.Generator().manual_seed(2))}
    assert torch.equal(model.prefill(cast, toks)[0],
                       model.prefill(params, toks)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cast_equals_cast_params_of_init(arch):
    _, model = _bf16_model(arch)
    want = model.cast_params(model.init(torch.Generator().manual_seed(7)))
    got = model.init_cast(torch.Generator().manual_seed(7))
    w, g = list(TL.tree_leaves(want)), list(TL.tree_leaves(got))
    assert [p for p, _ in w] == [p for p, _ in g]
    for (path, a), (_, b) in zip(w, g):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the smoke grok-1 model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["ff", "xla"])
def grok(request):
    impl = request.param
    jcfg = j_smoke("grok1_314b").replace(attn_impl=impl, remat="none",
                                         decode_block_kv=PAGE)
    tcfg = t_smoke("grok1_314b").replace(attn_impl=impl,
                                         decode_block_kv=PAGE)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(4)
    toks = np.zeros((len(LENS), int(LENS.max())), np.int32)
    for i, n in enumerate(LENS):
        toks[i, :n] = rng.integers(1, jcfg.vocab, size=n)
    return dict(impl=impl, jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                tcfg=tcfg, tmodel=t_build(tcfg), tparams=tparams, toks=toks)


def test_grok_prefill_logits_and_cache_match_reference(grok):
    jlog, jcache = jax.jit(j_steps.make_prefill_step(
        grok["jmodel"], policy=POLICY))(grok["jparams"],
                                        {"tokens": jnp.asarray(grok["toks"])})
    tlog, tcache = t_steps.make_prefill_step(grok["tmodel"])(
        grok["tparams"], {"tokens": torch.from_numpy(grok["toks"])})
    _close(tlog, jlog, MODEL_TOL)
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name], MODEL_TOL)


def _decode(side, m, paged):
    """(logits of each step, tokens [B, steps]) from one prefill, through
    the dense cache or the paged pool, on the reference ("j") or the port
    ("t")."""
    j = side == "j"
    cfg = m["jcfg"] if j else m["tcfg"]
    toks = m["toks"]
    arr = jnp.asarray if j else torch.from_numpy
    if j:
        prefill = jax.jit(j_steps.make_prefill_step(m["jmodel"],
                                                    policy=POLICY))
        decode = jax.jit(j_steps.make_decode_step(m["jmodel"],
                                                  policy=POLICY))
        params, pad, paged_cls = m["jparams"], j_serve.pad_cache_to, JPaged
    else:
        prefill = t_steps.make_prefill_step(m["tmodel"])
        decode = t_steps.make_decode_step(m["tmodel"])
        params, pad, paged_cls = m["tparams"], t_serve.pad_cache_to, TPaged
    p_max = toks.shape[1]
    n_pages = -(-(p_max + N_STEPS) // PAGE)
    _, dense = prefill(params, {"tokens": arr(toks)})
    if paged:
        kv = paged_cls(n_layers=cfg.n_layers,
                       n_blocks=len(LENS) * n_pages + 1, page=PAGE,
                       kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                       n_slots=len(LENS), n_pages_max=n_pages,
                       dtype=cfg.cdtype)
        for i, n in enumerate(LENS):
            kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                     n_pages * PAGE)
        cache = kv.cache_view()
    else:
        cache = pad(dense, p_max, n_pages * PAGE, 2)
    cur = arr(toks[np.arange(len(LENS)), LENS - 1])
    lengths = arr(LENS - 1)
    logits, out = [], []
    for _ in range(N_STEPS):
        cur, lg, cache = decode(params, {"token": cur, "lengths": lengths},
                                cache)
        logits.append(np.asarray(lg) if j else lg)
        out.append(np.asarray(cur) if j else cur.numpy())
        lengths = lengths + 1
    return logits, np.stack(out, 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_grok_decode_steps_match_reference(grok, paged):
    jlogits, jtoks = _decode("j", grok, paged)
    tlogits, ttoks = _decode("t", grok, paged)
    for tl, jl in zip(tlogits, jlogits):
        _close(tl, jl, MODEL_TOL)
    np.testing.assert_array_equal(ttoks, jtoks)
