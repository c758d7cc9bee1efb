"""The port's train step, remat and train mode, on the CPU.

- ``make_train_step`` against the reference's step (jitted, outside
  ``use_sharding``) from the same parameters and a fresh optimizer state,
  at ``accum_steps`` 1 and 2, with int8 accumulation, and under
  Adafactor: the loss within 1e-5 relative, ``grad_norm`` and ``lr`` within
  2e-4; AdamW's moments each within 2e-4 x its leaf's max |reference|
  (plus one int8 quantum under ``quantized_accum``); each updated
  parameter within 1e-6 of the reference's wherever the reference's first
  moment is clear of that tolerance, and else within the step's largest
  move, 2 x lr (the first step is close to lr x sign(g), which flips on a
  near-zero gradient); under Adafactor a factored leaf within 1e-3 x lr;
- each remat policy and ``bf16_grads`` give the loss and gradients of
  ``remat="none"`` bit for bit, for the decoder stack (dense, MoE, MLA),
  RWKV, the hybrid and the encoder-decoder;
- the loss path keeps no per-layer cache in any family, and under
  remat="full" autograd keeps of each layer its input alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import adafactor as t_adafactor
from repro_torch.optim import adamw as t_adamw

from _torch_train_ref import GRAD_TOL, LOSS_TOL, batch, pair

STEP_CASES = [("adamw", 1, False), ("adamw", 2, False), ("adamw", 2, True),
              ("adafactor", 1, False)]


@pytest.mark.parametrize(
    "optimizer,accum,quantized", STEP_CASES,
    ids=[f"{o}-accum{a}{'-int8' if q else ''}" for o, a, q in STEP_CASES])
def test_train_step_matches_reference(optimizer, accum, quantized):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair("llama3_2_1b")
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    if optimizer == "adamw":
        jo, to = j_adamw.AdamWConfig(**kw), t_adamw.AdamWConfig(**kw)
        jinit, tinit = j_adamw.init, t_adamw.init
    else:
        jo = j_adafactor.AdafactorConfig(**kw)
        to = t_adafactor.AdafactorConfig(**kw)
        jinit, tinit = j_adafactor.init, t_adafactor.init
    b = batch(jcfg, seed=9, b=4)
    jstep = jax.jit(j_steps.make_train_step(
        jmodel, optimizer=optimizer, opt_cfg=jo, accum_steps=accum,
        quantized_accum=quantized))
    jp, js, jm = jstep(jparams, jinit(jparams),
                       {k: jnp.asarray(v) for k, v in b.items()})
    tstep = t_steps.make_train_step(
        tmodel, optimizer=optimizer, opt_cfg=to, accum_steps=accum,
        quantized_accum=quantized)
    p_in = tparams
    tp, ts, tm = tstep(tparams, tinit(tparams),
                       {k: torch.from_numpy(v) for k, v in b.items()})
    assert tp is p_in                        # updated in place
    assert set(tm) == set(jm)
    assert abs(tm["loss"].item() - float(jm["loss"])) <= \
        LOSS_TOL * abs(float(jm["loss"]))
    for k in set(jm) - {"loss"}:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                   rtol=GRAD_TOL, atol=1e-7, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 1
    lr = float(jm["lr"])
    jp, tp = tree_to_numpy(jax.tree.map(np.asarray, jp)), tree_to_numpy(tp)
    if optimizer == "adamw":
        jmom = tree_to_numpy(jax.tree.map(np.asarray, js["m"]))
        tol_m = GRAD_TOL + (1 / 127 if quantized else 0)
        for name in ("m", "v"):
            want = tree_to_numpy(jax.tree.map(np.asarray, js[name]))
            got = tree_to_numpy(ts[name])
            for k, w in want.items():
                bound = (2 if name == "v" else 1) * tol_m * np.abs(w).max()
                assert np.abs(got[k] - w).max() <= bound, (name, k)
        for k, w in jp.items():
            m_scale = np.abs(jmom[k]).max()
            clear = np.abs(jmom[k]) > tol_m * m_scale
            d = np.abs(tp[k] - w)
            assert (d[clear] <= 1e-6 * max(np.abs(w).max(), 1.0)).all(), k
            assert (d <= 2 * lr + 1e-6).all(), k
    else:
        # a factored leaf's update is smooth in its gradients; a rank-1
        # leaf's first update is lr x sign(g), as AdamW's
        for k, w in jp.items():
            bound = 1e-3 * lr if w.ndim >= 2 else 2 * lr
            assert np.abs(tp[k] - w).max() <= bound + 1e-6, k


def _grads(arch, **over):
    cfg = t_smoke(arch).replace(attn_impl="xla", scan_impl="xla",
                                compute_dtype="float32", **over)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=10).items()}
    metrics, grads = t_steps.value_and_grad(model, params, b)
    return metrics["loss"], tree_to_numpy(grads)


REMAT = ([("llama3_2_1b", r, False) for r in ("full", "dots",
                                              "collectives")]
         + [("llama3_2_1b", r, True) for r in ("none", "full")]
         + [("grok1_314b", r, False) for r in ("full", "dots",
                                               "collectives")]
         + [("deepseek_v2_lite_16b", "collectives", False),
            ("rwkv6_7b", "full", False), ("zamba2_2p7b", "full", False),
            ("whisper_tiny", "full", False)])


@pytest.mark.parametrize(
    "arch,remat,bf16_grads", REMAT,
    ids=[f"{a}-{r}{'-bf16grads' if g else ''}" for a, r, g in REMAT])
def test_remat_and_bf16_grads_equal_no_remat_bitwise(arch, remat,
                                                     bf16_grads):
    want_loss, want = _grads(arch, remat="none")
    loss, got = _grads(arch, remat=remat, bf16_grads=bf16_grads)
    assert torch.equal(loss, want_loss)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_remat_dots_saves_the_products():
    """Under "dots" the products' outputs are kept: the recompute runs
    fewer matmuls than under "full"."""
    counts = {}
    for remat in ("full", "dots"):
        cfg = t_smoke("llama3_2_1b").replace(attn_impl="xla", remat=remat)
        model = t_build(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=11).items()}
        n = [0]
        mm = torch.ops.aten.mm.default

        class Count(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                n[0] += func is mm
                return func(*args, **(kwargs or {}))
        for leaf in (x for _, x in L.tree_leaves(params)):
            leaf.requires_grad_(True)
        loss, _ = model.loss(params, b)
        with Count():
            loss.backward()
        counts[remat] = n[0]
    assert counts["dots"] < counts["full"], counts


def _family_trunks():
    """Each family's loss-path trunk output: (caches it returns)."""
    out = {}
    for arch in ("llama3_2_1b", "grok1_314b", "internvl2_1b", "rwkv6_7b",
                 "zamba2_2p7b", "whisper_tiny"):
        cfg = t_smoke(arch).replace(attn_impl="xla", scan_impl="xla")
        model = t_build(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=12).items()}
        if cfg.family == "ssm":
            _, caches = model._trunk(params, model._embed(params,
                                                          b["tokens"]),
                                     None, want_cache=False)
        elif cfg.family == "hybrid":
            _, caches = model._trunk(params, b, want_cache=False)
        elif cfg.family == "encdec":
            x, enc = model._decoder_in(params, b)
            _, caches = encdec.decode_stack(cfg, params["encdec"], x, enc,
                                            want_cache=False)
        else:
            _, caches, _, _ = model._trunk(params, b, want_cache=False)
        out[arch] = caches
    return out


def test_loss_path_keeps_no_caches():
    for arch, caches in _family_trunks().items():
        assert caches is None, arch


def _saved_bytes(n_layers, remat):
    cfg = t_smoke("llama3_2_1b").replace(attn_impl="xla", remat=remat,
                                         n_layers=n_layers)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for leaf in (x for _, x in L.tree_leaves(params)):
        leaf.requires_grad_(True)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=13).items()}
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(params, b)
    return total[0]


def test_remat_keeps_only_each_layers_input():
    """Under remat="full" what autograd keeps of a layer is its input (x
    and the positions): each layer more adds exactly those bytes. Without
    remat a layer keeps its activations, many times more."""
    cfg = t_smoke("llama3_2_1b")
    x_bytes = 2 * 16 * cfg.d_model * 4 + 16 * 8       # [B,S,D] f32, [S]
    per_layer = (_saved_bytes(4, "full") - _saved_bytes(2, "full")) // 2
    assert per_layer == x_bytes
    per_layer_none = (_saved_bytes(4, "none") - _saved_bytes(2, "none")) // 2
    assert per_layer_none > 10 * x_bytes
