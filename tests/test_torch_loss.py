"""The port's loss path against the JAX reference, on the CPU.

- ``cross_entropy`` and ``chunked_unembed_loss`` (value and gradients);
- ``bf16_grad_barrier`` / ``bf16_grad_cast`` backward against the
  reference's ``custom_vjp``s, bit for bit;
- ``model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's ``model.loss`` on the dense smoke configs (llama3.2-1b,
  also with ``loss_chunk=2``; qwen1.5-0.5B, starcoder2-15b, qwen2-72b,
  internvl2-1b with and without patch embeddings): loss within 1e-5
  relative, each gradient leaf within 2e-4 x its max |reference value|
  (the other families: test_torch_loss_families.py);
- every kernel entry point refusing autograd outside mode "ref", and the
  reference's own ``jax.grad`` through its "ff" attention failing;
- ``param_count``, ``active_param_count`` and ``abstract_params`` equal to
  the reference's for every config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get
from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy
from repro.core.program import policy as j_policy
from repro.models import build_model as j_build
from repro.models import layers as j_layers
from repro_torch import ops
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_config as t_get
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.core.program import PipePolicy as TPipePolicy
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as t_layers

from _torch_train_ref import (GRAD_TOL, LOSS_TOL, assert_leaves_close,
                              batch, pair, port_value_and_grad,
                              ref_value_and_grad)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 8, 128))).astype(np.float32)
    labels = rng.integers(0, 128, (2, 8)).astype(np.int32)
    want, gw = jax.value_and_grad(
        lambda lg: j_layers.cross_entropy(lg, jnp.asarray(labels), z_loss))(
            jnp.asarray(logits))
    lt = _t(logits, True)
    got = t_layers.cross_entropy(lt, torch.from_numpy(labels), z_loss)
    (gt,) = torch.autograd.grad(got, lt)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    assert_leaves_close({"logits": gt.numpy()},
                        {"logits": np.asarray(gw)}, GRAD_TOL)


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunked_unembed_loss_matches_reference(n_chunks):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    table = (0.2 * rng.standard_normal((128, 32))).astype(np.float32)
    labels = rng.integers(0, 128, (2, 16)).astype(np.int32)
    want, (gx, gtab) = jax.value_and_grad(
        lambda a, t: j_layers.chunked_unembed_loss(
            a, t, jnp.asarray(labels), n_chunks), argnums=(0, 1))(
                jnp.asarray(x), jnp.asarray(table))
    xt, tt = _t(x, True), _t(table, True)
    got = t_layers.chunked_unembed_loss(xt, tt, torch.from_numpy(labels),
                                        n_chunks)
    grads = torch.autograd.grad(got, (xt, tt))
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    assert_leaves_close({"x": grads[0].numpy(), "table": grads[1].numpy()},
                        {"x": np.asarray(gx), "table": np.asarray(gtab)},
                        GRAD_TOL)
    with pytest.raises(AssertionError):
        t_layers.chunked_unembed_loss(xt, tt, torch.from_numpy(labels), 3)


def test_bf16_grad_barrier_backward_matches_reference():
    """Identity forward; the f32 cotangent rounded through bf16, the same
    bits as the reference's ``custom_vjp``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(64).astype(np.float32)
    ct = rng.standard_normal(64).astype(np.float32)
    y, vjp = jax.vjp(j_layers.bf16_grad_barrier, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = _t(x, True)
    yt = t_layers.bf16_grad_barrier(xt)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(ct))
    assert torch.equal(yt.detach(), xt.detach())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), ct)      # it did round


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_grad_cast_backward_matches_reference(dtype):
    """Identity forward; the cotangent cast to the primal's type."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(64).astype(np.float32)
    ct = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(j_layers.bf16_grad_cast, jx)
    (want,) = vjp(jnp.asarray(ct).astype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    yt = t_layers.bf16_grad_cast(xt)
    (got,) = torch.autograd.grad(yt, xt,
                                 torch.from_numpy(ct).to(xt.dtype))
    assert yt.dtype == xt.dtype and torch.equal(yt.detach(), xt.detach())
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


DENSE = [("llama3_2_1b", {}, True), ("llama3_2_1b", {"loss_chunk": 2}, True),
         ("qwen1_5_0p5b", {}, True), ("starcoder2_15b", {}, True),
         ("qwen2_72b", {}, True), ("internvl2_1b", {}, True),
         ("internvl2_1b", {}, False)]


@pytest.mark.parametrize(
    "arch,over,extras", DENSE,
    ids=[f"{a}{''.join(f'-{k}{v}' for k, v in o.items())}"
         f"{'' if e else '-text'}" for a, o, e in DENSE])
def test_loss_and_grads_match_reference(arch, over, extras):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(arch, **over)
    b = batch(jcfg, seed=5, extras=extras)
    want, jmetrics, jgrads = ref_value_and_grad(jmodel, jparams, b)
    metrics, grads = port_value_and_grad(tmodel, tparams, b)
    assert abs(metrics["loss"].item() - want) <= LOSS_TOL * abs(want)
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(metrics["aux"].item(), jmetrics["aux"],
                               rtol=LOSS_TOL, atol=1e-7)
    assert_leaves_close(grads, jgrads, GRAD_TOL)


def test_loss_through_ff_kernels_raises():
    """On the CPU the kernels' plain versions would differentiate, on the
    card their outputs carry no grad_fn: the entry point refuses both
    alike. The reference's own jax.grad through its "ff" attention
    (Pallas, interpret mode) fails too, in pallas_call's JVP."""
    jcfg = j_smoke("qwen1_5_0p5b").replace(attn_impl="ff", remat="none")
    jmodel = j_build(jcfg)
    b = batch(jcfg, seed=6, s=128)
    with j_policy(PipePolicy(mode="ff", interpret=True)):
        with pytest.raises(AssertionError):
            jax.grad(lambda p: jmodel.loss(p, {
                k: jnp.asarray(v) for k, v in b.items()})[0])(
                    jmodel.init(jax.random.key(0)))
    tcfg = t_smoke("qwen1_5_0p5b").replace(attn_impl="ff")
    tmodel = t_build(tcfg)
    params = tmodel.init(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with pytest.raises(RuntimeError, match="no backward kernel"):
        value_and_grad(tmodel, params, tb)
    with torch.no_grad():                   # serving: the kernel path runs
        logits, _ = tmodel.prefill(params, tb)
    assert torch.isfinite(logits).all()


def _entry_calls():
    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g)
    q, k, v = rn(4, 8, 16), rn(4, 8, 16), rn(4, 8, 16)
    lens = torch.tensor([5, 8], dtype=torch.int32)
    return {
        "matmul": (ops.matmul, (rn(8, 16), rn(16, 8)), {}),
        "gather": (ops.gather, (rn(32, 16), torch.arange(8)), {}),
        "attention": (ops.attention, (q, k, v), {"causal": True}),
        "decode_attention": (ops.decode_attention,
                             (rn(2, 2, 16), rn(2, 2, 8, 16),
                              rn(2, 2, 8, 16), lens), {"block_kv": 8}),
        "chunk_scan": (ops.chunk_scan,
                       (rn(2, 16, 8), rn(2, 16, 8), rn(2, 16, 8),
                        -torch.rand(2, 16, 8, generator=g)),
                       {"chunk": 8, "inclusive": True}),
    }


@pytest.mark.parametrize("name", ["matmul", "gather", "attention",
                                  "decode_attention", "chunk_scan"])
def test_entry_points_refuse_autograd(name):
    fn, args, kw = _entry_calls()[name]
    want = fn(*args, **kw)
    args = tuple(a.requires_grad_(True) if a.is_floating_point() else a
                 for a in args)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fn(*args, **kw)
    with torch.no_grad():
        assert torch.equal(fn(*args, **kw), want)
    # the plain version (mode "ref") is plain PyTorch and differentiates
    out = fn(*args, **kw, policy=TPipePolicy(mode="ref"))
    assert out.requires_grad


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_abstract_params_match_reference(arch):
    for jcfg, tcfg in ((j_get(arch), t_get(arch)),
                       (j_smoke(arch), t_smoke(arch))):
        jm, tm = j_build(jcfg), t_build(tcfg)
        assert tm.param_count() == jm.param_count()
        assert tm.active_param_count() == jm.active_param_count()
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            t_layers.tree_leaves(jax.tree.map(lambda s: s,
                                              jm.abstract_params()))}
    got = dict(t_layers.tree_leaves(tm.abstract_params()))
    assert set(got) == set(want)
    for k, (shape, dtype) in want.items():
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), str(got[k].dtype).split(".")[1]) == \
            (shape, dtype)
