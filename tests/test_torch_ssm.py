"""The port's SSM (RWKV6) and hybrid (Zamba2) families against the JAX
reference on their smoke configs, with the reference's own random
parameters carried across by ``params_from_jax``.

The reference runs with ``attn_impl="ff"``, ``scan_impl="ff"`` and
``remat="none"``, its Pallas kernels in interpret mode, outside
``use_sharding`` (there ``constrain`` is a no-op). The path is the one the
registry documents for serving: ``make_prefill_step`` on prompts of one
length (both families' prefill ignores ``lengths``), then greedy
``make_decode_step`` from the prefill's last logits; for the hybrid, each
shared-attention cache is first padded on its sequence axis (decode writes
at ``lengths``). Tolerance 1e-3 on logits and states, the registry
tolerance of ``ff_chunk_scan`` (reference ``ops.py:361``); greedy tokens
must be equal.
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
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.kernels.ff_chunk_scan import chunk_scan
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model as t_build
from repro_torch.models import hybrid, rwkv6
from repro_torch.models.convert import params_from_jax

POLICY = PipePolicy(mode="ff", interpret=True)
TOL = 1e-3
B, S, N_STEPS, S_MAX = 2, 40, 3, 48
ARCHS = ("rwkv6_7b", "zamba2_2p7b")


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _models(arch):
    jcfg = j_smoke(arch).replace(attn_impl="ff", scan_impl="ff",
                                 remat="none")
    tcfg = t_smoke(arch)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, jcfg.vocab, size=(B, S)).astype(np.int32)
    return jcfg, jmodel, jparams, tcfg, t_build(tcfg), tparams, tokens


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both sides' prefill and three greedy decode steps, once per arch."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams, tokens = _models(
        request.param)
    jprefill = jax.jit(j_steps.make_prefill_step(jmodel, policy=POLICY))
    jdecode = jax.jit(j_steps.make_decode_step(jmodel, policy=POLICY))
    jlog, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)})
    before = chunk_scan.launches
    tlog, tcache = t_steps.make_prefill_step(tmodel)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert chunk_scan.launches == before      # the CPU runs the plain version
    prefill = (tlog, tcache, jlog, jax.tree.map(np.asarray, jcache))

    if jcfg.family == "hybrid":
        nseg = hybrid._n_segments(tcfg)
        jcache = j_serve.pad_cache_to(
            jcache, S, S_MAX, {"mamba": {"conv": None, "h": None},
                               "attn": [{"k": 1, "v": 1}] * nseg})
        tcache = t_serve.pad_cache_to(tcache, S, S_MAX,
                                      {"mamba": None, "attn": 1})
    tdecode = t_steps.make_decode_step(tmodel)
    jcur = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    tcur = torch.argmax(tlog, dim=-1).to(torch.int32)
    lengths = np.full((B,), S, np.int32)
    steps = []
    for _ in range(N_STEPS):
        jcur, jl, jcache = jdecode(
            jparams, {"token": jcur, "lengths": jnp.asarray(lengths)},
            jcache)
        tcur, tl, tcache = tdecode(
            tparams, {"token": tcur, "lengths": torch.from_numpy(lengths)},
            tcache)
        steps.append((tl, tcur.numpy(), np.asarray(jl), np.asarray(jcur)))
        lengths = lengths + 1
    return request.param, prefill, steps, (tcache, jcache)


def test_params_from_jax_takes_both_trees_and_checks_them():
    for arch in ARCHS:
        jcfg = j_smoke(arch).replace(scan_impl="ff", remat="none")
        tcfg = t_smoke(arch)
        tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.key(1)))
        tparams = params_from_jax(tree, tcfg)
        for (tp, t), (jp, j) in zip(_leaves(tparams), _leaves(tree)):
            assert tp == jp and tuple(t.shape) == j.shape
            assert np.array_equal(t.numpy(), j)
        if arch == "rwkv6_7b":
            del tree["layers"]["tm"]["u"]
        else:
            del tree["stack"]["shared"]["attn"]["wq"]
        with pytest.raises(ValueError, match="missing"):
            params_from_jax(tree, tcfg)


def test_prefill_logits_and_every_cache_leaf_match_reference(run):
    arch, (tlog, tcache, jlog, jcache), _, _ = run
    assert tlog.shape == jlog.shape
    _close(tlog, jlog)
    t_leaves, j_leaves = list(_leaves(tcache)), list(_leaves(jcache))
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    for (path, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape, path
        _close(t, j)


def test_greedy_decode_steps_match_reference(run):
    """Three steps: equal tokens, logits within 1e-3, and the final states
    (the hybrid's padded attention caches too)."""
    arch, _, steps, (tcache, jcache) = run
    for tl, ttok, jl, jtok in steps:
        _close(tl, jl)
        np.testing.assert_array_equal(ttok, jtok)
    for (path, t), (_, j) in zip(_leaves(tcache), _leaves(jcache)):
        _close(t, np.asarray(j))


def test_cache_specs_match_the_caches(run):
    """Each prefill cache leaf has the shape and type its family's
    cache-spec function declares (RWKV6's per layer, stacked [L, ...])."""
    arch, (_, tcache, _, _), _, _ = run
    tcfg = t_smoke(arch)
    if arch == "rwkv6_7b":
        one, _ = rwkv6.rwkv_cache_spec(tcfg, B)
        spec = {name: (tcfg.n_layers, *s.shape, s.dtype)
                for name, s in one.items()}
    else:
        full, _ = hybrid.cache_spec(tcfg, B, S)
        spec = {path: (*s.shape, s.dtype) for path, s in _leaves(full)}
    got = {path.lstrip("."): (*c.shape, c.dtype)
           for path, c in _leaves(tcache)}
    assert got == {path.lstrip("."): v for path, v in spec.items()}


def test_build_model_takes_only_the_ff_scan():
    """The configs default to the kernel ("ff"); the reference's "xla" and
    "xla_tiled" scans are taken too, an unknown scan is refused."""
    assert "rwkv6_7b" in ARCH_IDS and "zamba2_2p7b" in ARCH_IDS
    for arch in ARCHS:
        cfg = t_smoke(arch)
        assert cfg.scan_impl == "ff"
        for impl in ("xla", "xla_tiled"):
            assert t_build(cfg.replace(scan_impl=impl)).cfg.scan_impl == impl
        with pytest.raises(ValueError, match="scan_impl"):
            t_build(cfg.replace(scan_impl="pallas"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_the_recurrent_families(arch):
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    args = ap.parse_args(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="make_prefill_step"):
        t_serve.serve_bench(args)
