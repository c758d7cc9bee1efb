"""Shared set-up of the port's training tests: a smoke model of each
package with the reference's parameters carried across, a batch made from
a numpy seed, and the tolerances the comparisons are held to.

The reference runs with ``remat="none"`` (``jax.checkpoint`` only adds
compile time) outside ``use_sharding``, at f32 compute; the port on its
"xla" path (the kernels have no backward), also at f32 compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import params_from_jax, tree_to_numpy

LOSS_TOL = 1e-5          # relative
GRAD_TOL = 2e-4          # x the leaf's max |reference value|
B, S = 2, 16


def pair(arch, **over):
    """(reference cfg, model, params; port cfg, model, params) at f32
    compute, the port's params converted from the reference's."""
    jcfg = j_smoke(arch).replace(remat="none", compute_dtype="float32",
                                 **over)
    tcfg = t_smoke(arch).replace(attn_impl="xla", scan_impl="xla",
                                 compute_dtype="float32", **over)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jmodel, jparams, tcfg, t_build(tcfg), tparams


def batch(cfg, seed=0, b=B, s=S, extras=True):
    """Tokens, next-token labels and the family's stub inputs (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if extras and cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def ref_value_and_grad(jmodel, jparams, np_batch):
    """The reference's loss, metrics and gradients (``jax.value_and_grad``
    of ``model.loss``, jitted), as numpy: (loss, metrics, {path: grad})."""
    fn = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (loss, metrics), grads = fn(jparams, {k: jnp.asarray(v)
                                          for k, v in np_batch.items()})
    return (float(loss), jax.tree.map(np.asarray, metrics),
            tree_to_numpy(jax.tree.map(np.asarray, grads)))


def port_value_and_grad(tmodel, tparams, np_batch):
    metrics, grads = value_and_grad(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in
                          np_batch.items()})
    return metrics, tree_to_numpy(grads)


def assert_leaves_close(got, want, tol, what="grad"):
    """Every leaf of ``got`` ({path: numpy}) within ``tol`` x the max |x|
    of the same leaf of ``want``; the same leaves in both."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        e = float(np.abs(got[k].astype(np.float64) - w).max())
        assert e <= tol * scale, f"{what} {k}: {e:.3e} > {tol} x {scale:.3e}"
