"""The port's ``model.loss`` and every gradient leaf against
``jax.value_and_grad`` of the reference's ``model.loss`` on the smoke
configs of the other families, on the CPU: grok-1 (MoE, with the load-
balance aux), deepseek-v2-lite (MLA and MoE), rwkv6-7b (``RWKVLM.loss``),
zamba2-2.7b (``ZambaLM.loss``) and whisper-tiny (``EncDecLM.loss``), and
rwkv6 with ``loss_chunk=2``. Loss within 1e-5 relative, each gradient leaf
within 2e-4 x its max |reference value|. A loss through the "ff" scan
refuses autograd, as through the "ff" attention (test_torch_loss.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import smoke_config as t_smoke
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model as t_build

from _torch_train_ref import (GRAD_TOL, LOSS_TOL, assert_leaves_close,
                              batch, pair, port_value_and_grad,
                              ref_value_and_grad)

FAMILIES = [("grok1_314b", {}), ("deepseek_v2_lite_16b", {}),
            ("rwkv6_7b", {}), ("rwkv6_7b", {"loss_chunk": 2}),
            ("zamba2_2p7b", {}), ("whisper_tiny", {})]


@pytest.mark.parametrize(
    "arch,over", FAMILIES,
    ids=[a + "".join(f"-{k}{v}" for k, v in o.items())
         for a, o in FAMILIES])
def test_loss_and_grads_match_reference(arch, over):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(arch, **over)
    b = batch(jcfg, seed=7)
    want, jmetrics, jgrads = ref_value_and_grad(jmodel, jparams, b)
    metrics, grads = port_value_and_grad(tmodel, tparams, b)
    assert abs(metrics["loss"].item() - want) <= LOSS_TOL * abs(want)
    assert set(metrics) == set(jmetrics)
    if "aux" in jmetrics:
        np.testing.assert_allclose(metrics["aux"].item(), jmetrics["aux"],
                                   rtol=LOSS_TOL, atol=1e-7)
    if arch == "grok1_314b":
        assert jmetrics["aux"] > 0         # the MoE adds 0.01 x aux
    assert_leaves_close(grads, jgrads, GRAD_TOL)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2p7b"])
def test_loss_through_ff_scan_raises(arch):
    cfg = t_smoke(arch).replace(attn_impl="xla", scan_impl="ff")
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=8).items()}
    with pytest.raises(RuntimeError, match="ff_chunk_scan: no backward"):
        value_and_grad(model, params, b)
