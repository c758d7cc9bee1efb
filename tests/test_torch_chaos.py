"""The port's chaos harness (``repro_torch.runtime.chaos``) on the CPU:
the train worker's state update against the reference's formula on the
same numpy inputs, and the four scenarios, each an orchestrated set of
worker processes (``--device cpu``: the kernels' plain versions), each
required ``ok`` with the reference's gates.

Tolerance of the update: 1e-6 absolute and relative (|w| < 1; both sides
take the product in f32, in other orders, and tanh of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.program import PipePolicy
from repro_torch.runtime import chaos

WORKER_TIMEOUT = 120          # seconds a worker may take here


def test_train_update_matches_the_reference_formula():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((chaos.DIM, chaos.DIM)).astype(np.float32)
    w = (0.1 * rng.standard_normal((chaos.DIM, chaos.DIM))).astype(
        np.float32)
    got = chaos.train_update(torch.from_numpy(w), torch.from_numpy(x),
                             PipePolicy(mode="ff"))
    xw = jnp.asarray(x) @ jnp.asarray(w)
    want = 0.99 * jnp.asarray(w) + 0.01 * jnp.tanh(xw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_step_input_is_a_pure_function_of_the_step():
    assert torch.equal(chaos.step_input(5), chaos.step_input(5))
    assert not torch.equal(chaos.step_input(5), chaos.step_input(6))
    assert chaos.step_input(0).dtype == torch.float32


def _kill(tmp):
    out = chaos.scenario_kill_restart(tmp, device="cpu",
                                      timeout=WORKER_TIMEOUT)
    assert out["killed"] and out["bitwise_identical"], out
    assert out["resume_step"] == out["expect_resume"] == 6
    assert out["prewarmed"] >= 1
    assert out["restart_plan_stats"].get("measured", 0) == 0
    return out


def _sigterm(tmp):
    out = chaos.scenario_sigterm_drain(tmp, device="cpu",
                                       timeout=WORKER_TIMEOUT)
    assert out["save_count"] == out["expected_saves"] == 2, out
    assert out["drained_at"] == out["resume_step"] == 6
    return out


def _remesh(tmp):
    out = chaos.scenario_evict_remesh(tmp, device="cpu",
                                      timeout=WORKER_TIMEOUT)
    assert out.get("old_mesh") == "pod2.data2.model2", out
    assert out["new_mesh"] == out["post_remesh_mesh"] == "data2.model2"
    assert out["post_remesh_source"] == "plandb"
    assert out["post_remesh_stats"].get("measured", 0) == 0
    return out


def _slowhost(tmp):
    out = chaos.scenario_slow_host(tmp, device="cpu",
                                   timeout=WORKER_TIMEOUT)
    assert out.get("mad_path") and out["replan_mesh"] == "data2", out
    assert out["share_after"] < out["share_before"]
    assert out["n_words_after"] < out["n_words_before"]
    return out


SCENARIOS = {"kill_restart": _kill, "sigterm_drain": _sigterm,
             "evict_remesh": _remesh, "slow_host": _slowhost}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_scenario_ok_on_the_cpu(name, tmp_path):
    out = SCENARIOS[name](str(tmp_path))
    assert out["ok"], out
    assert out["ff_matmul_launches"] == 0 or all(
        v == 0 for v in out["ff_matmul_launches"].values()), \
        "CPU workers run the plain version: no launch"


def test_sigterm_scenario_refuses_a_notice_off_the_boundary(tmp_path):
    with pytest.raises(ValueError, match="multiple of ckpt_every"):
        chaos.scenario_sigterm_drain(str(tmp_path), sigterm_at=5,
                                     ckpt_every=3, device="cpu")
