"""Steps, tokens, operations and bytes against hand counts at small
shapes."""

import numpy as np
import pytest

from pbench import counts
from pbench.model import Model

DENSE = Model(port_arch="x", layers=2, d=8, heads=4, kv_heads=2, hd=2, ff=16,
              vocab=10, rope_theta=1e4, norm="layernorm", norm_eps=1e-5,
              gelu=True, bias=True, experts=0, top_k=0, capacity_factor=1.0,
              dtype="bfloat16")
MOE = Model(port_arch="x", layers=1, d=4, heads=2, kv_heads=1, hd=2, ff=3,
            vocab=5, rope_theta=1e4, norm="rmsnorm", norm_eps=1e-6,
            gelu=False, bias=False, experts=4, top_k=2, capacity_factor=4.0,
            dtype="bfloat16")


def test_schedule_from_admissions_and_outputs():
    # rid 0 admitted before step 0 (3 tokens), rid 1 before step 0 (1),
    # rid 2 before step 1 into rid 1's slot (2 tokens)
    adm = [[0, 0, 0], [1, 1, 0], [2, 1, 1]]
    out = {0: [5, 6, 7], 1: [9], 2: [1, 2]}
    s = counts.schedule({0: 4, 1: 2, 2: 3}, adm, out)
    assert s.steps == 3 and s.tokens == 6
    assert s.active.tolist() == [2, 2, 2]
    # rows attended: rid 0 at 4,5,6; rid 1 at 2; rid 2 at 3,4
    assert s.ctx_rows.tolist() == [4 + 2, 5 + 3, 6 + 4]


def test_params_by_hand():
    # q/o 8 * 4 * 2 each, k/v 8 * 2 * 2 each = 192; GELU MLP 2 * 8 * 16
    assert DENSE.attn_params() == 192
    assert DENSE.trunk_params() == 2 * (192 + 256)
    # top-2 of 4 SwiGLU experts: 2 * 3 * 4 * 3 = 72 + router 16
    assert MOE.mlp_params(active=True) == 88
    assert MOE.mlp_params(active=False) == 4 * 36 + 16
    assert DENSE.kv_bytes_per_token == 2 * 2 * 2 * 2 * 2


def test_flops_by_hand():
    # attention: 4 * L * H * hd per attended row
    assert counts.attn_flops(DENSE, [3]) == 4 * 2 * 4 * 2 * 3
    # a 3-token prompt: positions 0, 1 (the last is re-fed by decode)
    want = 2 * 2 * DENSE.trunk_params() + counts.attn_flops(DENSE, [1 + 2])
    assert counts.prompt_flops(DENSE, [3]) == pytest.approx(want)
    s = counts.schedule({0: 3}, [[0, 0, 0]], {0: [1, 2]})
    want_dec = 2 * 2 * (DENSE.trunk_params() + 10 * 8) + \
        counts.attn_flops(DENSE, [3 + 4])
    assert counts.decode_flops(DENSE, s) == pytest.approx(want_dec)
    assert counts.window_flops(DENSE, s) == pytest.approx(want + want_dec)


def test_kernel_bounds_by_hand():
    big = 1e30
    # paged decode, bytes only: 7 rows of K and V, 2 KV heads of 2, bf16,
    # plus q and out of 2 rows x 4 heads x 2, a layer
    kv = 7 * 2 * 2 * 2 * 2
    qo = 2 * 2 * 4 * 2 * 2
    assert counts.paged_decode_bound_s(DENSE, 2, 7, big, 1.0) == \
        2 * (kv + qo)
    # flops bound: 4 * H * hd * rows a layer
    assert counts.paged_decode_bound_s(DENSE, 2, 7, 1.0, big) == \
        2 * 4 * 4 * 2 * 7
    # prefill attention at 5 tokens: causal flops, io of q/k/v/out
    assert counts.prefill_attn_bound_s(DENSE, 5, 1.0, big) == \
        2 * 4 * 4 * 2 * 15
    assert counts.prefill_attn_bound_s(DENSE, 5, big, 1.0) == \
        2 * 5 * 2 * (8 + 4) * 2


def test_decode_bytes_by_hand():
    w = (DENSE.trunk_params(active=False) + 10 * 8) * 2 \
        + (2 * 2 + 1) * 8 * 4 * 2
    assert counts.weight_bytes(DENSE) == w
    assert counts.decode_step_bytes(DENSE, 2, 7) == w + 9 * 32
    # every expert held is read
    assert counts.weight_bytes(MOE) == \
        (MOE.trunk_params(active=False) + 20) * 2 + 3 * 4 * 4


def test_window_counts_match_a_served_window(tiny_root):
    """The schedule rebuilt from a served window agrees with the decode
    steps the scheduler returns (the run's own ``decode_steps_off``)."""
    from conftest import run_cell
    out, _ = run_cell(tiny_root, "sc-tiny")
    assert out["checks"]["decode_steps_off"]["value"] == 0
    assert np.isfinite(out["checks"]["gap_share"]["value"])
