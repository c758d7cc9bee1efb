"""On the card: the harness at test widths in bf16 through the port's
kernels (both configurations, both trace modes), and the float8 control
beside the served tokens. Marked ``cuda``; skips without a card.

    python3 -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import json

import pytest
import torch

from conftest import run_cell

# widths the port's bf16 kernels take (head size 64, as qwen's)
CARD = {"hidden_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64, "torch_dtype": "bfloat16",
        "check": {"gap": 0.5, "limits": {"logit_gap_mean": 0.05}}}


@pytest.fixture
def card_root(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("sc-smoke", "gk-smoke"):
        path = tiny_root / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(CARD)
        path.write_text(json.dumps(cfg))
    return tiny_root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sc-tiny", "gk-tiny"])
def test_cell_on_the_card(card_root, cell):
    out, _ = run_cell(card_root, cell, device="cuda")
    assert out["failed"] == 0
    assert out["checks"]["decode_steps_off"]["value"] == 0
    assert out["metrics"]["output_tokens_per_s"]["value"] > 0
    traced, _ = run_cell(card_root, cell, trace=1, device="cuda")
    assert traced["device"]["busy_s"] > 0
    assert 0 < traced["metrics"]["paged_decode_roofline"]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sc-tiny", "gk-tiny"])
def test_control_on_the_card(card_root, cell):
    import run as bench

    import control
    from pbench import cell as cell_lib
    c = cell_lib.load(card_root, cell)
    dev = torch.device("cuda")
    server, n = bench.prepare(c, 1, 5.0, dev)
    for seed in (1, 2, 3):
        r = control.readings(c, server, n, seed, dev)
        assert r["served"]["logit_gap_mean"] < r["fp8"]["logit_gap_mean"]
