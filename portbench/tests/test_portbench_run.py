"""The harness end to end on the CPU at test widths: one well-formed last
line, both trace modes, both configurations; no chip, no result."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, run_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", ["sc-tiny", "gk-tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_smoke_run_gives_one_well_formed_line(tiny_root, cell, trace):
    out, lines = run_cell(tiny_root, cell, trace=trace)
    text = json.dumps(out)
    assert "\n" not in text
    back = json.loads(text)
    assert list(back)[:5] == list(KEYS) and list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0
    assert back["attempted"] == 7
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in bench[kind]}
    assert back["metrics"] and set(back["metrics"]) <= set(allowed)
    for name, m in back["metrics"].items():
        assert m["unit"] == allowed[name] and m["value"] == m["value"]
    if not trace:
        assert set(back["metrics"]) == {"output_tokens_per_s",
                                        "decode_interval_ms", "setup_s"}
    else:
        assert {"batch_occupancy", "admit_ms", "decode_step_ms",
                "serve_mfu", "decode_mfu"} <= set(back["metrics"])
        assert "breakdown" in back
    assert [ln.split(":")[0] for ln in lines] == \
        ["check gap_share", "check failed_requests",
         "check decode_steps_off"]


def test_same_seed_same_tokens(tiny_root):
    a, _ = run_cell(tiny_root, "gk-tiny", seed=11)
    b, _ = run_cell(tiny_root, "gk-tiny", seed=11)
    assert a["checks"] == b["checks"]


def test_without_a_chip_it_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sc2-conv-batch", "--seed", str(2**31 + 3),
                        "--seconds", "10", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_mix_past_the_sliding_window_is_refused(tiny_root):
    """The port has no sliding window: a cell whose requests pass the
    configuration's window does not run."""
    path = tiny_root / "portbench" / "configs" / "sc-smoke.json"
    cfg = json.loads(path.read_text())
    cfg["sliding_window"] = 32
    path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="sliding window"):
        run_cell(tiny_root, "sc-tiny")
