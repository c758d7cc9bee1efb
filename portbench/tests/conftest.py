"""Fixtures of the benchmark's CPU tests: a temporary copy of the
benchmark with tiny cells (the two configurations at test widths, in
float32), which the harness finds by name like any other."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"hidden_size": 96, "intermediate_size": 192, "num_hidden_layers": 2,
        "num_attention_heads": 6, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 4096, "torch_dtype": "float32",
        "check": {"gap": 0.01, "limits": {"gap_share": 0.01}}}
TINY_MOE = dict(TINY, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_local_experts=4)
TRAFFIC = {"slots": 4, "page": 16, "rate": 1.4,
           "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.8,
                      "min": 4, "max": 40},
           "completion": {"dist": "lognormal", "median": 14, "sigma": 0.5,
                          "min": 8, "max": 24},
           "profile": {"start": 0.3, "steps": 2},
           "check": {"tokens": 1000}}


def make_copy(dst: Path) -> Path:
    """``dst`` holding BENCHMARK.json, the benchmark's folder and the
    program's sources, with cells ``sc-tiny`` and ``gk-tiny`` added."""
    shutil.copytree(BENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "src").symlink_to(REPO / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, base, over in (("sc-smoke", "starcoder2-15b", TINY),
                             ("gk-smoke", "grok1-4l", TINY_MOE)):
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg.update(over)
        (dst / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test widths"})
    (dst / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TRAFFIC))
    for cell, cfg in (("sc-tiny", "sc-smoke"), ("gk-tiny", "gk-smoke")):
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_copy(tmp_path)


WINDOW = 7        # requests in a test window: the rate times 5 seconds


def run_cell(root, workload, *, trace=0, seed=2**31 + 7, device="cpu",
             control=None):
    """One run of the harness on ``device``, past its look for a chip."""
    import argparse

    import torch

    import run as bench
    args = argparse.Namespace(workload=workload, seed=seed, seconds=5.0,
                              trace=trace, control=control)
    return bench.run(args, root=Path(root), device=torch.device(device))
