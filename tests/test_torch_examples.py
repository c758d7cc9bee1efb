"""The port's examples (``examples/*_torch.py``) run to the line their
reference ends with, on the CPU (``--device cpu``: the kernels' plain
versions), each a subprocess with a timeout."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

# (example, extra arguments, the last line as a pattern)
EXAMPLES = {
    "quickstart": ([], r"^quickstart done$"),
    "train_tiny_lm": (["--tiny", "--steps", "12"],
                      r"^done at step 12; median step \d+ ms$"),
    "serve_pipelined": ([], r"^speedup x[\d.]+ tok/s, p99 x[\d.]+, "
                            r"bitwise diff 0\.0e\+00$"),
    "microbench_sweep": ([], r"^ chunk_scan\[ff\] max\|err\| = [\d.e+-]+$"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_reaches_its_last_line(name, tmp_path):
    extra, last = EXAMPLES[name]
    if name == "train_tiny_lm":
        extra = extra + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, str(ROOT / "examples" /
                                            f"{name}_torch.py"),
                        "--device", "cpu", *extra],
                       env=env, capture_output=True, text=True, timeout=240,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    # the port's trainer adds its result and checkpoint lines after the
    # reference's last one ("done at step ...")
    ours = [ln for ln in lines if not ln.startswith("# ")]
    assert re.match(last, ours[-1]), lines[-5:]
