"""No module the benchmark runs is JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's); the reference imports nothing of the program."""

import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN = """
import sys
sys.path[:0] = [{src!r}, {bench!r}, {tests!r}]
from pathlib import Path
import conftest
root = conftest.make_copy(Path({tmp!r}))
for cell in ("sc-tiny", "gk-tiny"):
    for trace in (0, 1):
        conftest.run_cell(root, cell, trace=trace)
import run
import control
print(" ".join(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REF = """
import sys
sys.path[:0] = [{bench!r}]
import reference.decoder
print(" ".join(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax(tmp_path):
    mods = _modules(RUN.format(src=str(REPO / "src"), bench=str(BENCH),
                               tests=str(BENCH / "tests"),
                               tmp=str(tmp_path)))
    assert "repro_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules(REF.format(bench=str(BENCH)))
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"repro_torch", "pbench"})


def test_no_source_of_the_benchmark_names_jax():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n",
                    "from repro import", "from repro.", "import repro."):
            assert bad not in text, (path, bad)
