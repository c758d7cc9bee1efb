"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, and no ``examples/*_torch.py`` or
``experiments/*_torch.py`` imports JAX or anything of the JAX package
``repro``, and no module decides at import time whether a GPU exists."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py")) \
    + sorted((ROOT / "experiments").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _top_level_calls(tree):
    """Calls executed when the module is imported (outside any def)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and getattr(node.test.left, "id", "") == "__name__"):
            continue                    # the __main__ guard
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                yield ast.unparse(sub.func)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    probes = [c for c in _top_level_calls(tree)
              if "cuda" in c or c in ("_build.build", "build")]
    assert not probes, f"{path.relative_to(ROOT)} calls {probes} at import"
