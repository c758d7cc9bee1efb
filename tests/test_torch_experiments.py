"""The port's experiment drivers on its dry run (``experiments/
hillclimb_torch.py``, ``experiments/update_experiments_torch.py``), at
smoke size on a fake 8-rank group ((data 4, model 2)), each writing into
a temporary directory (the scripts' output path monkeypatched).

* hillclimb re-lowers a smoke cell with one ``--patch`` and prints the
  reference's table of roofline terms against the base cell; it refuses
  to run without a base cell;
* update_experiments makes ``EXPERIMENTS.md`` where it is absent and
  writes both tables between the reference's markers, idempotently.
"""

import dataclasses
import importlib.util
import os

import pytest

from repro_torch.configs.base import smoke_config
from repro_torch.launch import dryrun

EXP = os.path.join(os.path.dirname(__file__), "..", "experiments")
CELL = "qwen1_5_0p5b:prefill_32k"
MESH = "data=4,model=2"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXP, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("hillclimb_torch"), _load("update_experiments_torch")


@pytest.fixture(scope="module")
def dry_dir(scripts, tmp_path_factory):
    """A base smoke cell (2 layers) in a temporary dry-run directory."""
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    patch = {**dataclasses.asdict(smoke_config("qwen1_5_0p5b")),
             "n_layers": 2}
    r = dryrun.run_cell("qwen1_5_0p5b", "prefill_32k", multi_pod=False,
                        mesh_axes=(("data", 4), ("model", 2)), device="cpu",
                        cfg_patch=patch, out_dir=out)
    assert r["ok"], r.get("traceback")
    return out


def test_hillclimb_needs_a_base_cell(scripts, tmp_path, monkeypatch,
                                     capsys):
    hill, _ = scripts
    monkeypatch.setattr(hill, "OUT", str(tmp_path))
    assert hill.main(["--cell", CELL, "--tag", "it0", "--smoke",
                      "--mesh", MESH, "--device", "cpu"]) == 1
    assert "no base cell" in capsys.readouterr().out


def test_hillclimb_reports_the_terms_against_the_base(scripts, dry_dir,
                                                      monkeypatch, capsys):
    hill, _ = scripts
    monkeypatch.setattr(hill, "OUT", dry_dir)
    assert hill.main(["--cell", CELL, "--tag", "it1_chunk", "--smoke",
                      "--patch", "n_layers=2", "loss_chunk=8",
                      "--mesh", MESH, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for label in ("compute s", "memory s", "collective s", "peak HBM GiB",
                  "useful/HLO", "roofline frac", "bottleneck:"):
        assert label in out
    assert os.path.exists(os.path.join(
        dry_dir, "qwen1_5_0p5b__prefill_32k__pod16x16__it1_chunk.json"))


def test_update_experiments_writes_both_tables(scripts, dry_dir,
                                               monkeypatch):
    _, upd = scripts
    monkeypatch.setattr(upd, "DRY", dry_dir)
    path = os.path.join(dry_dir, "EXPERIMENTS.md")
    assert not os.path.exists(path)
    for _ in range(2):          # made, then rewritten in place
        assert upd.main([]) == 0
        md = open(path).read()
        assert md.count("<!-- DRYRUN_TABLE -->") == 1
        assert md.count("<!-- ROOFLINE_TABLE -->") == 1
        assert md.count("| qwen1_5_0p5b × prefill_32k | pod16x16 | OK") == 1
        assert md.count("| qwen1_5_0p5b x prefill_32k (pod16x16)") == 1
    # the hillclimb variant is not a base cell
    assert "it1" not in md
