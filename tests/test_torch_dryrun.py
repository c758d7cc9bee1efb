"""The port's dry run (``repro_torch.launch.dryrun``) at smoke size on a
fake process group of 8 ranks ((data 4, model 2); the 256-rank full-width
cell is ``chip_smoke.py``'s), and ``comm_stats.CommCapture`` on a real
capture of known collectives on a fake 4-rank group.

* the L=1 / L=2 extrapolation of a smoke cell cut to 4 layers equals the
  whole 4-layer step's count, flops and bytes exactly (each layer
  dispatches the same operations on the same local shapes);
* the result dict has the reference's keys, and ``analyze_cell`` reads it;
* the capture records an all-reduce's and an all-gather's kind, bytes and
  group size, as the reference's parser reads them from HLO.
"""

import dataclasses
import json

import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.configs.base import smoke_config
from repro_torch.launch import comm_stats, dryrun, roofline

MESH = (("data", 4), ("model", 2))


@pytest.fixture(scope="module")
def smoke_cell(tmp_path_factory):
    """The smoke config (as a patch of the full one) cut to 4 layers."""
    out = tmp_path_factory.mktemp("dry")
    patch = {**dataclasses.asdict(smoke_config("qwen1_5_0p5b")),
             "n_layers": 4}
    return dryrun.run_cell("qwen1_5_0p5b", "train_4k", multi_pod=False,
                           mesh_axes=MESH, device="cpu", cfg_patch=patch,
                           tag="__smoke", out_dir=str(out)), out


def test_smoke_cell_runs_and_has_the_reference_keys(smoke_cell):
    r, out = smoke_cell
    assert r["ok"], r.get("traceback")
    for key in ("memory", "cost_scan_program", "n_params",
                "n_active_params", "n_layer_units", "variants"):
        assert key in r
    for v in ("L1", "L2"):
        assert set(r["variants"][v]) == {"flops", "bytes", "collectives"}
        assert r["variants"][v]["collectives"]["total_count"] > 0
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes", "code_bytes",
                                "peak_bytes_est"}
    assert r["memory"]["peak_bytes_est"] >= r["memory"]["argument_bytes"] > 0
    assert r["n_layer_units"] == 4
    saved = json.loads((out / f"{r['cell']}.json").read_text())
    assert saved["cell"] == r["cell"] == \
        "qwen1_5_0p5b__train_4k__pod16x16__smoke"


@pytest.mark.parametrize("key", ["flops", "bytes"])
def test_layer_extrapolation_equals_the_whole_stack(smoke_cell, key):
    r, _ = smoke_cell
    f1, f2 = r["variants"]["L1"][key], r["variants"]["L2"][key]
    whole = r["cost_scan_program"][key]
    assert whole > 0 and f2 > f1 > 0
    assert f1 + (r["n_layer_units"] - 1) * (f2 - f1) == whole


def test_analyze_cell_reads_the_dry_run(smoke_cell):
    r, _ = smoke_cell
    row = roofline.analyze_cell(r)
    want = jroof._extrapolate(r, lambda v: v["flops"])
    assert row["hlo_flops_per_dev"] == want == r["cost_scan_program"]["flops"]
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert "qwen1_5_0p5b x train_4k" in roofline.markdown_table([row])


def test_reduced_cfg_and_layer_units_follow_the_reference():
    from repro_torch.configs.base import get_config
    z = get_config("zamba2_2p7b")
    assert dryrun.n_layer_units(z) == z.n_layers // z.attn_every_n
    assert dryrun._reduced_cfg(z, 2).n_layers == 2 * z.attn_every_n
    w = dryrun._reduced_cfg(get_config("whisper_tiny"), 1)
    assert (w.n_layers, w.n_enc_layers) == (1, 1)


def test_skipped_cell_is_recorded(tmp_path):
    r = dryrun.run_cell("qwen1_5_0p5b", "long_500k", multi_pod=False,
                        device="cpu", out_dir=str(tmp_path))
    assert r["skipped"] and r["ok"]


def test_comm_capture_records_known_collectives():
    import torch.distributed._functional_collectives as funcol
    with dryrun.fake_world(4):
        group = torch.distributed.group.WORLD
        x = torch.ones(256, 32)
        with comm_stats.CommCapture() as cap:
            y = funcol.all_reduce(x, "sum", group)
            z = funcol.all_gather_tensor(x, 0, group)
            funcol.wait_tensor(y)
            funcol.wait_tensor(z)
    kinds = [(r.kind, r.bytes, r.group) for r in cap.records]
    assert kinds == [("all-reduce", 256 * 32 * 4, 4),
                     ("all-gather", 4 * 256 * 32 * 4, 4)]
    stats = comm_stats.collective_stats(cap.records, link_bw=50e9)
    assert stats["all-reduce"]["seconds"] == \
        2 * 3 / 4 * 256 * 32 * 4 / 50e9
    assert stats["total_count"] == 2
