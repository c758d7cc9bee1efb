"""The port's roofline tools against the reference's on the same inputs:
``launch/comm_stats.py`` ``collective_stats`` over records of the
collectives in ``tests/test_roofline.py``'s HLO (the reference parses the
HLO text), ``model_flops`` for every arch x shape, and ``analyze_cell``'s
layer-diff extrapolation on the reference test's fake cell. The port's
constants are the H100's (``core/pipeline_model.py`` ``H100_SXM``), so
the time terms are held to the port's own constants.
"""

import numpy as np
import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro.launch.hlo_stats import collective_stats as jax_collective_stats
from repro_torch.configs.base import ARCH_IDS, SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.comm_stats import (KINDS, CollectiveRecord,
                                           collective_stats)

# tests/test_roofline.py's HLO and the same collectives as records
HLO = """
ENTRY %main {
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,2048]{1,0} all-gather(bf16[8,2048]{1,0} %y), replica_groups=[2,8]<=[16], dimensions={0}
  %rs = f32[128]{0} reduce-scatter(f32[1024]{0} %z), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %cp = bf16[32,128]{1,0} collective-permute(bf16[32,128]{1,0} %w), source_target_pairs={{0,1}}
  %ard = f32[4]{0} all-reduce-done(f32[4]{0} %h)
  %nothing = f32[16]{0} add(f32[16]{0} %a, f32[16]{0} %b)
}
"""
# each record carries the result's bytes, as the reference's parser reads
# them from the HLO
RECORDS = [CollectiveRecord("all-reduce", 1024 * 512 * 4, 4),
           CollectiveRecord("all-gather", 64 * 2048 * 2, 8),
           CollectiveRecord("reduce-scatter", 128 * 4, 8),
           CollectiveRecord("collective-permute", 32 * 128 * 2, 1)]


@pytest.mark.parametrize("link_bw", [50e9, roofline.LINK_BW, 450e9])
def test_collective_stats_match_the_reference(link_bw):
    got = collective_stats(RECORDS, link_bw=link_bw)
    want = jax_collective_stats(HLO, link_bw=link_bw)
    for kind in KINDS:
        assert got[kind]["count"] == want[kind]["count"], kind
        assert got[kind]["bytes"] == want[kind]["bytes"], kind
        np.testing.assert_allclose(got[kind]["seconds"],
                                   want[kind]["seconds"], rtol=1e-12)
    for key in ("total_bytes", "total_count"):
        assert got[key] == want[key]
    np.testing.assert_allclose(got["total_seconds"], want["total_seconds"],
                               rtol=1e-12)


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.CHIPS == jroof.CHIPS


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    assert set(SHAPES) == set(JSHAPES)
    n = 1_234_567_890
    assert roofline.model_flops(arch, shape, n) == \
        jroof.model_flops(arch, shape, n)


def _fake_cell(l1_flops, l2_flops, units):
    coll = {"total_bytes": 0.0, "total_seconds": 0.0, "total_count": 0}
    return {
        "cell": "qwen1_5_0p5b__train_4k__pod16x16",
        "arch": "qwen1_5_0p5b", "shape": "train_4k", "mesh": "pod16x16",
        "ok": True, "n_layer_units": units,
        "n_params": 620_000_000, "n_active_params": 620_000_000,
        "memory": {"peak_bytes_est": 1 << 30, "argument_bytes": 1 << 28,
                   "output_bytes": 0, "temp_bytes": 0, "alias_bytes": 0,
                   "code_bytes": 0},
        "variants": {
            "L1": {"flops": l1_flops, "bytes": 1e9, "collectives": coll},
            "L2": {"flops": l2_flops, "bytes": 1.5e9, "collectives": coll},
        },
    }


@pytest.mark.parametrize("units", [1, 2, 24])
def test_layer_diff_extrapolation_matches_the_reference(units):
    cell = _fake_cell(l1_flops=10e12, l2_flops=13e12, units=units)
    got, want = roofline.analyze_cell(cell), jroof.analyze_cell(cell)
    assert set(got) == set(want)
    for key in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                "coll_bytes_per_dev", "model_flops_global", "useful_ratio",
                "peak_hbm_gib", "t_collective_s"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    np.testing.assert_allclose(got["t_compute_s"],
                               got["hlo_flops_per_dev"] / 989e12)
    np.testing.assert_allclose(got["t_memory_s"],
                               got["hlo_bytes_per_dev"] / 3.35e12)
    assert got["bottleneck"] in ("compute", "memory", "collective")


def test_skipped_and_failed_cells_return_none():
    assert roofline.analyze_cell({"skipped": True, "ok": True}) is None
    assert roofline.analyze_cell({"ok": False}) is None


def test_load_all_and_markdown_table(tmp_path):
    import json
    cell = _fake_cell(10e12, 13e12, 24)
    (tmp_path / "a.json").write_text(json.dumps(cell))
    rows = [roofline.analyze_cell(r) for r in roofline.load_all(tmp_path)]
    table = roofline.markdown_table(rows)
    assert table.splitlines()[0] == jroof.markdown_table(
        [jroof.analyze_cell(cell)]).splitlines()[0]
    assert "qwen1_5_0p5b x train_4k (pod16x16)" in table
