"""Configurations, traffic mixes and metrics are files found by name:
one of each dropped into a copy of the benchmark runs with no edit to a
file that was there; and BENCHMARK.json keeps to its limits."""

import json
import re

from conftest import BENCH, REPO, run_cell


def test_new_config_traffic_and_metric_are_found_by_name(tiny_root):
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*")
              if p.is_file()}
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "sc-smoke.json").read_text())
    cfg["num_hidden_layers"] = 3
    (pb / "configs" / "sc-three.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "tiny.json").read_text())
    tr.update(slots=2)
    (pb / "traffic" / "two-slots.json").write_text(json.dumps(tr))
    (pb / "metrics" / "served_tokens.py").write_text(
        "def read(run):\n    return float(run.sched.tokens)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sc-three", "source": "test",
                             "file": "portbench/configs/sc-three.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sc-three-two", "config": "sc-three",
                               "traffic": "two-slots", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "served_tokens", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["sc-three-two"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = run_cell(tiny_root, "sc-three-two", trace=1)
    assert out["correct"] and out["attempted"] == 7
    assert out["metrics"]["served_tokens"]["value"] > 0
    # the metric is read only in the cells it lists
    other, _ = run_cell(tiny_root, "sc-tiny", trace=1)
    assert "served_tokens" not in other["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_limits():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((REPO / c["file"]).read_text())
        assert all(k in f for k in c["reduced"]) and \
            sorted(c["reduced"]) == sorted(f["reduced"])
        assert all(len(c[k]) <= 200 for k in ("why", "source"))
    traffic = {p.stem for p in (BENCH / "traffic").glob("*.json")}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["traffic"] in traffic and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
