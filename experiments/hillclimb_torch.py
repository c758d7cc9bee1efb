"""Perf hillclimb driver on the port's dry run: re-lowers a cell with one
config or rule change per iteration and reports the roofline-term deltas
against the recorded base cell (the port of ``experiments/hillclimb.py``).

The base cell is the plain dry run of the same (arch, shape) in
``experiments/dryrun_torch/`` (``python -m repro_torch.launch.dryrun
--arch A --shape S``); the variant is written beside it as
``<cell>__<tag>.json``.

Usage:
  PYTHONPATH=src python experiments/hillclimb_torch.py \\
      --cell qwen2_72b:train_4k --tag it1_losschunk --patch loss_chunk=8
  PYTHONPATH=src python experiments/hillclimb_torch.py \\
      --cell qwen2_72b:train_4k --tag it2_seqsp --rule seq_sp=model \\
      --patch loss_chunk=8

``--device`` is the fake tensors' device type (default cuda; nothing runs
on it). ``--smoke`` starts from the arch's smoke config instead of the
full one, with ``--mesh`` a small fake group (the CPU tests use both).
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import get_config, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.roofline import analyze_cell  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "dryrun_torch")


def parse_val(v: str):
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def parse_mesh(spec):
    """``axis=size,...`` -> ((axis, size), ...), or None."""
    if not spec:
        return None
    return tuple((kv.split("=")[0], int(kv.split("=")[1]))
                 for kv in spec.split(","))


def base_patch(arch: str, smoke: bool) -> dict:
    """The config fields every run of the cell starts from: none, or the
    smoke config's."""
    return dataclasses.asdict(smoke_config(arch)) if smoke else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--patch", nargs="*", default=[], help="k=v cfg fields")
    ap.add_argument("--rule", nargs="*", default=[],
                    help="k=v logical-rule overrides (v='None' clears)")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... mesh refactor (same chip count)")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (nothing runs)")
    ap.add_argument("--smoke", action="store_true",
                    help="start from the arch's smoke config")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")

    patch = base_patch(arch, args.smoke)
    patch.update({k: parse_val(v)
                  for k, v in (p.split("=", 1) for p in args.patch)})
    if args.rule:
        rules = dict(get_config(arch).rule_overrides or {})
        for r in args.rule:
            k, v = r.split("=", 1)
            rules[k] = (None if v == "None"
                        else tuple(v.split("+")) if "+" in v else v)
        patch["rule_overrides"] = rules

    base_path = os.path.join(OUT, f"{arch}__{shape}__pod16x16.json")
    if not os.path.exists(base_path):
        print(f"no base cell {base_path}: lower it first "
              f"(python -m repro_torch.launch.dryrun --arch {arch} "
              f"--shape {shape})")
        return 1
    r = dryrun.run_cell(arch, shape, multi_pod=False, cfg_patch=patch,
                        tag="__" + args.tag, out_dir=OUT,
                        mesh_axes=parse_mesh(args.mesh), device=args.device)
    if not r.get("ok"):
        print("FAILED:", r.get("error"))
        print(r.get("traceback", "")[-1500:])
        return 1

    with open(base_path) as f:
        base = json.load(f)
    a0, a1 = analyze_cell(base), analyze_cell(r)
    print(f"{'term':14s} {'baseline':>12s} {'variant':>12s} {'delta':>8s}")
    for key, label in (("t_compute_s", "compute s"), ("t_memory_s", "memory s"),
                       ("t_collective_s", "collective s"),
                       ("peak_hbm_gib", "peak HBM GiB"),
                       ("useful_ratio", "useful/HLO"),
                       ("roofline_fraction", "roofline frac")):
        b, v = a0[key], a1[key]
        d = (v - b) / b * 100 if b else float("nan")
        print(f"{label:14s} {b:12.4f} {v:12.4f} {d:+7.1f}%")
    print(f"bottleneck: {a0['bottleneck']} -> {a1['bottleneck']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
