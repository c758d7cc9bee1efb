"""Regenerate the dry-run and roofline tables of the port's
``experiments/dryrun_torch/EXPERIMENTS.md`` from its dry-run artifacts
(the port of ``experiments/update_experiments.py``). Idempotent: the
content after each marker comment is replaced; the file is made, with
both markers, where it is absent.

Usage:
  PYTHONPATH=src python experiments/update_experiments_torch.py
"""

import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.roofline import analyze_cell, load_all, \
    markdown_table  # noqa: E402

DRY = os.path.join(os.path.dirname(__file__), "dryrun_torch")

_SKELETON = """# Dry run and roofline (the PyTorch / H100 port)

Made by `experiments/update_experiments_torch.py` from the artifacts of
`python -m repro_torch.launch.dryrun` in this directory.

## Dry run

<!-- DRYRUN_TABLE -->

## Roofline

<!-- ROOFLINE_TABLE -->
"""


def dryrun_table(results):
    rows = ["| cell | mesh | status | lower (s) | compile (s) | HBM GiB/dev "
            "| params |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if "__it" in r["cell"] or "__" + "tag" in r["cell"]:
            continue
        if r.get("skipped"):
            rows.append(f"| {r['arch']} × {r['shape']} | {r['mesh']} | "
                        f"SKIP ({r['reason'].split(':')[0]}) | | | | |")
            continue
        status = "OK" if r.get("ok") else f"FAIL: {r.get('error', '')[:40]}"
        t = r.get("timings", {})
        mem = r.get("memory", {}).get("peak_bytes_est", 0) / 2 ** 30
        rows.append(
            f"| {r['arch']} × {r['shape']} | {r['mesh']} | {status} "
            f"| {t.get('lower_s', 0):.1f} | {t.get('compile_s', 0):.1f} "
            f"| {mem:.2f} | {r.get('n_params', 0):,} |")
    return "\n".join(rows)


def inject(md, marker, content):
    pat = re.compile(rf"<!-- {marker} -->.*?(?=\n## |\Z)", re.S)
    repl = f"<!-- {marker} -->\n\n{content}\n"
    assert pat.search(md), marker
    return pat.sub(repl, md)


def main(argv=None) -> int:
    del argv
    results = [r for r in load_all(DRY)
               if "__it" not in r["cell"] and "__base" not in r["cell"]]
    base = [r for r in results if r["cell"].count("__") == 2]
    analyzed = [a for a in (analyze_cell(r) for r in base) if a]
    analyzed.sort(key=lambda a: (a["arch"], a["shape"], a["mesh"]))

    path = os.path.join(DRY, "EXPERIMENTS.md")
    md = _SKELETON
    if os.path.exists(path):
        with open(path) as f:
            md = f.read()
    md = inject(md, "DRYRUN_TABLE", dryrun_table(base))
    md = inject(md, "ROOFLINE_TABLE", markdown_table(analyzed))
    os.makedirs(DRY, exist_ok=True)
    with open(path, "w") as f:
        f.write(md)
    print(f"updated {path} with {len(base)} cells, "
          f"{len(analyzed)} roofline rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
