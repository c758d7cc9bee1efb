"""The output check's readings over many seeds in one process: the
program's, and its controls' beside them.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control-seeds 3] [--out readings/]

For each seed: the weights drawn anew in place (the captured graphs read
them), a window of the cell's traffic at its own slots, then on the
sampled requests the numbers of ``pbench.check`` for the served tokens
and, on the first ``--control-seeds`` seeds, for the tokens each control
precision of ``reference.decoder`` puts first at the same positions. One
JSON line a seed; with ``--out``, the lines in ``<out>/readings.jsonl``
and each seed's per-position reference logits and judged logits in
``<out>/<cell>.<seed>.npz``. A limit lies between the largest served
reading and the smallest control reading. The benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

import run as bench


def readings(cell, server, n, seed, device, controls=("fp8",), out=None):
    """One seed's readings (see the module's docstring); ``controls``
    empty reads the served tokens alone."""
    from pbench import check, traffic, weights
    m, t = cell.model, cell.traffic
    weights.draw(m, seed, device, into=server.params)
    reqs = traffic.window(t, n, seed, m.vocab)
    t0 = time.perf_counter()
    result = server.serve(reqs)
    window_s = time.perf_counter() - t0
    outputs = result["outputs"]
    rids = check.sample(reqs, outputs, int(t["check"]["tokens"]), seed)
    by_rid = {r.rid: r for r in reqs}
    t0 = time.perf_counter()
    ref, tokens = check.judged(cell.config, server.params, by_rid, outputs,
                               rids, device, controls)
    gap = float(cell.config["check"]["gap"])
    found = {k: check.stats(ref, tok, gap) for k, tok in tokens.items()}
    if out is not None:
        arrays = {"top": check.detail(ref, tokens["served"])["top"]}
        for k, tok in tokens.items():
            arrays[f"{k}_logit"] = check.detail(ref, tok)["logit"]
        np.savez_compressed(Path(out) / f"{cell.name}.{seed}.npz", **arrays)
    return {"workload": cell.name, "seed": seed, "requests": n,
            "window_s": window_s, "checked_requests": len(rids),
            "checked_tokens": sum(len(outputs[r]) for r in rids),
            **found, "reference_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench._cache_dirs(bench.ROOT)
    bench._paths(bench.ROOT)
    import torch

    from pbench import cell as cell_lib
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cell_lib.load(bench.ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    server, n = bench.prepare(cell, seeds[0], args.seconds, device)
    for i, seed in enumerate(seeds):
        r = readings(cell, server, n, seed, device,
                     ("fp8",) if i < args.control_seeds else (), args.out)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(Path(args.out) / "readings.jsonl", "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
