"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run builds the cell's model through the port (``repro_torch``), draws
its weights on the card from ``--seed``, captures every CUDA graph the
window replays (set-up), then times one call of the paged continuous-
batching scheduler over a backlog of the traffic file's rate times
``--seconds`` requests, ends it with a synchronise, checks what it served
against the plain reference and prints one JSON line: ``--trace 0`` the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from
the program's spans and from ``torch.profiler`` over a slice of the
window. It needs a CUDA card (exit 2 without one) and imports neither JAX
nor the JAX package.

``--control <precision>`` (never in the benchmark's own runs) judges, in
the served tokens' place, the tokens the reference in that lower
precision puts first (``pbench.check``): the same comparison with the
same limits, which has to come out not correct.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, choices=("fp8",))
    return ap.parse_args(argv)


def _paths(root: Path) -> None:
    for p in (str(root / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernels' own nvcc output goes to ``build/kernels``)."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prepare(cell, seed, seconds, device):
    """Set-up: the model, its weights from ``seed``, and the window's
    signature and CUDA graphs. Returns (server, the window's number of
    requests)."""
    from pbench import program, traffic, weights

    m, t = cell.model, cell.traffic
    window = cell.config.get("sliding_window")
    longest = int(t["prompt"]["max"]) + int(t["completion"]["max"])
    if window and longest > int(window):
        raise SystemExit(f"{cell.name}: requests of up to {longest} tokens "
                         f"pass the {window}-token sliding window, which "
                         f"the port does not implement")
    cfg, model = program.build(m)
    params = weights.draw(m, seed, device)
    program.check_tree(model, params)

    page, slots = int(t["page"]), int(t["slots"])
    pages_max = traffic.max_pages(t, page)
    pool_blocks = slots * pages_max
    server = program.Server(cfg, model, params, slots=slots, page=page,
                            pool_blocks=pool_blocks, pages_max=pages_max)
    n = traffic.count(t, seconds)
    server.warm({traffic.bucket(p) for p, _ in traffic.sizes(t, n)})
    _log(f"# set-up: pool {pool_blocks} blocks x {page} tokens "
         f"({pool_blocks * m.kv_bytes_per_token * page / 1e9:.2f} GB), "
         f"{pages_max} pages a row, {slots} slots; window of {n} requests")
    return server, n


def run(args, *, root: Path, device):
    """One run on ``device``; returns (result dict, check lines)."""
    import torch

    from pbench import cell as cell_lib
    from pbench import check, counts, trace, traffic

    cell = cell_lib.load(root, args.workload)
    m, t = cell.model, cell.traffic
    server, n = prepare(cell, args.seed, args.seconds, device)
    params = server.params
    reqs = traffic.window(t, n, args.seed, m.vocab)

    tracer = None
    if args.trace:
        prof = t["profile"]
        est_steps = sum(r.max_new for r in reqs) / int(t["slots"])
        tracer = trace.Tracer(start=max(2, int(prof["start"] * est_steps)),
                              steps=int(prof["steps"]),
                              device_type=device.type)
    graphs = server.graph_count()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - _T_START
    with tracer if tracer else contextlib.nullcontext():
        result = server.serve(reqs)
        sync()
        window_s = time.perf_counter() - t0
    if server.graph_count() != graphs:
        raise RuntimeError(f"the window captured "
                           f"{server.graph_count() - graphs} CUDA graphs: "
                           f"set-up missed a signature")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    sl = tracer.slice() if tracer else None
    server.release()
    _log(f"# window: {window_s:.3f} s, {result['decode_steps']} decode "
         f"steps, peak {peak / 1e9:.2f} GB")

    by_rid = {r.rid: r for r in reqs}
    outputs = result["outputs"]
    sched = counts.schedule({r.rid: len(r.prompt) for r in reqs},
                            result["admissions"], outputs)
    failed = sum(len(outputs.get(r.rid, ())) != r.max_new for r in reqs)
    rids = check.sample(reqs, outputs, int(t["check"]["tokens"]), args.seed)
    t_ref = time.perf_counter()
    control = getattr(args, "control", None)
    found = (check.served(cell.config, params, by_rid, outputs, rids, device,
                          control) if rids else {})
    _log(f"# reference{' and control ' + control if control else ''}: "
         f"{len(rids)} requests, "
         f"{sum(len(outputs[r]) for r in rids)} served tokens, "
         f"{time.perf_counter() - t_ref:.2f} s")
    _log(f"# numbers: {json.dumps(found)}")
    checks = {k: {"value": found.get(k), "limit": float(lim)}
              for k, lim in cell.config["check"]["limits"].items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["decode_steps_off"] = {
        "value": abs(sched.steps - int(result["decode_steps"])), "limit": 0}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    info = cell_lib.Run(model=m, window_s=window_s, setup_s=setup_s,
                        sched=sched, tracer=tracer, slice=sl)
    metrics = {}
    for md in cell.metrics_of(bool(args.trace)):
        v = cell_lib.reader(root, md["name"])(info)
        if v is not None:
            metrics[md["name"]] = {"value": float(v), "unit": md["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": metrics, "device": dev}
    if args.trace:
        if sl is not None:
            dev["busy_s"] = trace.busy_us(sl) * 1e-6
            dev["window_s"] = sl.wall_s
            out["breakdown"] = trace.breakdown(sl)
            _log(f"# profiled slice: decode steps {sl.decode_steps[0]}-"
                 f"{sl.decode_steps[-1]}, {len(sl.admitted)} admissions, "
                 f"{len(sl.kernels)} device ops, {sl.wall_s:.3f} s")
        else:
            _log("# profiled slice: none (the window ended before it)")
    out["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return out, lines


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = _parse(argv)
    _cache_dirs(ROOT)
    _paths(ROOT)
    import torch

    from pbench import cell as cell_lib
    chips = cell_lib.load(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"portbench: needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out, lines = run(args, root=ROOT, device=torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        _log(f"portbench: the run loaded {', '.join(found)}")
        return 3
    for line in lines:
        _log(line)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
