"""Plan-service CLI: ``python -m repro_torch.plans <sweep|merge|show>``.

    # tune a PlanDB from a recorded traffic profile on the card (1 minute
    # budget; --device cpu times the plain versions instead)
    python -m repro_torch.plans sweep --profile traffic.json \
        --db plans_db.json --budget-s 60

    # combine per-host artifacts into the release DB
    python -m repro_torch.plans merge --out release_db.json hostA.json hostB.json

    # inspect an artifact or a profile
    python -m repro_torch.plans show plans_db.json
    python -m repro_torch.plans show traffic.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.plans.plandb import PlanDB, PlanDBError
from repro_torch.plans.profile import TrafficProfile
from repro_torch.plans.sweep import entry_priority, sweep_profile


def _cmd_sweep(args) -> int:
    profile = TrafficProfile.load(args.profile)
    db = PlanDB()
    if args.merge_into and os.path.exists(args.merge_into):
        db = PlanDB.load(args.merge_into)
    scratch = args.scratch_cache or os.path.join(
        tempfile.mkdtemp(prefix="repro-torch-sweep-"), "plans.json")
    result = sweep_profile(
        profile, db=db, namespace=args.namespace, budget_s=args.budget_s,
        scratch_cache=scratch, warmup=args.warmup, iters=args.iters,
        top_k=args.top_k, device=args.device)
    result.db.save(args.db)
    print(json.dumps(result.to_payload(), indent=2, sort_keys=True))
    print(f"wrote {args.db}")
    return 0


def _cmd_merge(args) -> int:
    if not args.dbs:
        print("merge: need at least one input DB", file=sys.stderr)
        return 2
    merged = PlanDB.load(args.dbs[0])
    for path in args.dbs[1:]:
        report = merged.merge(PlanDB.load(path))
        print(f"# merged {path}: +{report.added} added, "
              f"{report.replaced} replaced, {report.kept} kept, "
              f"{len(report.conflicts)} conflicts")
        for line in report.conflicts:
            print(f"#   conflict {line}")
    merged.save(args.out)
    print(json.dumps(merged.stats(), indent=2, sort_keys=True))
    print(f"wrote {args.out}")
    return 0


def _cmd_show(args) -> int:
    with open(args.path) as f:
        payload = json.load(f)
    if "namespaces" in payload:
        db = PlanDB.load(args.path)
        print(json.dumps(db.stats(), indent=2, sort_keys=True))
    else:
        prof = TrafficProfile.from_payload(payload)
        buckets = sorted(prof.entries.values(),
                         key=lambda e: -entry_priority(e))
        print(f"traffic profile: {len(prof)} buckets, "
              f"{prof.total_count} observations")
        for e in buckets:
            print(f"  {e.op:24s} count={e.count:5d} "
                  f"variants={len(e.variants)} dtype={e.dtype} hw={e.hw} "
                  f"mesh={dict(e.mesh_axes)} site={e.site}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.plans",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="tune a PlanDB from a traffic profile")
    sp.add_argument("--profile", required=True)
    sp.add_argument("--db", required=True, help="output PlanDB path")
    sp.add_argument("--merge-into", default=None,
                    help="existing PlanDB to fold the sweep into")
    sp.add_argument("--namespace", default=None,
                    help="target namespace (default: this host's "
                         "fingerprint namespace)")
    sp.add_argument("--budget-s", type=float, default=None)
    sp.add_argument("--warmup", type=int, default=1)
    sp.add_argument("--iters", type=int, default=2)
    sp.add_argument("--top-k", type=int, default=None,
                    help="measured candidates per bucket "
                         "(default: tuner default)")
    sp.add_argument("--scratch-cache", default=None,
                    help="throwaway per-host plan cache used during the "
                         "sweep (default: fresh tempdir)")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default: time the kernels on the card; "
                         "raises without one) or cpu (the plain versions)")
    sp.set_defaults(fn=_cmd_sweep)

    mp = sub.add_parser("merge", help="merge PlanDB artifacts")
    mp.add_argument("--out", required=True)
    mp.add_argument("dbs", nargs="+")
    mp.set_defaults(fn=_cmd_merge)

    hp = sub.add_parser("show", help="inspect a PlanDB or traffic profile")
    hp.add_argument("path")
    hp.set_defaults(fn=_cmd_show)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (PlanDBError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
