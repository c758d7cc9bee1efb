"""PlanDB: the versioned, mergeable, release-shippable tuned-plan artifact
(the port of ``repro/plans/plandb.py``; the same JSON format).

Where ``~/.cache/repro_torch/plans.json`` is one host's private cache, a PlanDB
is the *fleet* artifact: content-addressed tuned-plan records keyed by the
autotuner's exact ``plan_key`` and partitioned into hardware namespaces
(:mod:`repro_torch.plans.registry`), so one file tuned on heterogeneous hosts
ships with a release and pre-warms every process.

Lookup chain position (see ``autotune.resolve_call``): in-memory -> per-host
disk cache (``REPRO_TORCH_PLAN_CACHE``) -> **PlanDB**
(``REPRO_TORCH_PLAN_DB``) ->
measure -> analytic. The DB is read-only at serving time: freshly measured
plans go to the host cache and only enter a DB through an offline sweep or
an explicit merge.

Merge semantics (deterministic — merging the same files in any association
order yields the same artifact):

* disjoint keys/namespaces: union (foreign namespaces are preserved
  bitwise — merging never rewrites records it did not touch);
* same key, identical content hash: kept (refreshed ``tuned_at`` wins so
  re-tuning the same answer still advances the timestamp);
* same key, different content: the newer ``tuned_at`` wins; exact-tie
  timestamps break toward the lexicographically larger content hash, and
  every such conflict is reported in the :class:`MergeReport`.

Strictness is asymmetric by design: :meth:`PlanDB.load` and
:meth:`PlanDB.merge` *raise* (:class:`PlanDBError`) on corrupt files or
format mismatches — an artifact pipeline must never silently mix formats —
while the serving-side :func:`lookup`/:func:`prewarm` degrade to an empty
DB with a one-shot warning, because at runtime the DB is a cache tier, not
a source of failure.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.autotune import PLAN_FORMAT_VERSION
from repro_torch.plans import registry as plan_registry

PLANDB_FORMAT_VERSION = 1

# record fields excluded from the content hash: provenance, not plan content
_VOLATILE_FIELDS = ("tuned_at", "content_hash")


class PlanDBError(ValueError):
    """Corrupt PlanDB file, or a format/plan-format mismatch."""


def content_hash(record: Mapping[str, Any]) -> str:
    """sha256 of the canonical-JSON record body (volatile provenance
    fields excluded) — two records with the same hash carry the same
    plan."""
    body = {k: v for k, v in record.items() if k not in _VOLATILE_FIELDS}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=list).encode()).hexdigest()


@dataclasses.dataclass
class MergeReport:
    added: int = 0        # keys only the other DB had
    replaced: int = 0     # same key, other's record won
    kept: int = 0         # same key, ours won (or identical content)
    conflicts: List[str] = dataclasses.field(default_factory=list)


class PlanDB:
    """In-memory PlanDB: ``namespaces[namespace][plan_key] -> record``."""

    def __init__(self, namespaces: Optional[Dict[str, Dict[str, dict]]] = None,
                 plan_format: int = PLAN_FORMAT_VERSION):
        self.plan_format = int(plan_format)
        self.namespaces: Dict[str, Dict[str, dict]] = \
            {ns: dict(recs) for ns, recs in (namespaces or {}).items()}

    # -- content ------------------------------------------------------------

    def put(self, namespace: str, key: str, record: Mapping[str, Any],
            tuned_at: Optional[float] = None) -> dict:
        """Stamp + store one tuned-plan record (a fresh dict; ``source`` —
        a lookup-time annotation, not plan content — is dropped)."""
        rec = {k: v for k, v in record.items() if k != "source"}
        rec["tuned_at"] = float(tuned_at if tuned_at is not None
                                else time.time())
        rec["content_hash"] = content_hash(rec)
        self.namespaces.setdefault(namespace, {})[key] = rec
        return rec

    def get(self, namespace: str, key: str) -> Optional[dict]:
        return self.namespaces.get(namespace, {}).get(key)

    def records(self, namespace: str) -> Dict[str, dict]:
        return dict(self.namespaces.get(namespace, {}))

    def stats(self) -> dict:
        return {"plan_format": self.plan_format,
                "namespaces": {ns: len(recs)
                               for ns, recs in sorted(self.namespaces.items())},
                "records": sum(len(r) for r in self.namespaces.values())}

    # -- merge --------------------------------------------------------------

    def merge(self, other: "PlanDB") -> MergeReport:
        """Fold ``other`` into this DB under the deterministic semantics in
        the module docstring. Raises :class:`PlanDBError` on plan-format
        mismatch: records keyed under different plan formats are not
        comparable, so the merge is refused rather than guessed at."""
        if other.plan_format != self.plan_format:
            raise PlanDBError(
                f"cannot merge PlanDB with plan format {other.plan_format} "
                f"into one with {self.plan_format}")
        report = MergeReport()
        for ns, theirs in other.namespaces.items():
            mine = self.namespaces.setdefault(ns, {})
            for key, rec_o in theirs.items():
                rec_m = mine.get(key)
                if rec_m is None:
                    mine[key] = dict(rec_o)
                    report.added += 1
                    continue
                h_m, h_o = rec_m.get("content_hash"), rec_o.get("content_hash")
                t_m = float(rec_m.get("tuned_at", 0.0))
                t_o = float(rec_o.get("tuned_at", 0.0))
                if h_m == h_o:
                    # same plan: keep ours, advance the timestamp
                    rec_m["tuned_at"] = max(t_m, t_o)
                    report.kept += 1
                    continue
                theirs_win = (t_o, str(h_o)) > (t_m, str(h_m))
                report.conflicts.append(
                    f"{ns}:{key[:96]}: {h_m and h_m[:12]} (t={t_m:.3f}) vs "
                    f"{h_o and h_o[:12]} (t={t_o:.3f}) -> "
                    f"{'theirs' if theirs_win else 'ours'}")
                if theirs_win:
                    mine[key] = dict(rec_o)
                    report.replaced += 1
                else:
                    report.kept += 1
        return report

    # -- (de)serialization --------------------------------------------------

    def to_payload(self) -> dict:
        return {"format": PLANDB_FORMAT_VERSION,
                "plan_format": self.plan_format,
                "namespaces": self.namespaces}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "PlanDB":
        """Strict load: raises :class:`PlanDBError` on unreadable/corrupt
        files or a PlanDB format mismatch (artifact tooling must fail
        loudly; the serving path uses :func:`lookup` instead)."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, ValueError) as e:
            raise PlanDBError(f"corrupt PlanDB {path}: {e}") from e
        if not isinstance(payload, dict) \
                or payload.get("format") != PLANDB_FORMAT_VERSION \
                or not isinstance(payload.get("namespaces"), dict):
            raise PlanDBError(
                f"{path}: PlanDB format {payload.get('format')!r} != "
                f"{PLANDB_FORMAT_VERSION}")
        return cls(namespaces=payload["namespaces"],
                   plan_format=int(payload.get("plan_format", -1)))


# ---------------------------------------------------------------------------
# Serving-side lookup (the autotune lookup-chain tier)
# ---------------------------------------------------------------------------

# path -> (namespaces dict or {}, usable) — parsed once per process, like
# autotune._DISK; cleared by clear_cache()
_CACHE: Dict[str, Tuple[Dict[str, Dict[str, dict]], bool]] = {}
_WARNED: set = set()


def clear_cache() -> None:
    """Drop the parsed-DB cache (tests; mirrors autotune.tuned_cache_clear)."""
    _CACHE.clear()
    _WARNED.clear()


def _load_for_serving(path: str) -> Dict[str, Dict[str, dict]]:
    cached = _CACHE.get(path)
    if cached is not None:
        return cached[0]
    try:
        db = PlanDB.load(path)
        if db.plan_format != PLAN_FORMAT_VERSION:
            raise PlanDBError(
                f"{path}: plan format {db.plan_format} != current "
                f"{PLAN_FORMAT_VERSION} (re-sweep the artifact)")
        namespaces, usable = db.namespaces, True
    except FileNotFoundError:
        namespaces, usable = {}, False
    except PlanDBError as e:
        if path not in _WARNED:
            _WARNED.add(path)
            warnings.warn(
                f"ignoring unusable PlanDB ({e}); lookups fall through to "
                f"measurement or the analytic planner", RuntimeWarning,
                stacklevel=3)
        namespaces, usable = {}, False
    _CACHE[path] = (namespaces, usable)
    return namespaces


def lookup(key: str, *, path: str,
           namespace: Optional[str] = None) -> Optional[dict]:
    """Serving-side record lookup: this process's namespace first, then
    :data:`~repro_torch.plans.registry.DEFAULT_NAMESPACE`. Never raises — a
    missing/corrupt/mismatched DB reads as empty (warned once per path)."""
    namespaces = _load_for_serving(path)
    if not namespaces:
        return None
    ns = namespace or plan_registry.plan_namespace()
    for candidate in (ns, plan_registry.DEFAULT_NAMESPACE):
        rec = namespaces.get(candidate, {}).get(key)
        if rec is not None:
            return rec
    return None


def prewarm(path: str, namespace: Optional[str] = None) -> dict:
    """Parse the DB once at startup (so the first resolution is a dict
    lookup, not file IO) and report coverage for this process's
    namespace. Returns a stats dict; never raises."""
    t0 = time.perf_counter()
    namespaces = _load_for_serving(path)
    ns = namespace or plan_registry.plan_namespace()
    return {
        "path": path,
        "usable": bool(_CACHE.get(path, ({}, False))[1]),
        "namespace": ns,
        "records_in_namespace": len(namespaces.get(ns, {})),
        "records_in_default": len(
            namespaces.get(plan_registry.DEFAULT_NAMESPACE, {})),
        "namespaces": {n: len(r) for n, r in sorted(namespaces.items())},
        "prewarm_s": time.perf_counter() - t0,
    }
