"""Traffic profiles: the recorded workload distribution the sweep tunes for
(the port of ``repro/plans/profile.py``; the same JSON format).

A :class:`TrafficProfile` aggregates the
:class:`repro_torch.core.profiling.CallSite`
stream from a real run (serving, training) into *buckets*: call sites that
agree on everything except their dynamic shape dims, with those dims rounded
up to the next power of two. Bucketing is what makes dynamic-shape traffic
tunable offline — a serving run sees hundreds of distinct prompt lengths,
but only a handful of pow2 buckets, and a plan measured at the bucket shape
transfers to every exact shape inside it (the sweep still writes the tuned
record under every *exact* plan key observed, so serving lookups are exact-
match and never approximate).

Each bucket keeps its observation count plus the exact workload variants
seen, so :mod:`repro_torch.plans.sweep` can (a) rank buckets by observed
frequency x modeled cost and (b) emit one PlanDB record per exact key.

Profiles are plain JSON (``PROFILE_FORMAT_VERSION``-stamped), mergeable
across runs/hosts with :meth:`TrafficProfile.merge`, and deterministic:
the same call-site stream always serializes to the same bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

from repro_torch.core import profiling
from repro_torch.core.profiling import CallSite

PROFILE_FORMAT_VERSION = 1


def bucket_value(v: int) -> int:
    """Next power of two >= v (positive ints; <=0 passes through).
    Deterministic and idempotent — bucketing a bucket is a no-op."""
    if v <= 0:
        return v
    return 1 << (int(v) - 1).bit_length()


def bucket_site(site: Optional[Mapping[str, Any]],
                dynamic: Iterable[str]) -> Optional[Dict[str, Any]]:
    """Round the dynamic (traffic-dependent) keys of a call-site shape dict
    up to powers of two; static keys (block sizes, flags, group counts)
    pass through untouched — rounding those would change kernel semantics,
    not just the shape point."""
    if site is None:
        return None
    dyn = set(dynamic)
    out = {}
    for k in sorted(site):
        v = site[k]
        if k in dyn and isinstance(v, int) and not isinstance(v, bool):
            out[k] = bucket_value(v)
        else:
            out[k] = v
    return out


def _canon(obj) -> str:
    """Canonical JSON (sorted keys, tuples as lists) — bucket/variant
    identity."""
    return json.dumps(obj, sort_keys=True, default=list)


def _bucket_workload(workload_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Fallback bucketing for call sites with no shape dict (graphs, legacy
    planner callers): round the word count — the only traffic-dependent
    Workload field — to a power of two."""
    out = dict(workload_dict)
    out["n_words"] = bucket_value(int(out.get("n_words", 0)))
    return out


@dataclasses.dataclass
class ProfileEntry:
    """One shape bucket: everything that identifies the call site except
    the exact dynamic shapes, plus the exact variants observed in it."""

    op: str
    dtype: str
    hw: str
    mesh_axes: Tuple[Tuple[str, int], ...]
    extra_key: str
    origin: str
    policy: Dict[str, Any]
    site: Optional[Dict[str, Any]]          # bucketed shape dict
    site_dynamic: Tuple[str, ...]
    tile: Tuple[int, ...]
    count: int = 0
    # canonical exact-workload JSON -> {"workload": dict, "count": int}
    variants: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    def to_payload(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_axes"] = [list(ax) for ax in self.mesh_axes]
        d["site_dynamic"] = list(self.site_dynamic)
        d["tile"] = list(self.tile)
        return d

    @classmethod
    def from_payload(cls, d: Mapping[str, Any]) -> "ProfileEntry":
        return cls(
            op=d["op"], dtype=d["dtype"], hw=d["hw"],
            mesh_axes=tuple((str(n), int(s)) for n, s in d["mesh_axes"]),
            extra_key=d.get("extra_key", ""),
            origin=d.get("origin", "autotune"),
            policy=dict(d["policy"]),
            site=dict(d["site"]) if d.get("site") is not None else None,
            site_dynamic=tuple(d.get("site_dynamic", ())),
            tile=tuple(int(t) for t in d.get("tile", ())),
            count=int(d["count"]),
            variants={k: {"workload": dict(v["workload"]),
                          "count": int(v["count"])}
                      for k, v in d.get("variants", {}).items()})


def bucket_key(cs: CallSite) -> str:
    """Deterministic bucket identity of one call site. Excludes the policy
    *mode* (a profile recorded under mode="ff" is swept for serving under
    mode="autotune") but includes the fields that constrain the search
    space or the measured kernel (pins, stream_options, interpret)."""
    pol = cs.policy
    pol_sig = {"depth": pol["depth"], "streams": pol["streams"],
               "stream_options": list(pol["stream_options"]),
               "interpret": pol["interpret"]}
    site_b = bucket_site(cs.site, cs.site_dynamic)
    if site_b is None:
        site_b = _bucket_workload(dataclasses.asdict(cs.workload))
    return _canon([cs.op, cs.dtype, cs.hw, [list(ax) for ax in cs.mesh_axes],
                   cs.extra_key, pol_sig, site_b])


class TrafficProfile:
    """Bucketed aggregate of recorded call sites (see module docstring)."""

    def __init__(self):
        self.entries: Dict[str, ProfileEntry] = {}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def total_count(self) -> int:
        return sum(e.count for e in self.entries.values())

    def observe(self, cs: CallSite) -> None:
        key = bucket_key(cs)
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = ProfileEntry(
                op=cs.op, dtype=cs.dtype, hw=cs.hw,
                mesh_axes=tuple(cs.mesh_axes), extra_key=cs.extra_key,
                origin=cs.origin,
                policy={k: (list(v) if isinstance(v, tuple) else v)
                        for k, v in cs.policy.items()},
                site=bucket_site(cs.site, cs.site_dynamic),
                site_dynamic=tuple(cs.site_dynamic), tile=tuple(cs.tile))
        entry.count += 1
        wl = dataclasses.asdict(cs.workload)
        vkey = _canon(wl)
        var = entry.variants.setdefault(vkey, {"workload": wl, "count": 0})
        var["count"] += 1

    def merge(self, other: "TrafficProfile") -> "TrafficProfile":
        """Fold another profile's observations into this one (counts add,
        variants union). Returns self."""
        for key, oe in other.entries.items():
            e = self.entries.get(key)
            if e is None:
                self.entries[key] = dataclasses.replace(
                    oe, variants={k: dict(v) for k, v in oe.variants.items()})
                continue
            e.count += oe.count
            for vkey, var in oe.variants.items():
                mine = e.variants.setdefault(
                    vkey, {"workload": dict(var["workload"]), "count": 0})
                mine["count"] += var["count"]
        return self

    def to_payload(self) -> dict:
        return {"format": PROFILE_FORMAT_VERSION,
                "entries": {k: self.entries[k].to_payload()
                            for k in sorted(self.entries)}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_payload(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_payload(cls, payload: Mapping[str, Any]) -> "TrafficProfile":
        if payload.get("format") != PROFILE_FORMAT_VERSION:
            raise ValueError(
                f"traffic profile format {payload.get('format')!r} != "
                f"{PROFILE_FORMAT_VERSION}")
        prof = cls()
        for key, d in payload.get("entries", {}).items():
            prof.entries[key] = ProfileEntry.from_payload(d)
        return prof

    @classmethod
    def load(cls, path: str) -> "TrafficProfile":
        with open(path) as f:
            return cls.from_payload(json.load(f))


@contextlib.contextmanager
def record_traffic(path: Optional[str] = None,
                   profile: Optional[TrafficProfile] = None):
    """Record every plan resolution in the scope into a TrafficProfile.

    Installs the core recording hook (:mod:`repro_torch.core.profiling`)
    for the duration of the ``with`` block, restoring whatever recorder was
    there before. ``path`` (if given) is written on exit. Note: call sites
    inside a compiled step are recorded once per *capture*, not per replay
    — counts weight distinct shapes, not wall-clock frequency of replays
    (the reference records once per trace).
    """
    prof = profile if profile is not None else TrafficProfile()
    prev = profiling.set_recorder(prof.observe)
    try:
        yield prof
    finally:
        profiling.set_recorder(prev)
        if path:
            prof.save(path)
