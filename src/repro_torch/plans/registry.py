"""Device/backend registry: hardware fingerprints -> plan namespaces (the
port of ``repro/plans/registry.py``).

One PlanDB artifact serves a heterogeneous fleet by partitioning records
into *namespaces*, one per hardware class. This module maps the hardware a
process actually runs on (its *fingerprint*: platform, device name,
compute capability, device count, from ``torch.cuda``) to the namespace its lookups should hit.

Resolution follows the ludwig registry idiom (SNIPPETS.md): named resolver
functions self-register via a decorator; non-default resolvers are
consulted in sorted-name order and the first non-None answer wins, with
default-registered resolvers as the fallback tier. Deployments add their
own hardware classes by registering a resolver — no core edits:

    from repro_torch.plans import registry

    @registry.register_fingerprint_resolver("my-pod")
    def _my_pod(fp):
        if fp["platform"] == "cuda" and fp["device_count"] >= 8:
            return "cuda.h100-node"
        return None

``REPRO_TORCH_PLAN_NAMESPACE`` overrides everything (operator escape hatch), and
:data:`DEFAULT_NAMESPACE` ("default") is the shared namespace lookups fall
back to when an artifact carries no records for this hardware class.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

# namespace consulted when the fingerprint namespace has no record: a
# publisher can ship conservative plans for unknown fleet members here
DEFAULT_NAMESPACE = "default"

Resolver = Callable[[Dict[str, object]], Optional[str]]

_RESOLVERS: Dict[str, Resolver] = {}
_DEFAULT_RESOLVERS: Dict[str, Resolver] = {}


def register_fingerprint_resolver(name: str, default: bool = False):
    """Decorator registering ``fn(fingerprint) -> namespace | None`` under
    ``name``. ``default=True`` puts it in the fallback tier (consulted only
    when every non-default resolver abstains)."""
    def wrap(fn: Resolver) -> Resolver:
        (_DEFAULT_RESOLVERS if default else _RESOLVERS)[name] = fn
        return fn
    return wrap


def _sanitize(s: str) -> str:
    return re.sub(r"[^a-z0-9.]+", "-", str(s).lower()).strip("-") or "unknown"


def hardware_fingerprint() -> Dict[str, object]:
    """What this process runs on: the card's name, compute capability and
    count from ``torch.cuda``; ``cpu`` when no card is present (plan
    tooling must work on machines with no accelerator), as the reference's
    reports its CPU backend."""
    try:
        import torch
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            return {"platform": "cuda",
                    "device_kind": torch.cuda.get_device_name(0),
                    "capability": f"{major}.{minor}",
                    "device_count": torch.cuda.device_count()}
        return {"platform": "cpu", "device_kind": "cpu",
                "device_count": 1}
    except Exception:   # noqa: BLE001 — no backend is a valid tooling state
        return {"platform": "unknown", "device_kind": "none",
                "device_count": 0}


@register_fingerprint_resolver("generic", default=True)
def _generic(fp: Dict[str, object]) -> str:
    """Fallback namespace: ``<platform>.<device-kind>`` (e.g. ``cpu.cpu``,
    ``cuda.nvidia-h100-80gb-hbm3``) — every fingerprint resolves
    somewhere."""
    return f"{_sanitize(fp['platform'])}.{_sanitize(fp['device_kind'])}"


def plan_namespace(fingerprint: Optional[Dict[str, object]] = None) -> str:
    """The namespace this process's PlanDB lookups hit.

    Order: ``$REPRO_TORCH_PLAN_NAMESPACE`` > registered resolvers (sorted name
    order) > default-tier resolvers. Always returns a non-empty token."""
    env = os.environ.get("REPRO_TORCH_PLAN_NAMESPACE")
    if env:
        return env
    fp = fingerprint if fingerprint is not None else hardware_fingerprint()
    for tier in (_RESOLVERS, _DEFAULT_RESOLVERS):
        for name in sorted(tier):
            ns = tier[name](fp)
            if ns:
                return str(ns)
    return DEFAULT_NAMESPACE
