"""Straggler detection and mitigation policy (the port of
``repro/runtime/stragglers.py``; plain Python, no device code).

At 1000+ nodes the slowest participant sets the step time of a
synchronous job. The watchdog keeps a robust median/MAD model of per-step
durations: an observation is an outlier when it exceeds ``median +
mad_factor * 1.4826 * MAD`` (1.4826 scales the MAD to a sigma-equivalent
for normal noise). When the MAD is 0 (every sample identical, the
degenerate window a fresh job starts with) the model falls back to the
multiplicative ``slow_factor * median`` threshold. Persistent outliers
trigger a mitigation action:

  "none"            within tolerance
  "rebalance"       transient slowness: shrink that host's data shard
                    (the :class:`BatchRebalancer` hook: a smaller shard
                    is a smaller local word schedule, so the host's pipes
                    re-plan at the shrunk shape)
  "replace"         persistent: promote a hot spare, evict the host, and
                    remesh from the checkpoint

The policy is bookkeeping on the host, testable without hardware; the
trainer feeds ``observe_step`` from its step timer and ``mitigate`` makes
the returned actions real through the hooks.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

# MAD -> sigma-equivalent scale for normally distributed noise
_MAD_SCALE = 1.4826


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50
    slow_factor: float = 1.5       # x median step time = outlier (MAD == 0)
    mad_factor: float = 5.0        # sigma-equivalents above median (MAD > 0)
    tolerate: int = 3              # consecutive outliers before rebalance
    evict_after: int = 10          # consecutive outliers before replace
    hot_spares: int = 2


def _median(vals: Sequence[float]) -> float:
    """True median: mean of the two middle elements for even lengths."""
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return float(s[mid])
    return float((s[mid - 1] + s[mid]) / 2.0)


class BatchRebalancer:
    """Per-host data-shard shares, shrinkable when a host straggles.

    ``shares[host]`` is the number of batch rows (or micro-shards) the host
    owns. :meth:`shrink` halves a slow host's share (never below
    ``min_share``) and redistributes nothing — synchronous SPMD means the
    freed rows pad the global batch's other shards implicitly; what matters
    for the stream stack is that the *local* workload changed, so the
    ``replan`` hook re-plans the host's pipes at the shrunk shape (e.g. by
    running the kernel once at the new local batch under its mesh-tagged
    policy, which repopulates the planner/autotune caches at the new
    workload key).
    """

    def __init__(self, shares: Dict[str, int], *, min_share: int = 1,
                 replan: Optional[Callable[[str, int], Any]] = None):
        self.shares = dict(shares)
        self.min_share = int(min_share)
        self.replan = replan
        self.shrunk: Dict[str, int] = {}     # host -> number of shrinks
        self.last_replan: Dict[str, Any] = {}

    def shrink(self, host: str) -> int:
        """Halve ``host``'s share (floor ``min_share``); re-plan via the
        hook when the share actually changed. Returns the new share."""
        old = self.shares.get(host)
        if old is None:
            return 0
        new = max(old // 2, self.min_share)
        if new != old:
            self.shares[host] = new
            self.shrunk[host] = self.shrunk.get(host, 0) + 1
            if self.replan is not None:
                self.last_replan[host] = self.replan(host, new)
        return new

    def drop(self, host: str) -> None:
        self.shares.pop(host, None)

    def total(self) -> int:
        return sum(self.shares.values())


class StragglerWatchdog:
    def __init__(self, cfg: StragglerConfig, hosts: List[str],
                 rebalancer: Optional[BatchRebalancer] = None,
                 on_replace: Optional[Callable[[str], Any]] = None):
        self.cfg = cfg
        self.hosts = list(hosts)
        self.spares: List[str] = [f"spare_{i}" for i in range(cfg.hot_spares)]
        self._times: Dict[str, Deque[float]] = {
            h: deque(maxlen=cfg.window) for h in hosts}
        self._strikes: Dict[str, int] = {h: 0 for h in hosts}
        self.evicted: List[str] = []
        self.rebalancer = rebalancer
        self.on_replace = on_replace
        self.mitigations: List[Dict[str, Any]] = []   # audit log of actions

    def _all_samples(self) -> List[float]:
        return [t for dq in self._times.values() for t in dq]

    def _threshold(self) -> float:
        """Outlier threshold of the current window: median + k*MAD
        (sigma-scaled), falling back to ``slow_factor * median`` when the
        MAD is 0 (degenerate window — all samples identical)."""
        samples = self._all_samples()
        med = _median(samples)
        if med <= 0:
            return 0.0
        mad = _median([abs(t - med) for t in samples])
        if mad > 0:
            return med + self.cfg.mad_factor * _MAD_SCALE * mad
        return self.cfg.slow_factor * med

    def observe_step(self, host_times: Dict[str, float]) -> Dict[str, str]:
        """Feed per-host step durations; returns {host: action}."""
        actions: Dict[str, str] = {}
        for h, t in host_times.items():
            if h not in self._times:
                continue
            self._times[h].append(t)
        thr = self._threshold()
        for h, t in host_times.items():
            if h not in self._times:
                continue
            if thr > 0 and t > thr:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.cfg.evict_after:
                actions[h] = "replace"
            elif self._strikes[h] >= self.cfg.tolerate:
                actions[h] = "rebalance"
            else:
                actions[h] = "none"
        return actions

    def mitigate(self, actions: Dict[str, str]) -> Dict[str, Any]:
        """Make the policy's actions real through the wired hooks.

        "rebalance" shrinks the host's data shard via the
        :class:`BatchRebalancer` (which re-plans the host's local pipes at
        the shrunk shape); "replace" first drives the ``on_replace`` hook
        (the trainer's survivable_mesh + remesh_restore path) and then
        applies the bookkeeping eviction/spare promotion. Returns
        {host: outcome} for the non-"none" actions taken."""
        outcomes: Dict[str, Any] = {}
        for host, action in actions.items():
            if action == "rebalance" and self.rebalancer is not None:
                old_share = self.rebalancer.shares.get(host)
                new_share = self.rebalancer.shrink(host)
                if new_share != old_share:
                    # the shrunk shard gets a fresh chance; an already-
                    # floored share keeps its strikes so "replace" stays
                    # reachable when shrinking can no longer help
                    self._strikes[host] = 0
                outcomes[host] = {"action": "rebalance", "share": new_share}
            elif action == "replace":
                replaced = None
                if self.on_replace is not None:
                    replaced = self.on_replace(host)
                spare = self.replace(host)
                if self.rebalancer is not None:
                    self.rebalancer.drop(host)
                outcomes[host] = {"action": "replace", "spare": spare,
                                  "remesh": replaced}
            if host in outcomes:
                self.mitigations.append({"host": host, **outcomes[host]})
        return outcomes

    def step(self, host_times: Dict[str, float]) -> Dict[str, Any]:
        """observe + mitigate in one call (the trainer's per-step entry)."""
        return self.mitigate(self.observe_step(host_times))

    def replace(self, host: str) -> Optional[str]:
        """Evict ``host``; return the promoted spare (or None -> shrink)."""
        if host not in self.hosts:
            return None
        self.hosts.remove(host)
        self.evicted.append(host)
        self._times.pop(host, None)
        self._strikes.pop(host, None)
        if self.spares:
            spare = self.spares.pop(0)
            self.hosts.append(spare)
            self._times[spare] = deque(maxlen=self.cfg.window)
            self._strikes[spare] = 0
            return spare
        return None
