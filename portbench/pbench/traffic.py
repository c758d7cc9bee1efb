"""The one request generator: a traffic file's parameters in, a window's
requests out.

A traffic file (``traffic/<name>.json``) states the length distributions
of prompts and completions, as a public trace or dataset reports them,
and ``rate``: requests a second of window. A run of ``--seconds`` serves
``round(rate * seconds)`` requests, so the work depends on the file and
``--seconds`` alone, never on a measured time. A window of ``n`` requests
takes the midpoint quantiles ``(i + 1/2) / (n - 1)`` of each distribution
for ``n - 1`` of them, paired by a permutation fixed by ``n``, and the
longest request the file allows (both maxima), so the scheduler's
block tables (sized by the longest request) have one shape for every
window of a traffic file. The requests are submitted in an order fixed by
``n`` too, and the scheduler serves them first come, first served. So
every seed does the same work: the seed draws only the prompts' token ids
(and the weights). Every request is present at the window's start (a
backlog), so no arrival times are drawn.

A length distribution (in tokens) is ``{"dist": "lognormal", "median",
"sigma", "min", "max"}``, truncated to ``[min, max]`` (both ends
inclusive): what a source's filter leaves, in its proportions.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, NamedTuple

import numpy as np

# the pairing of prompt and completion quantiles and the submission
# order: fixed by the window's size, never by the seed
_PAIRING_SEED = 0x5EED_7A1F
_ORDER_SEED = 0x0BDE_4F1F


class Req(NamedTuple):
    rid: int
    prompt: np.ndarray     # [len] int32 token ids in [1, vocab)
    max_new: int


def _inverse_cdf(dist: Dict, u: np.ndarray) -> np.ndarray:
    lo, hi = int(dist["min"]), int(dist["max"])
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range {lo}..{hi}")
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = NormalDist(math.log(float(dist["median"])), float(dist["sigma"]))
    a, b = nd.cdf(math.log(lo - 0.5)), nd.cdf(math.log(hi + 0.5))
    x = np.exp([nd.inv_cdf(a + float(v) * (b - a)) for v in u])
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def count(traffic: Dict, seconds: float) -> int:
    """Requests in a window of ``seconds``: the file's rate times it."""
    return max(1, int(round(float(traffic["rate"]) * float(seconds))))


def sizes(traffic: Dict, n: int) -> List[tuple]:
    """The window's (prompt length, completion budget) pairs in the order
    they are submitted: the same for every seed."""
    if n < 1:
        raise ValueError("a window needs at least one request")
    u = (np.arange(n - 1) + 0.5) / max(n - 1, 1)
    prompts = _inverse_cdf(traffic["prompt"], u)
    comps = _inverse_cdf(traffic["completion"], u)
    comps = comps[np.random.default_rng(_PAIRING_SEED + n).permutation(
        n - 1)]
    pairs = [(int(p), int(c)) for p, c in zip(prompts, comps)]
    pairs.append((int(traffic["prompt"]["max"]),
                  int(traffic["completion"]["max"])))
    order = np.random.default_rng(_ORDER_SEED + n).permutation(n)
    return [pairs[j] for j in order]


def window(traffic: Dict, n: int, seed: int, vocab: int) -> List[Req]:
    """``n`` requests: :func:`sizes` in their order, each prompt's ids
    drawn from ``seed``, uniform in [1, vocab)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x7AFF])
    return [Req(rid, rng.integers(1, vocab, size=p).astype(np.int32), c)
            for rid, (p, c) in enumerate(sizes(traffic, n))]


def max_pages(traffic: Dict, page: int) -> int:
    """Pages the longest possible request reserves (prompt + budget)."""
    total = int(traffic["prompt"]["max"]) + int(traffic["completion"]["max"])
    return -(-total // page)


def bucket(n: int, lo: int = 8) -> int:
    """The prefill bucket of an ``n``-token prompt: the scheduler's
    power-of-two padding (``launch/serve.py``), restated here so the
    harness counts padding without calling the program."""
    b = lo
    while b < n:
        b *= 2
    return b
