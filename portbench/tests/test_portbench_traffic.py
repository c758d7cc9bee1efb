"""The request generator: deterministic per seed, within the stated
ranges, the same sizes in the same order for every seed, the longest
request in every window, and a size fixed by the file and the seconds."""

import json
import math

import numpy as np
import pytest

from conftest import BENCH
from pbench import traffic

MIX = {"prompt": {"dist": "lognormal", "median": 98, "sigma": 1.0,
                  "min": 32, "max": 1024},
       "completion": {"dist": "lognormal", "median": 205, "sigma": 1.0,
                      "min": 128, "max": 512}}
LOGN = {"prompt": {"dist": "lognormal", "median": 1020, "sigma": 0.5,
                   "min": 8, "max": 3584},
        "completion": {"dist": "lognormal", "median": 129, "sigma": 1.0,
                       "min": 1, "max": 512}}


@pytest.mark.parametrize("n", [1, 2, 7, 64, 301])
def test_window_is_deterministic_and_in_range(n):
    a = traffic.window(MIX, n, 2**31 + 5, vocab=1000)
    b = traffic.window(MIX, n, 2**31 + 5, vocab=1000)
    assert [(r.rid, r.max_new) for r in a] == [(r.rid, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    for r in a:
        assert 32 <= len(r.prompt) <= 1024 and 128 <= r.max_new <= 512
        assert r.prompt.dtype == np.int32
        assert r.prompt.min() >= 1 and r.prompt.max() < 1000


@pytest.mark.parametrize("mix", [MIX, LOGN])
def test_seeds_share_sizes_and_order(mix):
    a = traffic.window(mix, 50, 1, vocab=1000)
    b = traffic.window(mix, 50, 2**40 + 3, vocab=1000)
    assert [(len(r.prompt), r.max_new) for r in a] == \
        [(len(r.prompt), r.max_new) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    # the order is neither sorted nor the quantiles' own
    budgets = [r.max_new for r in a]
    assert budgets != sorted(budgets) and budgets != sorted(budgets)[::-1]


@pytest.mark.parametrize("n", [1, 3, 32, 100])
def test_every_window_holds_the_longest_request(n):
    for mix in (MIX, LOGN):
        pairs = traffic.sizes(mix, n)
        assert (mix["prompt"]["max"], mix["completion"]["max"]) in pairs
        assert max(-(-(p + c) // 16) for p, c in pairs) == \
            traffic.max_pages(mix, 16)


def test_count_is_rate_times_seconds():
    assert traffic.count({"rate": 2.2}, 51) == 112
    assert traffic.count({"rate": 5.0}, 51) == 255
    assert traffic.count({"rate": 0.01}, 10) == 1


def test_an_unknown_distribution_is_refused():
    with pytest.raises(ValueError, match="unknown length distribution"):
        traffic.sizes({"prompt": {"dist": "uniform", "min": 1, "max": 9},
                       "completion": LOGN["completion"]}, 5)


def test_lognormal_keeps_median_and_truncates():
    """Far from its ends, the truncated lognormal keeps the source's
    median and spread; nothing falls outside [min, max]."""
    pairs = traffic.sizes(LOGN, 4001)
    p = np.array([x for x, _ in pairs], float)
    c = np.array([y for _, y in pairs], float)
    assert abs(np.median(p) - 1020) < 15
    assert p.min() >= 8 and p.max() == 3584 and c.max() == 512
    q1, q3 = np.quantile(np.log(p), [0.25, 0.75])
    assert abs((q3 - q1) / (2 * 0.6745) - 0.5) < 0.02
    # the output's median moves down a little: 8% above 512 left out
    assert 115 <= np.median(c) <= 129
    assert (c <= 512).all() and (c >= 1).all()


@pytest.mark.parametrize("name", ["sharegpt-batch", "azure-conv-batch"])
def test_traffic_files_follow_their_source(name):
    """Each lognormal passes through the published mean, and through the
    published median where the source gives one."""
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    assert t["source"] and t["rate"] > 0
    pub = t["published"]
    for k in ("prompt", "completion"):
        d = t[k]
        mean = d["median"] * math.exp(d["sigma"] ** 2 / 2)
        assert mean == pytest.approx(pub[f"{k}_mean"], rel=0.01)
        if f"{k}_median" in pub:
            assert d["median"] == pub[f"{k}_median"]


def test_bucket_is_the_schedulers():
    from repro_torch.launch.serve import _bucket
    for n in (1, 8, 9, 33, 1024, 1025, 8192):
        assert traffic.bucket(n) == _bucket(n)
