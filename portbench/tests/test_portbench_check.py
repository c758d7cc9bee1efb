"""The output check's numbers against hand counts."""

import pytest
import torch

from pbench import check


def test_gaps_and_stats_by_hand():
    ref = torch.tensor([[3.0, 1.0, 0.0], [0.0, 2.0, 1.5], [1.0, 1.2, 4.0],
                        [0.0, 0.3, 0.2]])
    tok = torch.tensor([0, 2, 2, 2])
    assert check.gaps(ref, tok).tolist() == pytest.approx([0, 0.5, 0, 0.1])
    s = check.stats(ref, tok, gap=0.2)
    assert s["logit_gap_max"] == pytest.approx(0.5)
    assert s["logit_gap_mean"] == pytest.approx(0.6 / 4)
    assert s["token_miss_share"] == pytest.approx(2 / 4)
    assert s["gap_share"] == pytest.approx(1 / 4)
    assert check.stats(ref, tok, gap=0.5)["gap_share"] == 0.0
