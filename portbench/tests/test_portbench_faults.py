"""The output check catches a broken timed path: a run past the look for
a chip, with a fault planted in the program underneath, comes out not
correct; and the float8 control fails the limit a sound run keeps.

Faults a served cell can have: a decode step that leaves its state (the
paged K/V pool) unchanged; half of the batch left out (the second half of
the rows' tokens taken from the first half's); a token altered where it
is produced. The exchange between chips does not exist on one chip."""

import pytest
import torch

from conftest import run_cell


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "scatter_token",
                        lambda pool, *a, **k: pool)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    real = steps._greedy

    def greedy(logits):
        tok = real(logits)
        half = tok.shape[0] // 2
        return torch.cat([tok[:half], tok[:tok.shape[0] - half]])
    monkeypatch.setattr(steps, "_greedy", greedy)


def _token_altered(monkeypatch):
    """Each row's token of one decode step, the window's sixth (set-up
    and the scheduler's own warm-up make the first two calls)."""
    from repro_torch.launch import steps
    real = steps._greedy
    calls = []

    def greedy(logits):
        tok = real(logits)
        calls.append(1)
        if len(calls) == 8:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(steps, "_greedy", greedy)


@pytest.mark.parametrize("cell", ["sc-tiny", "gk-tiny"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    out, lines = run_cell(tiny_root, cell)
    assert out["correct"] is False
    share = out["checks"]["gap_share"]
    assert share["value"] > share["limit"]


@pytest.mark.parametrize("cell", ["sc-tiny", "gk-tiny"])
def test_the_float8_control_fails_the_limit(tiny_root, cell):
    """The control at test widths, on three seeds: the served tokens
    keep the limits, the tokens the float8 reference puts first do not;
    and through the harness's own comparison (``--control``) the run
    comes out not correct."""
    import run as bench

    import control
    from pbench import cell as cell_lib
    c = cell_lib.load(tiny_root, cell)
    limits = c.config["check"]["limits"]
    server, n = bench.prepare(c, 1, 5.0, torch.device("cpu"))
    for seed in (1, 2, 3):
        r = control.readings(c, server, n, seed, torch.device("cpu"))
        assert all(r["served"][k] <= lim for k, lim in limits.items())
        assert any(r["fp8"][k] > lim for k, lim in limits.items())
    for seed in (4, 5, 6):
        out, _ = run_cell(tiny_root, cell, seed=seed, control="fp8")
        assert out["correct"] is False
