"""What the window did, counted by the harness from what the scheduler
returned, and the operations and bytes that work needs.

The scheduler (``run_continuous``) returns each request's greedy tokens
(``outputs``) and each admission's ``[rid, slot, steps before it]``. A
request admitted before decode step ``s0`` takes one token from each of
the steps ``s0 .. s0 + n - 1``; the first re-feeds its last prompt token
at position ``plen - 1``, so its ``j``-th step attends ``plen + j`` rows.

Operations are multiply-adds times two. A position of the trunk costs
twice the weights it runs through (the top-k experts, for sparse experts)
plus attention's ``4 * heads * head_dim * context`` a layer; the head
costs ``2 * vocab * d`` for each position whose logits are used. Prompts
count at their own length, never their bucket, so padding shows as lost
share, never as work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from pbench.model import Model


@dataclasses.dataclass
class Schedule:
    """Per request (in ``rids`` order): prompt length, decode steps before
    its admission, tokens emitted; per decode step: active rows and the
    rows they attend in all."""
    rids: np.ndarray
    plen: np.ndarray
    start: np.ndarray
    emitted: np.ndarray
    active: np.ndarray        # [steps]
    ctx_rows: np.ndarray      # [steps] sum over active requests of rows

    @property
    def steps(self) -> int:
        return int(self.active.shape[0])

    @property
    def tokens(self) -> int:
        return int(self.emitted.sum())


def schedule(prompt_lens: Dict[int, int], admissions: Sequence,
             outputs: Dict[int, List[int]]) -> Schedule:
    """The window's decode steps rebuilt from ``admissions`` and
    ``outputs``: steps = max over requests of (steps before + tokens)."""
    starts = {int(rid): int(s0) for rid, _slot, s0 in admissions}
    rids = np.array(sorted(starts), np.int64)
    plen = np.array([prompt_lens[r] for r in rids], np.int64)
    start = np.array([starts[r] for r in rids], np.int64)
    emitted = np.array([len(outputs.get(int(r), ())) for r in rids],
                       np.int64)
    n_steps = int((start + emitted).max()) if rids.size else 0
    active = np.zeros(n_steps, np.int64)
    ctx = np.zeros(n_steps, np.int64)
    for p, s0, n in zip(plen, start, emitted):
        active[s0:s0 + n] += 1
        ctx[s0:s0 + n] += p + np.arange(n)
    return Schedule(rids, plen, start, emitted, active, ctx)


# -- operations ---------------------------------------------------------------


def attn_flops(m: Model, rows) -> float:
    """Attention's scores and weighted sum over ``rows`` attended rows,
    every layer (``rows`` summed over the positions)."""
    return 4.0 * m.layers * m.heads * m.hd * np.sum(rows, dtype=np.float64)


def prompt_flops(m: Model, plen) -> float:
    """The prompt's positions ``0 .. plen - 2`` (the last is re-fed by
    the first decode step): trunk and causal attention, no head."""
    k = np.asarray(plen, np.float64) - 1
    return float(np.sum(2.0 * m.trunk_params() * k)
                 + attn_flops(m, k * (k + 1) / 2))


def decode_flops(m: Model, sched: Schedule) -> float:
    """Every decode position of the window: trunk, attention over its
    context and the head."""
    return float(sched.tokens * 2.0 * (m.trunk_params() + m.vocab * m.d)
                 + attn_flops(m, sched.ctx_rows))


def window_flops(m: Model, sched: Schedule) -> float:
    """The model's operations for the window's requests."""
    return prompt_flops(m, sched.plen) + decode_flops(m, sched)


# -- kernels' bounds ----------------------------------------------------------


def paged_decode_bound_s(m: Model, active: int, ctx_rows: int,
                         peak_flops: float, hbm_bw: float) -> float:
    """One decode step's paged attention over every layer: the live K/V
    rows read once, q read and the output written once a row."""
    kv = ctx_rows * 2 * m.kv_heads * m.hd * m.itemsize
    qo = active * 2 * m.heads * m.hd * m.itemsize
    flops = 4.0 * m.heads * m.hd * ctx_rows
    return m.layers * max((kv + qo) / hbm_bw, flops / peak_flops)


def prefill_attn_bound_s(m: Model, plen: int, peak_flops: float,
                         hbm_bw: float) -> float:
    """One prompt's causal flash attention at its own length, every
    layer: q, k, v read and the output written once."""
    flops = 4.0 * m.heads * m.hd * plen * (plen + 1) / 2
    io = plen * m.hd * (2 * m.heads + 2 * m.kv_heads) * m.itemsize
    return m.layers * max(flops / peak_flops, io / hbm_bw)


def weight_bytes(m: Model) -> int:
    """What one decode step reads of the weights: every layer (every
    expert held, as the layer's batched products read them), the head and
    the norms; the embedding table only at the looked-up rows (left
    out)."""
    norms = (2 * m.layers + 1) * m.d * 4 * (2 if m.norm == "layernorm"
                                            else 1)
    return (m.trunk_params(active=False) + m.vocab * m.d) * m.itemsize \
        + norms


def decode_step_bytes(m: Model, active: int, ctx_rows: int) -> int:
    """A decode step's bytes: the weights once, the live K/V read and the
    new token's K/V written."""
    return (weight_bytes(m) + ctx_rows * m.kv_bytes_per_token
            + active * m.kv_bytes_per_token)
