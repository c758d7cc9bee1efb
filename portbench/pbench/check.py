"""Whether what the window served is right, against the plain reference.

After the window has closed and the program's state is freed, a sample
of the finished requests, drawn from the seed with the longest one always
in it, until it holds ``traffic["check"]["tokens"]`` served tokens, goes
through the reference's full forward pass: each prompt with its served
tokens. The numbers are read from the gap by which a served token's
logit lies below the reference's best at that position (greedy decoding:
a right token has gap 0, a token lost to rounding a small one); each
number the configuration's ``check.limits`` names is compared with its
limit. The control's tokens lose by more than the served type's rounding
does, so the number compared is the share of tokens whose gap passes a
threshold (``check.gap``) set between the two: a mean or a widest gap
moves with the few near-ties of a sample and does not part the program
from its control on every seed.

The control (``control``: a precision of ``reference.decoder``) puts in
the served tokens' place, at the same positions of the same prompts and
served tokens, the tokens the reference computed in that lower precision
puts first; a sound check finds it not correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import decoder


def sample(reqs, outputs: Dict[int, List[int]], tokens: int,
           seed: int) -> List[int]:
    """rids: the longest finished request (prompt and served tokens),
    then others in the seed's order until ``tokens`` served tokens."""
    done = [r for r in reqs if len(outputs.get(r.rid, ())) == r.max_new]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.max_new, -r.rid))
    picked, served = [longest.rid], longest.max_new
    rng = np.random.default_rng([int(seed) % (1 << 64), 0xC4EC])
    for i in rng.permutation(len(done)):
        if served >= tokens:
            break
        r = done[i]
        if r.rid != longest.rid:
            picked.append(r.rid)
            served += r.max_new
    return picked


def _inputs(reqs_by_rid, outputs, rids: Sequence[int], device):
    seqs, pos, served = [], [], []
    for rid in rids:
        r = reqs_by_rid[rid]
        out = np.asarray(outputs[rid], np.int64)
        ids = np.concatenate([r.prompt.astype(np.int64), out[:-1]])
        p = len(r.prompt)
        seqs.append(torch.as_tensor(ids, device=device))
        pos.append(torch.arange(p - 1, p - 1 + len(out), device=device))
        served.append(torch.as_tensor(out, device=device))
    return seqs, pos, served


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each of ``tokens``' logits lies below its row's best in
    ``ref``."""
    best = ref.max(dim=-1).values
    return best - ref.gather(1, tokens.long()[:, None])[:, 0]


def stats(ref: torch.Tensor, tokens: torch.Tensor,
          gap: float) -> Dict[str, float]:
    """The numbers a configuration may compare, of ``tokens`` judged
    against the reference's logits ``ref``: the widest gap, the mean gap,
    the share of tokens that are not the reference's best, and
    ``gap_share``, the share whose gap passes ``gap`` (the configuration's
    ``check.gap``): a token lost to the served type's rounding lies a
    little below the best, one lost to a coarser type further."""
    g = gaps(ref, tokens)
    return {"logit_gap_max": float(g.max()),
            "logit_gap_mean": float(g.mean()),
            "token_miss_share": float((g > 0).float().mean()),
            "gap_share": float((g > gap).float().mean())}


def detail(ref: torch.Tensor, tokens: torch.Tensor) -> Dict[str, np.ndarray]:
    """Per position: the reference's eight best logits and the logit of
    the token judged."""
    return {"top": ref.topk(8, dim=-1).values.cpu().numpy(),
            "logit": ref.gather(1, tokens.long()[:, None])[:, 0]
            .cpu().numpy()}


def judged(config: Dict, weights, reqs_by_rid, outputs, rids: Sequence[int],
           device, controls: Sequence[str] = ()):
    """The reference's logits at every sampled position (concatenated),
    and the tokens judged there: the served ones under ``"served"``, and
    under each of ``controls`` the tokens the reference in that precision
    puts first."""
    seqs, pos, tok = _inputs(reqs_by_rid, outputs, rids, device)
    ref = torch.cat(decoder.logits(config, weights, seqs, pos))
    tokens = {"served": torch.cat(tok)}
    for low in controls:
        tokens[low] = torch.cat([x.argmax(dim=-1) for x in decoder.logits(
            config, weights, seqs, pos, low=low)])
    return ref, tokens


def served(config: Dict, weights, reqs_by_rid, outputs,
           rids: Sequence[int], device,
           control: Optional[str] = None) -> Dict[str, float]:
    """:func:`stats` of the sampled requests' served tokens, or with
    ``control`` of the tokens that control puts first in their place."""
    ref, tokens = judged(config, weights, reqs_by_rid, outputs, rids,
                         device, (control,) if control else ())
    return stats(ref, tokens[control or "served"],
                 float(config["check"]["gap"]))
