"""What decides ``correct``: the served tokens against the reference.

Once the window has closed, a sample of the requests the run finished is
drawn from the seed: the longest of them, then one request of every slot
that finished one, then more until it holds ``sample_tokens`` served
tokens.  So a fault confined to some slots shows wherever they finished
a request, however many tokens the longest request holds.  The reference runs once over each
prompt with its served tokens, and at each served token reads the gap by
which that token's logit lies below the reference's best, as a share of
the row's largest |logit|.  The widest gap over the sample is compared
with the cell's limit.  Greedy serving makes the served token the
program's argmax, so a gap is 0 where the two agree and stays within the
program's rounding at a near-tie; a token altered, a cache row lost or a
step computed at a lower precision shows as a wider gap.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(requests, slot_of: dict, seed: int, tokens: int):
    """Finished requests (state completed): the longest (prompt plus
    served tokens), then for each slot, in a seeded order, a seeded one of
    the requests it finished, then the rest in a seeded order until
    ``tokens`` served tokens are held.  ``slot_of`` maps a request id to
    the slot it was admitted to."""
    done = sorted((r for r in requests if r.state.value == "completed"),
                  key=lambda r: r.rid)
    if not done:
        return []
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), 5]))
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))
    by_slot = {}
    for r in done:
        by_slot.setdefault(slot_of[r.rid], []).append(r)
    out = [longest]
    for s in rng.permutation(sorted(by_slot)):
        if slot_of[longest.rid] != s:
            out.append(by_slot[s][rng.integers(len(by_slot[s]))])
    n = sum(len(r.tokens) for r in out)
    taken = {r.rid for r in out}
    rest = [r for r in done if r.rid not in taken]
    for i in rng.permutation(len(rest)):
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def sequences(reqs):
    """Each request's prompt and served tokens but the last, and the
    positions whose logits chose its served tokens."""
    seqs, pos, served = [], [], []
    for r in reqs:
        toks = np.asarray(r.tokens, np.int64)
        p = np.asarray(r.prompt, np.int64)
        seqs.append(torch.from_numpy(np.concatenate([p, toks[:-1]])))
        pos.append(list(range(p.size - 1, p.size - 1 + toks.size)))
        served.append(torch.from_numpy(toks))
    return seqs, pos, served


def widest_gap(logits, chosen) -> float:
    """The largest (best - logit of the chosen token) / max |logit| over
    every row of every request."""
    worst = 0.0
    for lg, tok in zip(logits, chosen):
        tok = tok.to(lg.device).long()
        gap = (lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]) \
            / lg.abs().max(-1).values
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(ref_logits, control_logits) -> float:
    """`widest_gap` of the tokens a control puts first, judged by the
    reference's logits at the same positions."""
    return widest_gap(ref_logits, [c.argmax(-1) for c in control_logits])
