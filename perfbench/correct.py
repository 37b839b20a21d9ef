"""What decides ``correct``: the served tokens of a sample of the requests
the window finished, held against the plain reference run once over each
prompt with its served tokens.

Two numbers are compared: ``served_gap_max``, the widest gap by which a
served (greedy) token's logit lies below the reference's best logit at
its position, and ``served_disagree_share``, the share of served tokens
that are not the reference's first choice at their position. The
control, read only when the limits are set, puts the reference computed
in fp8 in the program's place and reads the same numbers for the tokens
that it puts first (see ``calibrate.py``).

In a MoE model a token whose k-th and (k+1)-th router logits lie within
rounding of each other may go to another expert in bf16 than in f32, and
its position's logits then differ by the whole expert's output however
right the program is. Such positions are left out by a rule on the
reference's own router: a position is compared only where, in every
layer, the reference's k-th router logit exceeds its (k+1)-th by at least
the cell's ``router_margin`` (``checks/<cell>.json``). How many were left
out is reported beside the number; the disagreeing share counts every
position.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import decoder

# the numbers compared, each against its limit in ``checks/<cell>.json``
COMPARED = ("served_gap_max", "served_disagree_share")
# the router margins at which calibration reads both gaps
TAUS = (0.0, 0.003, 0.01, 0.03, 0.1, 0.3)


def sample(records, seed: int, served_tokens: int, min_requests: int = 2):
    """Finished requests drawn from the seed, the longest (prompt and
    output) always among them, until they hold ``served_tokens``."""
    fin = [r for r in records if r.finished and r.tokens]
    if not fin:
        return []
    longest = max(fin, key=lambda r: len(r.spec.prompt) + len(r.tokens))
    rest = [r for r in fin if r is not longest]
    order = np.random.default_rng([int(seed) % (1 << 63), 7]) \
        .permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= served_tokens and len(out) >= min_requests:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def _gaps(ref, toks):
    """ref (n, V) logits, toks (n,): best logit minus each token's."""
    return ref.max(-1).values - ref.gather(1, toks[:, None])[:, 0]


def readings(weights, c: dict, recs, control: bool = False,
             router_margin: float = 0.0) -> dict:
    """The gaps of the served tokens (and, with ``control``, of the fp8
    reference's first tokens) against the f32 reference, at the positions
    whose router margin is at least ``router_margin``; with ``control``
    also at each margin of ``TAUS``."""
    seqs = [list(r.spec.prompt) + r.tokens[:-1] for r in recs]
    want = [list(range(len(r.spec.prompt) - 1, len(s)))
            for r, s in zip(recs, seqs)]
    margins: list = []
    ref = decoder.logits(weights, c, seqs, want, "f32", margins)
    dev = ref[0].device if ref else "cpu"
    served = [torch.as_tensor(r.tokens, device=dev) for r in recs]
    g = torch.cat([_gaps(x, t) for x, t in zip(ref, served)]) if ref \
        else torch.zeros(0)
    if margins:
        m = torch.cat([mm[torch.as_tensor(w, device=dev)]
                       for mm, w in zip(margins, want)])
    else:
        m = torch.full_like(g, float("inf"))

    def widest(x, tau):
        keep = x[m >= tau]
        return float(keep.max()) if keep.numel() else float("nan")

    out = {"served_gap_max": widest(g, router_margin),
           "served_disagree_share": float((g > 0).float().mean())
           if g.numel() else float("nan"),
           "served_tokens": int(g.numel()), "requests": len(recs),
           "left_out": int((m < router_margin).sum()),
           "served_gap_all": widest(g, 0.0)}
    if control:
        low = decoder.logits(weights, c, seqs, want, "fp8")
        gc = torch.cat([_gaps(x, y.argmax(-1)) for x, y in zip(ref, low)])
        out["control_gap_max"] = widest(gc, router_margin)
        out["control_disagree_share"] = float((gc > 0).float().mean())
        # calibration's view of the whole distribution, every position
        for tag, x in (("served", g), ("control", gc)):
            q = torch.quantile(x.float().cpu(), torch.tensor([0.5, 0.9, 0.99]))
            out[f"{tag}_gap_q50_q90_q99"] = [float(v) for v in q]
        if margins:
            out["by_margin"] = {str(t): [widest(g, t), widest(gc, t),
                                         int((m < t).sum())] for t in TAUS}
    return out
