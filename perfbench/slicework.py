"""The work a traced slice needed, from the requests' own lengths: the
tokens delivered in the slice's ticks, their model FLOPs, and the bound
times of the attention kernels that computed them. Padding, capacity
slots and empty rows are not needed work, so they count as waste.

A token delivered in a tick was computed in it: a request's first token
by its prefill, in the tick that admitted it; token j > 0 by the decode
step of that tick, fed at a row holding P + j - 1 tokens.
"""
from __future__ import annotations

from perfbench import yardstick as ys


def tokens(run):
    """(tick, prompt length, token index) of every token the slice's
    ticks delivered."""
    s = run.slice
    out = []
    for r in run.records:
        P = len(r.spec.prompt)
        for j, t in enumerate(r.ticks):
            if s.tick0 <= t < s.tick1:
                out.append((t, P, j))
    return out


def model_flops(run) -> float:
    """Model FLOPs of the slice's tokens."""
    c = run.c
    return sum(ys.prefill_flops(c, P) if j == 0
               else ys.decode_flops(c, P + j - 1)
               for _, P, j in tokens(run))


def _by_tick(items):
    out: dict = {}
    for t, *rest in items:
        out.setdefault(t, []).append(rest)
    return out


def flash_bound_s(run) -> float:
    """Bound time of the flash launches the slice needed: each prompt's
    causal attention at its own length, every layer; a tick's prefills
    taken together (no call can beat the bound of all of them)."""
    c = run.c
    tot = 0.0
    for rows in _by_tick((t, P) for t, P, j in tokens(run)
                         if j == 0).values():
        fl = by = 0.0
        for (P,) in rows:
            f, b = ys.flash(1, c["n_heads"], c["n_kv_heads"], P, P,
                            c["head_dim"])
            fl, by = fl + f, by + b
        tot += c["n_layers"] * ys.bound_s(fl, by)
    return tot


def paged_bound_s(run) -> float:
    """Bound time of the paged-window launches of the slice's decode
    steps: one call a layer a step over the rows that delivered a token,
    at their real context lengths."""
    c, e = run.c, run.engine
    bs = int(e["block_size"])
    max_blocks = -(-int(e["max_seq"]) // bs)
    tot = 0.0
    for rows in _by_tick((t, P + j - 1) for t, P, j in tokens(run)
                         if j > 0).values():
        f, b = ys.paged_window([base for (base,) in rows], 1, c["n_heads"],
                               c["n_kv_heads"], c["head_dim"], bs,
                               max_blocks)
        tot += c["n_layers"] * ys.bound_s(f, b)
    return tot
