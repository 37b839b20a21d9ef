"""The end-to-end metrics, from the records of one run (host clock), and
the latencies the per-layer readers take tails of.

Latencies run from when a request was due (open loop) or sent (closed
loop). A request that failed, or had not ended when the run gave up on
it, stands at the time it had waited by then, at least: tails count it
as missing, never as fast. Each tail is taken over every sample of the
window.
"""
from __future__ import annotations

import math
import statistics


def pct(xs, q: float) -> float:
    """Nearest-rank percentile: the smallest sample with at least a share
    ``q`` of the samples at or below it."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("no samples")
    return xs[max(1, min(math.ceil(q * len(xs)), len(xs))) - 1]


def window_requests(records, t_open: float, t_close: float) -> list:
    """Requests due inside the window."""
    return [r for r in records if t_open <= r.due < t_close]


def first_token_s(r, gave_up: float) -> float:
    """Due to the first token (a request that never delivered one: due
    to ``gave_up``)."""
    return (r.times[0] if r.times and r.error is None else gave_up) - r.due


def answer_s(r, gave_up: float) -> float:
    """Due to the last token of a finished request, else to ``gave_up``."""
    return (r.done if r.finished else gave_up) - r.due


def gaps(records, t_open: float, t_close: float) -> list:
    """Every gap between two consecutive tokens of a request, the later
    token delivered inside the window."""
    out = []
    for r in records:
        t = r.times
        out.extend(t[i] - t[i - 1] for i in range(1, len(t))
                   if t_open <= t[i] < t_close)
    return out


def tokens_in(records, t_open: float, t_close: float) -> int:
    return sum(1 for r in records for t in r.times if t_open <= t < t_close)


def compute(names, records, t_open, t_close, gave_up, setup_s):
    """{name: (value, unit)} of the asked end-to-end metrics, and the
    lines of medians and sample counts printed beside them."""
    win = window_requests(records, t_open, t_close)
    seconds = t_close - t_open
    out, notes = {}, []
    for name in names:
        if name == "setup_s":
            out[name] = (setup_s, "s")
        elif name == "itl_p95_ms":
            # no gap ended inside the window: every stream stalled through
            # it, so a gap lasted the window at least
            xs = [g * 1e3 for g in gaps(records, t_open, t_close)] \
                or [seconds * 1e3]
            out[name] = (pct(xs, 0.95), "ms")
            notes.append(f"itl_ms p50 {statistics.median(xs)} n {len(xs)}")
        elif name == "output_tok_s":
            n = tokens_in(records, t_open, t_close)
            out[name] = (n / seconds, "tokens/s")
            notes.append(f"output tokens in window {n} over {seconds} s")
        else:
            raise KeyError(f"no end-to-end metric named {name!r}")
    for tag, f in (("first_token_ms", first_token_s), ("answer_ms", answer_s)):
        xs = [f(r, gave_up) * 1e3 for r in win]
        if xs:
            notes.append(f"{tag} p50 {pct(xs, 0.5)} p95 {pct(xs, 0.95)} "
                         f"n {len(xs)}")
    return out, notes


def counts(records, loop: str, t_open: float, t_close: float):
    """(attempted, failed): the requests due in the window (open loop) or
    ended inside it (closed loop), and those of them that failed or never
    ended."""
    if loop == "open":
        win = window_requests(records, t_open, t_close)
        return len(win), sum(1 for r in win if not r.finished)
    ended = [r for r in records
             if r.done is not None and t_open <= r.done < t_close]
    return len(ended), sum(1 for r in ended if r.error is not None)
