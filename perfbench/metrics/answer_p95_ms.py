"""Serve loop and scheduler, as the user of a host-paced cell sees it: the
95th percentile, over the requests due in the window, of the time from
the due time to the last token of the answer (host clock; a request that
never got there stands at the time the run gave up on it). An end-to-end
tail that spreads too far from run to run to hold a bound."""
from perfbench.endtoend import answer_s, pct, window_requests


def read(run):
    win = window_requests(run.records, run.t_open, run.t_close)
    if not win:
        return None
    return pct([answer_s(r, run.gave_up) * 1e3 for r in win], 0.95)
