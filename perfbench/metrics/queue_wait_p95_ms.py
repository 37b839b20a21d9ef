"""Serve loop and scheduler: the 95th percentile, over the requests due in
the window, of the wait from the due time to the program's own stamp of
the first slot admission (``Request.admitted_s``). A request never
admitted stands at the time the run gave up on it."""
from perfbench.endtoend import pct, window_requests


def read(run):
    win = window_requests(run.records, run.t_open, run.t_close)
    if not win:
        return None
    waits = []
    for r in win:
        req = r.request
        t = req.admitted_s if req is not None and req.admitted_s else None
        waits.append(((t if t is not None else run.gave_up) - r.due) * 1e3)
    return pct(waits, 0.95)
