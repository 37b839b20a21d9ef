"""Engine host work: the mean of the ``dispatch`` spans that
``AsyncServeLoop.run_once`` records in the engine's ``Tracer`` (filling
the batch's host arrays and launching the step), over the window."""


def read(run):
    xs = [e["dur"] / 1e3 for e in run.tracer_events
          if e.get("ph") == "X" and e["name"] == "dispatch"
          and run.t_open <= e["ts"] / 1e6 < run.t_close]
    return sum(xs) / len(xs) if xs else None
