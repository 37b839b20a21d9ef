"""Model step: the mean device time of a prefill call, the
``prefill-call`` span on the ``device`` track (pid 4) of the engine's
``Tracer``: CUDA events from before the call's first host-to-device copy
to after its KV insertion into the pool, placed on the tracer's clock:
the device's time between the two events, its kernels and any wait for
the host between them. Over the window before the profiled slice (the
whole window where no slice ran). In ms."""

DEVICE = 4


def read(run):
    s = run.slice
    t1 = s.t0 if s is not None and s.t0 is not None else run.t_close
    xs = [e["dur"] / 1e3 for e in run.tracer_events
          if e.get("ph") == "X" and e.get("pid") == DEVICE
          and e["name"] == "prefill-call"
          and run.t_open <= e["ts"] / 1e6 < t1]
    return sum(xs) / len(xs) if xs else None
