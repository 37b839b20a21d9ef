"""Engine host work: the mean ``launch`` sub-span of the plain decode
steps (the enqueue of the model's forward and the sampler, inside the
loop's ``dispatch``) that the engine's ``Tracer`` recorded on its
``engine`` track (pid 3), over the window before the profiled slice (the
whole window where no slice ran): the profiler slows the host inside
it. In ms."""

ENGINE = 3


def read(run):
    s = run.slice
    t1 = s.t0 if s is not None and s.t0 is not None else run.t_close
    xs = [e["dur"] / 1e3 for e in run.tracer_events
          if e.get("ph") == "X" and e.get("pid") == ENGINE
          and e["name"] == "launch" and e["args"].get("step") == "decode"
          and run.t_open <= e["ts"] / 1e6 < t1]
    return sum(xs) / len(xs) if xs else None
