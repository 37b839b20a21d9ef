"""Engine host work + model step: the mean wall time of a plain decode
step on the device's clock, the ``decode-step`` span on the ``device``
track (pid 4) of the engine's ``Tracer``: CUDA events from before the
step's first host-to-device copy to after its sampler, placed on the
tracer's clock. Not the device's busy time: the span holds every stretch
in which the device waits for the host to enqueue the step's next
kernel, so a host-bound step reads about its ``launch`` sub-span, and
cheaper launches move it as faster kernels do. Over the window before
the profiled slice (the whole window where no slice ran). In ms."""

DEVICE = 4


def read(run):
    s = run.slice
    t1 = s.t0 if s is not None and s.t0 is not None else run.t_close
    xs = [e["dur"] / 1e3 for e in run.tracer_events
          if e.get("ph") == "X" and e.get("pid") == DEVICE
          and e["name"] == "decode-step"
          and run.t_open <= e["ts"] / 1e6 < t1]
    return sum(xs) / len(xs) if xs else None
