"""Engine host work: the share of the positions the prefill calls
computed (rows x bucket width) that were padding, from the ``prefill-pad``
counter events the engine's ``Tracer`` records on its ``engine`` track
(pid 3), one a call, over the window before the profiled slice (the
whole window where no slice ran). In percent."""

ENGINE = 3


def read(run):
    s = run.slice
    t1 = s.t0 if s is not None and s.t0 is not None else run.t_close
    tokens = pad = 0
    for e in run.tracer_events:
        if e.get("ph") == "C" and e.get("pid") == ENGINE \
                and e["name"] == "prefill-pad" \
                and run.t_open <= e["ts"] / 1e6 < t1:
            tokens += e["args"]["tokens"]
            pad += e["args"]["pad"]
    return 100.0 * pad / tokens if tokens else None
