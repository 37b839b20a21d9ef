"""Model step: the MoE FFN's device time in a decode step: the
``moe-ffn`` spans (one a MoE layer, CUDA events around the layer's FFN)
that the engine's ``Tracer`` recorded inside its plain decode steps,
summed over each step's layers, and the mean over the steps of the
window before the profiled slice (the whole window where no slice ran).
A span is the device's time between its two events: the FFN's kernels,
and any wait for the host between them. In ms."""

DEVICE = 4


def read(run):
    s = run.slice
    t1 = s.t0 if s is not None and s.t0 is not None else run.t_close
    steps: dict = {}
    for e in run.tracer_events:
        if e.get("ph") == "X" and e.get("pid") == DEVICE \
                and e["name"] == "moe-ffn" \
                and e["args"].get("step") == "decode-step" \
                and run.t_open <= e["ts"] / 1e6 < t1:
            tick = e["args"]["tick"]
            steps[tick] = steps.get(tick, 0.0) + e["dur"] / 1e3
    return sum(steps.values()) / len(steps) if steps else None
