"""Device: the share of the traced slice's wall time in which no device
activity ran (kernels, copies, fills), from ``torch.profiler``, in
percent."""


def read(run):
    s = run.slice
    if s is None or not s.events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
