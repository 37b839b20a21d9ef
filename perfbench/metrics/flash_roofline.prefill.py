"""Kernels: the flash forward's share of its roofline in the traced slice:
the bound time of the prefills the slice needed, each at its prompt's own
length (so bucket padding is waste), over the device time of the flash
kernels the profiler recorded, in percent."""
from perfbench import slicework


def read(run):
    s = run.slice
    t = s.family_s("flash") if s is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * slicework.flash_bound_s(run) / t
