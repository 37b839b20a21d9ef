"""Kernels: the paged-window kernel's share of its roofline in the traced
slice: the bound time of the decode steps' reads at each row's real
context length, over the device time of the paged-window kernels (split,
merge and tensor-core launches) the profiler recorded, in percent."""
from perfbench import slicework


def read(run):
    s = run.slice
    t = s.family_s("paged") if s is not None else 0.0
    if t <= 0:
        return None
    return 100.0 * slicework.paged_bound_s(run) / t
