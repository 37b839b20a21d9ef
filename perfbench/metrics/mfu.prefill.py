"""Model step: the model FLOPs of the tokens the traced slice delivered
(2 x the weights a token uses, its attention, the head where its logits
are needed; see ``perfbench/yardstick.py``), over the slice's
device-busy seconds at the H100's bf16 peak, in percent."""
from perfbench import slicework, yardstick


def read(run):
    s = run.slice
    if s is None or s.busy_s <= 0:
        return None
    flops = slicework.model_flops(run)
    if flops <= 0:
        return None
    return 100.0 * flops / (s.busy_s * yardstick.PEAK_FLOPS_BF16)
