"""Public op for the WKV6 recurrence.

Tensors on the CPU take the plain PyTorch version in ``ref.py``; CUDA
tensors take the CUDA kernel in ``kernel.py``, which raises on what it
cannot run. There is no fallback from one to the other. Unlike the
reference's TPU route, no sequence-length gate applies: the kernel takes
any T >= 1. ``force_ref`` (tests and ``chip_smoke.py`` only) takes the
plain version on any device.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv_scan import kernel
from repro_torch.kernels.rwkv_scan.ref import wkv_ref

__all__ = ["wkv"]


def wkv(r, k, v, w, u, state, *, force_ref: bool = False):
    """r/k/v/w (B,T,H,hd) f32, u (H,hd), state (B,H,hd,hd) f32. Returns
    (out (B,T,H,hd) f32, final state)."""
    if force_ref or r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u, state)
    return kernel.wkv_scan(r, k, v, w, u, state)
