"""Public op for the WKV6 recurrence.

Tensors on the CPU take the plain PyTorch version in ``ref.py``
(autograd differentiates it); CUDA tensors take the CUDA kernel in
``kernel.py``, which raises on what it cannot run. When grad mode is on
and an input requires grad, the CUDA call goes through ``WKV``, an
autograd function whose forward also writes the state every 8 steps and
whose backward, the CUDA kernel in ``backward.py``, walks back from
those checkpoints; otherwise the forward launches alone, as serving runs
it, and writes nothing more. There is no fallback from one to the other.
Unlike the reference's TPU route, no sequence-length gate applies: the
kernel takes any T >= 1. ``force_ref`` (tests and ``chip_smoke.py``
only) takes the plain version on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv_scan import backward, kernel
from repro_torch.kernels.rwkv_scan.ref import wkv_ref

__all__ = ["WKV", "wkv"]


class WKV(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op.
    The forward saves its checkpoints (B, H, ceil(T / 8) - 1, hd, hd)
    beside the inputs, so the backward runs no pass over all of T to
    recover the states; under ``torch.utils.checkpoint`` they are the
    recompute's. Autograd hands the backward zeros for an output the loss
    does not reach (the final state, in training), and a non-contiguous
    upstream gradient is made contiguous."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, state_out, ck = kernel.wkv_scan(r, k, v, w, u, state,
                                             checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, state, ck)
        return out, state_out

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state, ck = ctx.saved_tensors
        return backward.wkv_bwd(r, k, v, w, u, state, ck, dout.contiguous(),
                                dstate.contiguous())


def wkv(r, k, v, w, u, state, *, force_ref: bool = False):
    """r/k/v/w (B,T,H,hd) f32, u (H,hd), state (B,H,hd,hd) f32. Returns
    (out (B,T,H,hd) f32, final state)."""
    if force_ref or r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV.apply(r, k, v, w, u, state)
    return kernel.wkv_scan(r, k, v, w, u, state)
