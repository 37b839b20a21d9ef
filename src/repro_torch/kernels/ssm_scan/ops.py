"""Public op for the selective (Mamba-style) SSM scan.

Tensors on the CPU take the plain PyTorch version in ``ref.py``
(autograd differentiates it); CUDA tensors take the CUDA kernel in
``kernel.py``, which raises on what it cannot run. When grad mode is on
and an input requires grad, the CUDA call goes through
``SelectiveScan``, an autograd function whose forward also writes the
state every 8 steps and whose backward, the CUDA kernel in
``backward.py``, walks back from those checkpoints; otherwise the
forward launches alone, as serving runs it, and writes nothing more.
There is no fallback from one to the other. Unlike the reference's TPU
route, no sequence-length or width gate applies: the kernel takes any
T >= 1 and any d_inner. ``force_ref`` (tests and ``chip_smoke.py``
only) takes the plain version on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import backward, kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["SelectiveScan", "selective_scan"]


class SelectiveScan(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op.
    The forward saves its checkpoints (B, ceil(T / 8) - 1, di, N) beside
    the inputs, so the backward runs no pass over all of T to recover the
    states; under ``torch.utils.checkpoint`` they are the recompute's.
    Autograd hands the backward zeros for an output the loss does not
    reach (the final state, in training), and a non-contiguous upstream
    gradient is made contiguous."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A, D, state):
        y, state_out, ck = kernel.ssm_scan(u, dt, Bm, Cm, A, D, state,
                                           checkpoints=True)
        ctx.save_for_backward(u, dt, Bm, Cm, A, D, state, ck)
        return y, state_out

    @staticmethod
    def backward(ctx, dy, dstate):
        u, dt, Bm, Cm, A, D, state, ck = ctx.saved_tensors
        return backward.ssm_scan_bwd(u, dt, Bm, Cm, A, D, state, ck,
                                     dy.contiguous(), dstate.contiguous())


def selective_scan(u, dt, Bm, Cm, A, D, state, *, force_ref: bool = False):
    """u/dt (B,T,di), Bm/Cm (B,T,N), A (di,N), D (di,), state (B,di,N),
    all f32. Returns (y (B,T,di), final state), both f32."""
    if force_ref or u.device.type == "cpu":
        return ssm_scan_ref(u, dt, Bm, Cm, A, D, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, Bm, Cm, A, D, state)):
        return SelectiveScan.apply(u, dt, Bm, Cm, A, D, state)
    return kernel.ssm_scan(u, dt, Bm, Cm, A, D, state)
