"""Public op for the selective (Mamba-style) SSM scan.

Tensors on the CPU take the plain PyTorch version in ``ref.py``; CUDA
tensors take the CUDA kernel in ``kernel.py``, which raises on what it
cannot run. There is no fallback from one to the other. Unlike the
reference's TPU route, no sequence-length or width gate applies: the
kernel takes any T >= 1 and any d_inner. ``force_ref`` (tests and
``chip_smoke.py`` only) takes the plain version on any device.
"""
from __future__ import annotations

from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["selective_scan"]


def selective_scan(u, dt, Bm, Cm, A, D, state, *, force_ref: bool = False):
    """u/dt (B,T,di), Bm/Cm (B,T,N), A (di,N), D (di,), state (B,di,N),
    all f32. Returns (y (B,T,di), final state), both f32."""
    if force_ref or u.device.type == "cpu":
        return ssm_scan_ref(u, dt, Bm, Cm, A, D, state)
    return kernel.ssm_scan(u, dt, Bm, Cm, A, D, state)
