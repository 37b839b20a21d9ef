"""Plain PyTorch version of the selective-scan kernel.

It is the counterpart of the reference's oracle ``ssm_scan_ref``: a
loop over time in float32. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(u, dt, Bm, Cm, A, D, state):
    """u/dt: (B, T, di) f32; Bm/Cm: (B, T, N) f32; A: (di, N); D: (di,);
    state: (B, di, N). Per step: ``h = exp(dt A) h + dt u B`` and
    ``y = C . h + D u``. Returns (y (B, T, di) f32, final state)."""
    h = state.float()
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t = u[:, t], dt[:, t]                         # (B, di)
        dA = torch.exp(dt_t[..., None] * A)                   # (B, di, N)
        h = dA * h + (dt_t * u_t)[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]) + D * u_t)
    if not ys:
        return torch.empty_like(u, dtype=torch.float32), h.clone()
    return torch.stack(ys, dim=1), h
