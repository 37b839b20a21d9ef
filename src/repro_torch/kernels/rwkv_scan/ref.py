"""Plain PyTorch version of the WKV6 recurrence kernel.

It is the counterpart of the reference's oracle ``wkv_ref``: a loop
over time in float32. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, state):
    """r/k/v/w: (B, T, H, hd) f32 (w = per-step decay in (0, 1));
    u: (H, hd); state: (B, H, hd, hd). Per step and head:
    ``out_t = r_t @ (S + diag(u) k_t^T v_t)`` and
    ``S <- diag(w_t) S + k_t^T v_t``.
    Returns (out (B, T, H, hd) f32, final state (B, H, hd, hd) f32)."""
    S = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[:, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    if not outs:
        return torch.empty_like(r, dtype=torch.float32), S.clone()
    return torch.stack(outs, dim=1), S
