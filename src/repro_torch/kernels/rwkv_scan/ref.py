"""Plain PyTorch version of the WKV6 recurrence kernel.

It is the counterpart of the reference's oracle ``wkv_ref``: a loop
over time in float32. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

``wkv_bwd_ref`` is the plain version of the backward kernel: the
gradient by its explicit reverse-time formulas, in float32, with no
autograd; ``wkv_checkpoints_ref`` that of the states the training
forward writes for it. Only tests and ``chip_smoke.py`` use them.
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


def wkv_checkpoints_ref(r, k, v, w, state, every=8):
    """The states after steps every, 2 every, ... short of the last step
    (S_{every c} for c = 1 .. ceil(T / every) - 1), as the training
    forward writes them: (B, H, n, hd, hd) f32, each transposed (S[i][j]
    at [..., j, i])."""
    S = state.float()
    cks = []
    for t in range(r.shape[1] - 1):
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
        if (t + 1) % every == 0:
            cks.append(S)
    B, _, H, hd = r.shape
    if not cks:
        return state.new_zeros((B, H, 0, hd, hd), dtype=torch.float32)
    return torch.stack(cks, dim=2).transpose(-1, -2).contiguous()


def wkv_bwd_ref(r, k, v, w, u, state, dout, dstate_out):
    """The gradient of ``wkv_ref`` at (r, k, v, w, u, state) for the
    upstream gradients ``dout`` (B,T,H,hd) and ``dstate_out`` (B,H,hd,hd)
    of its two outputs. Per (b, h), with S_t the state after step t
    (rows i the key dim, columns j the value dim) and dS_t the gradient
    of S_t (dS_T = dstate_out):
    ``dr_t[i] = sum_j dout_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])``,
    ``dk_t[i] = u[i] r_t[i] (dout_t . v_t) + sum_j dS_t[i,j] v_t[j]``,
    ``dv_t[j] = dout_t[j] sum_i r_t[i] u[i] k_t[i] + sum_i k_t[i]
    dS_t[i,j]``, ``dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]``,
    ``du[h,i] = sum_{b,t} r_t[i] k_t[i] (dout_t . v_t)`` and
    ``dS_{t-1} = diag(w_t) dS_t + r_t^T dout_t``; dstate = dS_0. The
    states S_{t-1} come from running the forward again (a decay may be
    exactly 0, so they cannot be recovered by dividing by w). Returns
    (dr, dk, dv, dw, du, dstate), all f32."""
    r, k, v, w, u, dout = (t.float() for t in (r, k, v, w, u, dout))
    S = state.float()
    prev = []
    for t in range(r.shape[1]):
        prev.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
    dS = dstate_out.float().clone()
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in reversed(range(r.shape[1])):
        r_t, k_t, v_t, w_t, do_t = (x[:, t] for x in (r, k, v, w, dout))
        dot = torch.sum(do_t * v_t, dim=-1, keepdim=True)       # (B,H,1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev[t], do_t) \
            + u * k_t * dot
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dS, v_t) + u * r_t * dot
        dv[:, t] = do_t * torch.sum(r_t * u * k_t, dim=-1, keepdim=True) \
            + torch.einsum("bhi,bhij->bhj", k_t, dS)
        dw[:, t] = torch.sum(dS * prev[t], dim=-1)
        du += torch.sum(r_t * k_t * dot, dim=0)
        dS = w_t[..., None] * dS + r_t[..., None] * do_t[..., None, :]
    return dr, dk, dv, dw, du, dS
