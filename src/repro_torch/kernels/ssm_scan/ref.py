"""Plain PyTorch version of the selective-scan kernel.

It is the counterpart of the reference's oracle ``ssm_scan_ref``: a
loop over time in float32. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

``ssm_scan_bwd_ref`` is the plain version of the backward kernel: the
gradient by its explicit reverse-time formulas, in float32, with no
autograd; ``ssm_scan_checkpoints_ref`` that of the states the training
forward writes for it. Only tests and ``chip_smoke.py`` use them.
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


def ssm_scan_checkpoints_ref(u, dt, Bm, A, state, every=8):
    """The states after steps every, 2 every, ... short of the last step
    (h_{every c} for c = 1 .. ceil(T / every) - 1), as the training
    forward writes them: (B, n, di, N) f32."""
    h = state.float()
    cks = []
    for t in range(u.shape[1] - 1):
        dt_t = dt[:, t]
        h = torch.exp(dt_t[..., None] * A) * h \
            + (dt_t * u[:, t])[..., None] * Bm[:, t, None, :]
        if (t + 1) % every == 0:
            cks.append(h)
    if not cks:
        return state.new_zeros((state.shape[0], 0, *state.shape[1:]),
                               dtype=torch.float32)
    return torch.stack(cks, dim=1)


def ssm_scan_bwd_ref(u, dt, Bm, Cm, A, D, state, dy, dstate_out):
    """The gradient of ``ssm_scan_ref`` at (u, dt, Bm, Cm, A, D, state)
    for the upstream gradients ``dy`` (B,T,di) and ``dstate_out``
    (B,di,N) of its two outputs. With a_t = exp(dt_t A), h_t the state
    after step t and dh_t its gradient (dh_T = C_T dy_T + dstate_out):
    ``dh_t = C_t dy_t + a_{t+1} dh_{t+1}``,
    ``dC_t = sum_d dy_t[d] h_t[d,:]``,
    ``dB_t = sum_d dh_t[d,:] dt_t[d] u_t[d]``,
    ``du_t = D dy_t + dt_t sum_n dh_t B_t``,
    ``ddt_t = sum_n dh_t (A a_t h_{t-1} + u_t B_t)``,
    ``dA = sum_{b,t} dh_t dt_t a_t h_{t-1}``, ``dD = sum_{b,t} dy_t u_t``
    and dstate = a_1 dh_1. The states h_{t-1} come from running the
    forward again (a_t underflows to 0, so they cannot be recovered by
    dividing). Returns (du, ddt, dB, dC, dA, dD, dstate), all f32."""
    u, dt, Bm, Cm, A, D, dy = (t.float() for t in (u, dt, Bm, Cm, A, D,
                                                      dy))
    h = state.float()
    prev = []
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)                  # (B, di, N)
        prev.append((h, a))
        h = a * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
    g_next = dstate_out.float().clone()     # a_{t+1} dh_{t+1}
    du, ddt = torch.zeros_like(u), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for t in reversed(range(u.shape[1])):
        hp, a = prev[t]
        u_t, dt_t, B_t, C_t, dy_t = (x[:, t] for x in (u, dt, Bm, Cm, dy))
        g = dy_t[..., None] * C_t[:, None, :] + g_next        # dh_t
        dC[:, t] = torch.einsum("bd,bdn->bn", dy_t, h)
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * u_t)
        du[:, t] = D * dy_t + dt_t * torch.einsum("bdn,bn->bd", g, B_t)
        ddt[:, t] = torch.sum(g * (A * a * hp + u_t[..., None]
                                   * B_t[:, None, :]), dim=-1)
        dA += torch.sum(g * dt_t[..., None] * a * hp, dim=0)
        dD += torch.sum(dy_t * u_t, dim=0)
        g_next = a * g
        h = hp
    return du, ddt, dB, dC, dA, dD, g_next
