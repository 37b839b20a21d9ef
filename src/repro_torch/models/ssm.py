"""Mamba-style selective SSM path used by the hymba hybrid heads
(PyTorch port of the reference ``models/ssm.py``).

Diagonal selective state space:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
    y_t = C_t . h_t + D * u_t
with input-dependent dt, B, C and state size N = cfg.ssm_state. The
sequence path goes through ``kernels.ssm_scan``: the CUDA kernel on CUDA
tensors, its plain loop over time on CPU tensors. Decode carries h
(B, d_inner, N). ``A_log``, ``D`` and ``dt_bias`` are float32 whatever
``cfg.dtype`` is, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import selective_scan as _scan
from repro_torch.models import layers


def init_ssm(gen, cfg, device, dtype=None, lead: tuple = ()):
    d, di, N = cfg.d_model, cfg.dinner, max(cfg.ssm_state, 1)
    dtype = dtype or cfg.dtype
    f32 = torch.float32

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype, device, lead)

    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=device))
    return {
        "w_in": dense(d, di),
        "w_gate": dense(d, di),
        "w_dt": dense(d, di),
        "w_bc": dense(d, 2 * N),
        "w_out": dense(di, d),
        "A_log": a_log.expand(lead + (di, N)).clone(),
        "D": torch.ones(lead + (di,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (di,), dtype=f32, device=device),
    }


def selective_scan(u, dt, Bm, Cm, A, D, state):
    """u,dt: (B,S,di) f32; Bm,Cm: (B,S,N) f32; A: (di,N); state:
    (B,di,N). Returns (y (B,S,di) f32, new_state)."""
    return _scan(u, dt, Bm, Cm, A, D, state)


def ssm_block(x, p, cfg, cache=None, plan=None):
    """x (B,S,d) -> (out (B,S,d), cache {"state": (B,di,N)}).

    Under ``plan``, when d_inner splits over its model axis, each rank
    computes its channels only: ``u``, the gate and ``dt`` from its
    columns of ``w_in`` / ``w_gate`` / ``w_dt``, B and C from its columns
    of ``w_bc`` gathered whole (every channel reads all of them), the
    scan on its channels, ``w_out`` row-parallel; the returned state is
    this rank's channels, or the whole state (gathered) for a cache whole
    on every rank. Otherwise the params are gathered whole."""
    Bsz = x.shape[0]
    di, N = cfg.dinner, max(cfg.ssm_state, 1)
    if plan is not None and not plan.divides(di):
        p, plan = plan.gather_tree(p), None
    n = di if plan is None else di // plan.axis_size(plan.model_axis)
    if cache is None:
        cache = {"state": torch.zeros((Bsz, n, N), dtype=torch.float32,
                                      device=x.device)}
    if plan is None:
        u = (x @ p["w_in"]).float()
        g = F.silu(x @ p["w_gate"])
        dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
        bc = (x @ p["w_bc"]).float()
        A = -torch.exp(p["A_log"])                        # (di,N), negative
        D = p["D"]
    else:
        m = plan.model_axis
        x = plan.psum_grad(x, m)                     # enter the body
        u = plan.col_block(x, p["w_in"]).float()
        g = F.silu(plan.col_block(x, p["w_gate"]))
        dt = F.softplus(plan.col_block(x, p["w_dt"]).float()
                        + plan.model_block(p["dt_bias"], 0))
        # every rank's channels read all of B and C
        bc = plan.col_whole(x, p["w_bc"]).float()
        A = -torch.exp(plan.model_block(p["A_log"], 0))
        D = plan.model_block(p["D"], 0)
    Bm, Cm = (t.contiguous() for t in torch.split(bc, N, dim=-1))
    if plan is None:
        y, state = selective_scan(u, dt, Bm, Cm, A, D, cache["state"])
        return (y.to(x.dtype) * g) @ p["w_out"], {"state": state}
    state, whole = plan.state_block(cache["state"], 1, n)
    y, state = selective_scan(u, dt, Bm, Cm, A, D, state)
    if whole:
        state = plan.all_gather(state, 1, plan.model_axis)
    out = plan.row_linear(y.to(x.dtype) * g, p["w_out"], local=True)
    return out, {"state": state}
