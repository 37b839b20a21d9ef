"""RWKV-6 "Finch" block [arXiv:2404.05892]: attention-free time-mix with
data-dependent decay + squared-ReLU channel-mix (PyTorch port of the
reference ``models/rwkv6.py``).

Recurrence per head (state S: hd x hd):
    out_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
with w_t = exp(-exp(w0 + lora(x_t))), data-dependent per channel.

The sequence path goes through ``kernels.rwkv_scan``: the CUDA kernel on
CUDA tensors, its plain loop over time on CPU tensors, at every sequence
length. Decode carries (S, last_x) as the cache. ``decay_base`` and
``bonus_u`` are float32 whatever ``cfg.dtype`` is, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv_scan.ops import wkv
from repro_torch.models import layers

LORA_RANK = 64


def init_time_mix(gen, cfg, device, dtype=None, lead: tuple = ()):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dtype = dtype or cfg.dtype
    r = min(LORA_RANK, d)

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype, device, lead)

    return {
        "mu": torch.full(lead + (5, d), 0.5, dtype=dtype, device=device),
        "w_r": dense(d, H * hd),
        "w_k": dense(d, H * hd),
        "w_v": dense(d, H * hd),
        "w_g": dense(d, H * hd),
        "w_o": dense(H * hd, d),
        "decay_lora_a": dense(d, r),
        "decay_lora_b": dense(r, H * hd),
        "decay_base": torch.full(lead + (H * hd,), -5.0, dtype=torch.float32,
                                 device=device),
        "bonus_u": torch.zeros(lead + (H, hd), dtype=torch.float32,
                               device=device),
        "ln_out": torch.ones(lead + (H * hd,), dtype=dtype, device=device),
    }


def init_channel_mix(gen, cfg, device, dtype=None, lead: tuple = ()):
    d = cfg.d_model
    dtype = dtype or cfg.dtype
    return {
        "mu": torch.full(lead + (2, d), 0.5, dtype=dtype, device=device),
        "w_r": layers.dense_init(gen, d, d, dtype, device, lead),
        "w_k": layers.dense_init(gen, d, cfg.d_ff, dtype, device, lead),
        "w_v": layers.dense_init(gen, cfg.d_ff, d, dtype, device, lead),
    }


def _shift(x, last_x):
    """x (B,S,d); last_x (B,d) value preceding x[:,0]. Returns x_{t-1}."""
    return torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)


def _decay(xw, p):
    """Data-dependent per-channel decay in (0,1). xw: (..., d)."""
    lora = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
    return torch.exp(-torch.exp(p["decay_base"] + lora.float()))


def _project(x, last_x, p, cfg):
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xx = _shift(x, last_x) - x
    mu = p["mu"]
    xr, xk, xv, xg, xw = (x + xx * mu[i] for i in range(5))
    r = (xr @ p["w_r"]).reshape(B, S, H, hd).float().contiguous()
    k = (xk @ p["w_k"]).reshape(B, S, H, hd).float().contiguous()
    v = (xv @ p["w_v"]).reshape(B, S, H, hd).float().contiguous()
    g = F.silu(xg @ p["w_g"])
    w = _decay(xw, p).reshape(B, S, H, hd)
    return r, k, v, g, w


def _project_local(x, last_x, p, cfg, plan):
    """:func:`_project` for this rank's heads (``plan``'s tensor-parallel
    body; ``x`` has entered it): ``r`` / ``k`` / ``g`` and the decay's
    LoRA output from this rank's columns of ``w_r`` / ``w_k`` / ``w_g`` /
    ``decay_lora_b``, ``v`` reduce-scattered from this rank's rows of
    ``w_v`` (its rows, d, are split over ``model``), the LoRA's (B, S,
    64) hidden state gathered whole. Also returns this rank's ``bonus_u``
    and ``ln_out``."""
    B, S, _ = x.shape
    hd = cfg.hd
    xx = _shift(x, last_x) - x
    # every use of mu below is this rank's: its gradient is partial
    mu = plan.gather(p["mu"], model_partial=True)
    xr, xk, xv, xg, xw = (x + xx * mu[i] for i in range(5))

    def heads(t):
        return t.reshape(B, S, -1, hd).float().contiguous()

    r = heads(plan.col_block(xr, p["w_r"]))
    k = heads(plan.col_block(xk, p["w_k"]))
    v = heads(plan.row_scatter(xv, p["w_v"]))
    g = F.silu(plan.col_block(xg, p["w_g"]))
    lora = plan.col_block(torch.tanh(plan.col_whole(xw, p["decay_lora_a"])),
                          p["decay_lora_b"])
    base = plan.model_block(p["decay_base"], 0)
    w = heads(torch.exp(-torch.exp(base + lora.float())))
    return (r, k, v, g, w, plan.model_block(p["bonus_u"], 0),
            plan.model_block(p["ln_out"], 0))


def _rmsnorm_heads(out, gamma, eps, plan):
    """``layers.rmsnorm`` over all H * hd columns of an output whose ranks
    hold a column block each: each rank's mean of squares, averaged over
    ``model`` (the blocks are of one width), times its block of the norm
    weight. With one rank on ``model`` it is ``layers.rmsnorm``."""
    dt = out.dtype
    x = out.float()
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    m = plan.model_axis
    # every rank's block reads the sum: its gradient is summed back
    ms = plan.psum_grad(plan.psum(ms, m), m) / plan.axis_size(m)
    x = x * torch.rsqrt(ms + eps)
    return (x * gamma.float()).to(dt)


def wkv_scan(r, k, v, w, u, state):
    """Sequential WKV recurrence. r/k/v/w: (B,S,H,hd) f32; u: (H,hd);
    state: (B,H,hd,hd). Returns (out (B,S,H,hd), new_state)."""
    return wkv(r, k, v, w, u, state)


def time_mix(x, p, cfg, cache=None, plan=None):
    """cache: {"state": (B,H,hd,hd) f32, "last_x": (B,d)} or None.

    Under ``plan``, when the heads split over its model axis, each rank
    computes its heads only (:func:`_project_local`), the WKV scan runs
    on them and ``w_o`` is row-parallel; the returned state is this
    rank's heads, or the whole state (gathered) for a cache whole on
    every rank. Otherwise the params are gathered whole."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    if plan is not None and not plan.divides(H):
        p, plan = plan.gather_tree(p), None
    n = H if plan is None else H // plan.axis_size(plan.model_axis)
    if cache is None:
        cache = {"state": torch.zeros((B, n, hd, hd), dtype=torch.float32,
                                      device=x.device),
                 "last_x": torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device)}
    if plan is None:
        r, k, v, g, w = _project(x, cache["last_x"], p, cfg)
        out, state = wkv_scan(r, k, v, w, p["bonus_u"], cache["state"])
        out = out.reshape(B, S, H * hd).to(x.dtype)
        out = layers.rmsnorm(out, p["ln_out"], cfg.norm_eps)
        out = (out * g) @ p["w_o"]
        return out, {"state": state, "last_x": x[:, -1, :]}
    x_in = plan.psum_grad(x, plan.model_axis)        # enter the body
    r, k, v, g, w, u, ln_out = _project_local(x_in, cache["last_x"], p, cfg,
                                              plan)
    state, whole = plan.state_block(cache["state"], 1, n)
    out, state = wkv_scan(r, k, v, w, u, state)
    if whole:
        state = plan.all_gather(state, 1, plan.model_axis)
    out = _rmsnorm_heads(out.reshape(B, S, n * hd).to(x.dtype), ln_out,
                         cfg.norm_eps, plan)
    out = plan.row_linear(out * g, p["w_o"], local=True)
    return out, {"state": state, "last_x": x[:, -1, :]}


def channel_mix(x, p, cfg, cache=None, plan=None):
    """Under ``plan``, when d and d_ff split over its model axis: the
    receptance from this rank's columns of ``w_r`` (d), ``w_k``
    column-parallel (this rank's d_ff columns), ``w_v`` row-parallel with
    its partial sums reduce-scattered to this rank's d columns, times the
    receptance there, the product gathered (a reduce-scatter and an
    all-gather of (B, S, d): fewer bytes than an all-reduce of the
    product and a gather of the receptance). Otherwise the params are
    gathered whole."""
    B, _, d = x.shape
    if plan is not None and not (plan.divides(d)
                                 and plan.divides(cfg.d_ff)):
        p, plan = plan.gather_tree(p), None
    if cache is None:
        cache = {"last_x": torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device)}
    new_cache = {"last_x": x[:, -1, :]}
    if plan is None:
        xx = _shift(x, cache["last_x"]) - x
        xr = x + xx * p["mu"][0]
        xk = x + xx * p["mu"][1]
        r = torch.sigmoid(xr @ p["w_r"])
        h = torch.square(F.relu(xk @ p["w_k"]))
        return r * (h @ p["w_v"]), new_cache
    m = plan.model_axis
    x = plan.psum_grad(x, m)                         # enter the body
    xx = _shift(x, cache["last_x"]) - x
    mu = plan.gather(p["mu"], model_partial=True)
    xr = x + xx * mu[0]
    xk = x + xx * mu[1]
    r = torch.sigmoid(plan.col_block(xr, p["w_r"]))
    h = torch.square(F.relu(plan.col_block(xk, p["w_k"])))
    kv = plan.scatter_along(h @ plan.model_block(p["w_v"], 0), -1, m)
    return plan.gather_along(r * kv, -1, m), new_cache
