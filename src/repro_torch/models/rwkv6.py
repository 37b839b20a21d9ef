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


def wkv_scan(r, k, v, w, u, state):
    """Sequential WKV recurrence. r/k/v/w: (B,S,H,hd) f32; u: (H,hd);
    state: (B,H,hd,hd). Returns (out (B,S,H,hd), new_state)."""
    return wkv(r, k, v, w, u, state)


def time_mix(x, p, cfg, cache=None, plan=None, heads=None):
    """cache: {"state": (B,H,hd,hd) f32, "last_x": (B,d)} or None.

    ``heads`` (axes, h0, n): the state holds this rank's heads [h0, h0 +
    n) of a cache head-sharded over ``axes``; the WKV scan runs on them
    and ``plan`` gathers the heads' outputs back."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    if cache is None:
        cache = {"state": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                      device=x.device),
                 "last_x": torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device)}
    r, k, v, g, w = _project(x, cache["last_x"], p, cfg)
    u = p["bonus_u"]
    if heads is not None:
        axes, h0, n = heads
        r, k, v, w = (t[:, :, h0:h0 + n].contiguous() for t in (r, k, v, w))
        u = u[h0:h0 + n]
    out, state = wkv_scan(r, k, v, w, u, cache["state"])
    if heads is not None:
        out = plan.all_gather(out, 2, axes)
    out = out.reshape(B, S, H * hd).to(x.dtype)
    out = layers.rmsnorm(out, p["ln_out"], cfg.norm_eps)
    out = (out * g) @ p["w_o"]
    return out, {"state": state, "last_x": x[:, -1, :]}


def channel_mix(x, p, cfg, cache=None):
    B, _, d = x.shape
    if cache is None:
        cache = {"last_x": torch.zeros((B, d), dtype=x.dtype,
                                       device=x.device)}
    xx = _shift(x, cache["last_x"]) - x
    xr = x + xx * p["mu"][0]
    xk = x + xx * p["mu"][1]
    r = torch.sigmoid(xr @ p["w_r"])
    h = torch.square(F.relu(xk @ p["w_k"]))
    return r * (h @ p["w_v"]), {"last_x": x[:, -1, :]}
