"""Shared building blocks: norms, activations, rotary embeddings, inits,
the cross-entropy loss.

Params are nested dicts of tensors. Layer-stacked params carry a leading
L axis; the backbone loops over it. Norms and rope compute in float32
and cast back to the input dtype, at the same points as the JAX
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init utils
def dense_init(gen, d_in: int, d_out: int, dtype, device,
               lead: tuple = ()) -> torch.Tensor:
    """Normal(0, 1/d_in) weight ``lead + (d_in, d_out)``, drawn in float32
    from the explicit generator ``gen`` (None only on the meta device)."""
    w = torch.randn(lead + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


# ---------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


# ---------------------------------------------------------------- activations
GATED_ACTS = ("swiglu", "geglu")


def _relu2(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "swiglu" or name == "silu":
        return F.silu
    if name == "relu2":
        return _relu2
    if name in ("gelu", "geglu"):
        return _gelu_tanh
    raise ValueError(f"unknown activation {name}")


def mlp(x, p, act: str):
    """Gated (swiglu) or plain 2-matrix MLP. p: {w_in, w_out[, w_gate]}."""
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        h = act_fn(act)(x @ p["w_in"])
    return h @ p["w_out"]


def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype, device,
             lead: tuple = ()):
    p = {
        "w_in": dense_init(gen, d_model, d_ff, dtype, device, lead),
        "w_out": dense_init(gen, d_ff, d_model, dtype, device, lead),
    }
    if act in GATED_ACTS:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device, lead)
    return p


# ---------------------------------------------------------------- rotary
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    # the base is filled on the device: a host tensor copied there would
    # synchronise the stream in the middle of a step's launches
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(0.25, 0.375, 0.375)) -> torch.Tensor:
    """Multimodal RoPE [arXiv:2409.12191]: the rotary half-dims split
    into (temporal, height, width) sections of ``int(half * 0.25)``,
    ``int(half * 0.375)`` and the rest, each rotated by its own id.

    x: (B, S, H, hd); positions: (B, 3, S) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (half,)
    n_t = int(half * sections[0])
    n_h = int(half * sections[1])
    pos_t = positions.float().transpose(1, 2)                # (B, S, 3)
    B, S = pos_t.shape[:2]
    pos = torch.cat([pos_t[..., i:i + 1].expand(B, S, n)     # (B, S, half)
                     for i, n in enumerate((n_t, n_h, half - n_t - n_h))],
                    dim=-1)
    ang = pos[..., None, :] * freqs                          # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Whisper-style sinusoidal position embedding, computed on the fly:
    positions (...,) int -> (..., d). The frequencies divide by
    ``half - 1``, as the reference's do."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------- loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy in f32: logits (..., V), labels (...) int; with
    ``mask`` (...) the masked mean, divided by ``max(sum(mask), 1)``.

    The reference takes the gold logit as a dot with a one-hot row; a
    gather gives the same value without a second (..., V) f32 tensor."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
