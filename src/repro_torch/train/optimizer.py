"""AdamW + global-norm clipping + warmup-cosine schedule, from scratch
(port of the reference's ``train/optimizer.py``).

State mirrors the params tree: mu and nu in f32 (DTensors with the
placements of DTensor params), and the step, an int32 scalar on the
params' device. Every scalar of the update (learning rate,
clip scale, bias corrections) stays on the device, so a step waits for
nothing on the host. ``torch.optim.AdamW`` is not used: it clips and
schedules elsewhere and applies eps and weight decay in another order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train import tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(c: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor): a
    linear warmup, then a cosine down to ``min_lr_ratio``; f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    prog = (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = c.min_lr_ratio + (1 - c.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def init_state(params) -> dict:
    """{"mu", "nu"}: f32 zeros shaped like ``params``; "step": 0."""
    leaves = tree.leaves(params)
    device = leaves[0].device if leaves else None
    zeros = (lambda p: torch.zeros_like(p, dtype=torch.float32))
    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


@torch.no_grad()
def apply_updates(params, grads, state, c: AdamWConfig):
    """One AdamW step. Returns (params, state, {"grad_norm", "lr"}).

    In place: each param leaf, mu and nu are overwritten and the same
    trees returned (the reference returns new arrays). The gradient is
    clipped to ``clip_norm`` by its global norm (reported before
    clipping); the update is computed in f32 and cast back to each
    param's dtype."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(c, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.full_like(stepf, c.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, c.b2), stepf)
    for p, g, mu, nu in zip(tree.leaves(params), tree.leaves(grads),
                            tree.leaves(state["mu"]),
                            tree.leaves(state["nu"])):
        g = g.float() * scale
        mu.copy_(c.b1 * mu + (1 - c.b1) * g)
        nu.copy_(c.b2 * nu + (1 - c.b2) * torch.square(g))
        u = (mu / b1c) / (torch.sqrt(nu / b2c) + c.eps)
        p32 = p.float()
        u = u + c.weight_decay * p32
        p.copy_(p32 - lr * u)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
