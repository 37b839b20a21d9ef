"""Hand-written Hopper kernels, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors) -> None:
    """Raise if autograd would record a call of ``op``, a CUDA kernel
    without a backward: its output would carry no gradient to its inputs,
    so a loss through it would train nothing below it without an error.
    Serving runs under ``torch.no_grad()`` and never trips this."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no backward (ROADMAP Queue 1, item "
            f"3b lists the backward kernels still to port), and an input "
            f"requires grad; call it under torch.no_grad(), or detach the "
            f"inputs")
