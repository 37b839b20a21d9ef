"""Hand-written Hopper kernels, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors) -> None:
    """Raise if autograd would record a call of ``op``, a CUDA kernel
    without a backward of its own: its output would carry no gradient to
    its inputs, so a loss through it would train nothing below it without
    an error. The paged-window and stripe-decode kernels serve only; the
    flash, WKV and selective-scan kernels train through the autograd
    functions of their ops, never by a direct kernel call. Serving runs
    under ``torch.no_grad()`` and never trips this."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: this CUDA kernel call has no backward, and an input "
            f"requires grad. The paged-window and stripe-decode kernels "
            f"serve only; the flash, WKV and selective-scan kernels train "
            f"through their ops (kernels/*/ops.py). Call it under "
            f"torch.no_grad(), or detach the inputs")


# (owner, device, stream) -> the scratch tensors of ``stream_scratch``
_SCRATCH: dict = {}


def stream_scratch(owner: str, device, stream, specs):
    """Scratch tensors of a kernel for its calls on one CUDA stream: one
    per (numel, dtype, zeroed) of ``specs``, cached per (owner, device,
    stream) and grown (all re-made) when a call needs more. A zeroed one
    holds counters that start at 0 and that the kernel leaves at 0; the
    calls of one stream run in order, so one allocation serves them all."""
    key = (owner, device, stream)
    have = _SCRATCH.get(key)
    if have is None or any(t.numel() < n for t, (n, _, _) in
                           zip(have, specs)):
        have = tuple(
            (torch.zeros if zeroed else torch.empty)(
                max(n, 1, 0 if have is None else have[i].numel()),
                dtype=dtype, device=device)
            for i, (n, dtype, zeroed) in enumerate(specs))
        _SCRATCH[key] = have
    return have
