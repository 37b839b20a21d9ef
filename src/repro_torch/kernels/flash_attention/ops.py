"""Public ops for blocked causal / sliding-window GQA attention.

Tensors on the CPU take the plain PyTorch version in ``ref.py``
(autograd differentiates it); CUDA tensors take the CUDA kernel in
``kernel.py``, which raises on what it cannot run. When grad mode is on
and q, k or v requires grad, the CUDA call goes through
``FlashAttention``, an autograd function whose forward also saves the
rows' log-sum-exp and whose backward is the CUDA kernel in
``backward.py``; otherwise the forward launches alone, as serving runs
it. There is no fallback from one to the other. Meta tensors take the
kernel's route (``kernels.kernel_route``), where its op gives the
outputs' shapes. The reference's ``bq`` / ``bk`` are TPU tile sizes:
they are dropped here, and no multiple-of-tile gate applies (the kernel
takes any S, T >= 1). ``force_ref`` (tests and ``chip_smoke.py`` only)
takes the plain version on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kernel_route
from repro_torch.kernels.flash_attention import backward, kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["FlashAttention", "attention_bshd", "flash_attention"]


class FlashAttention(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op;
    ``causal`` and ``sliding_window`` are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: int):
        out, lse = kernel.flash_attention(q, k, v, causal=causal,
                                          sliding_window=sliding_window,
                                          with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = backward.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal,
            sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    force_ref: bool = False):
    """q (B,Hq,S,hd), k/v (B,Hkv,T,hd) -> (B,Hq,S,hd) in q.dtype; query i
    at absolute position ``T - S + i``."""
    if force_ref or not kernel_route(q):
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal),
                                    int(sliding_window))
    return kernel.flash_attention(q, k, v, causal=causal,
                                  sliding_window=sliding_window)


def attention_bshd(q, k, v, **kw):
    """The same op on (B, S, H, hd) tensors: transposed views in and out,
    no copy on the kernel route."""
    def t(x):
        return x.transpose(1, 2)
    return t(flash_attention(t(q), t(k), t(v), **kw))
