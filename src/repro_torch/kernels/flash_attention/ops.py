"""Public ops for blocked causal / sliding-window GQA attention.

Tensors on the CPU take the plain PyTorch version in ``ref.py``; CUDA
tensors take the CUDA kernel in ``kernel.py``, which raises on what it
cannot run. There is no fallback from one to the other. The reference's
``bq`` / ``bk`` are TPU tile sizes: they are dropped here, and no
multiple-of-tile gate applies (the kernel takes any S, T >= 1).
``force_ref`` (tests and ``chip_smoke.py`` only) takes the plain version
on any device.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["attention_bshd", "flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    force_ref: bool = False):
    """q (B,Hq,S,hd), k/v (B,Hkv,T,hd) -> (B,Hq,S,hd) in q.dtype; query i
    at absolute position ``T - S + i``."""
    if force_ref or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    return kernel.flash_attention(q, k, v, causal=causal,
                                  sliding_window=sliding_window)


def attention_bshd(q, k, v, **kw):
    """The same op on (B, S, H, hd) tensors: transposed views in and out,
    no copy on the kernel route."""
    def t(x):
        return x.transpose(1, 2)
    return t(flash_attention(t(q), t(k), t(v), **kw))
