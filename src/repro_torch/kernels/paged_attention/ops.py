"""Public ops for paged attention (block-table in-place reads).

One kernel serves every paged consumer: plain decode
(``paged_decode_attention``, the S = 1 case) and chunked-prefill /
verify windows (``paged_window_attention``). Tensors on the CPU take
the plain PyTorch version in ``ref.py``; CUDA tensors take the CUDA
kernel in ``kernel.py``, which raises on what it cannot run. There is no
fallback from one to the other. ``force_ref`` (tests and
``chip_smoke.py`` only) takes the plain version on any device.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    paged_window_attention_ref)

__all__ = ["paged_decode_attention", "paged_window_attention"]


def paged_window_attention(q, pool_k, pool_v, block_table, base_lens, *,
                           sliding_window: int = 0, force_ref: bool = False):
    """Fused multi-token window: q (B,S,Hq,hd) at absolute positions
    ``base_lens[b] + [0, S)`` (K/V already in the pool); base_lens (B,)
    int32 tokens resident per row before the window. Returns (out
    (B,S,Hq,hd), lse (B,S,Hq) f32)."""
    if force_ref or q.device.type == "cpu":
        return paged_window_attention_ref(q, pool_k, pool_v, block_table,
                                          base_lens,
                                          sliding_window=sliding_window)
    return kernel.paged_window_attention(q, pool_k, pool_v, block_table,
                                         base_lens,
                                         sliding_window=sliding_window)


def paged_decode_attention(q, pool_k, pool_v, block_table, lengths, *,
                           sliding_window: int = 0, force_ref: bool = False):
    """q (B,Hq,hd); lengths (B,) int32 valid tokens per row (the new
    token's K/V already in the pool). Returns (out (B,Hq,hd), lse (B,Hq)
    f32) — the window op at S = 1 with ``base = lengths - 1``."""
    out, lse = paged_window_attention(q[:, None], pool_k, pool_v,
                                      block_table, lengths.reshape(-1) - 1,
                                      sliding_window=sliding_window,
                                      force_ref=force_ref)
    return out[:, 0], lse[:, 0]
