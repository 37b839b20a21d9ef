"""Public ops for single-token GQA decode attention, and the
sequence-sharded (flash-decoding) variant.

Tensors on the CPU take the plain PyTorch version in ``ref.py``; CUDA
tensors take the CUDA kernel in ``kernel.py``, which raises on what it
cannot run. There is no fallback from one to the other. The reference's
``bk`` is a TPU tile size: it is dropped here, and no multiple-of-tile
gate applies. ``force_ref`` (tests and ``chip_smoke.py`` only) takes the
plain version on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      merge_partials)

__all__ = ["decode_attention", "sharded_decode_attention"]


def decode_attention(q, k, v, n_valid, *, sliding_window: int = 0,
                     force_ref: bool = False):
    """q (B,Hq,hd), k/v (B,Hkv,T,hd); n_valid an int, a 0-d tensor or a
    (B,) tensor of valid positions per row (the reference takes one for
    the batch). Returns (out (B,Hq,hd) in q.dtype, lse (B,Hq) f32)."""
    if force_ref or q.device.type == "cpu":
        return decode_attention_ref(q, k, v, n_valid,
                                    sliding_window=sliding_window)
    n = torch.as_tensor(n_valid, device=q.device)
    n = n.to(torch.int32).reshape(-1).expand(q.shape[0]).contiguous()
    return kernel.decode_attention(q, k, v, n, sliding_window=sliding_window)


def sharded_decode_attention(q, k_shards, v_shards, n_valid, **kw):
    """Flash-decoding over a sequence-sharded KV cache: the op per shard
    (a host loop stands in for the per-device program) on its local
    valid count ``clamp(n_valid - offset, 0, t)``, then the closed-form
    LSE merge. Returns out (B,Hq,hd)."""
    n = torch.as_tensor(n_valid, device=q.device)
    outs, lses = [], []
    offset = 0
    for ks, vs in zip(k_shards, v_shards):
        t = ks.shape[2]
        o, l = decode_attention(q, ks, vs, torch.clamp(n - offset, 0, t),
                                **kw)
        outs.append(o)
        lses.append(l)
        offset += t
    return merge_partials(outs, lses)
