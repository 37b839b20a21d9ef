"""Plain PyTorch version of the flash-attention kernel.

It is the counterpart of the reference's oracle ``flash_attention_ref``:
one-shot masked softmax attention in float32 with a ``-inf`` mask. The
CPU path of ``ops`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card. As in the reference oracle, a query row
that sees no key (only possible when T < S) comes out NaN; the kernel
writes 0 there.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0):
    """q (B,Hq,S,hd); k/v (B,Hkv,T,hd) -> (B,Hq,S,hd) in q.dtype. Query i
    sits at absolute position ``T - S + i``; with ``causal`` it sees keys
    ``<= T - S + i``, with a sliding window only keys ``> T - S + i -
    sliding_window``. Softmax in f32."""
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)[:, None] + (T - S)
    j = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if sliding_window:
        mask &= j > i - sliding_window
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, Hq, S, hd).to(q.dtype)
