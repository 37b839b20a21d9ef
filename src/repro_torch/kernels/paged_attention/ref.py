"""Plain PyTorch version of the paged-window attention kernel.

It is the counterpart of the reference's independent oracle
``gathered_window_ref``: gather each row's blocks through its table,
then one-shot causal-in-window masked softmax attention in float32. The
CPU path of ``ops`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def paged_window_attention_ref(q, pool_k, pool_v, block_table, base_lens, *,
                               sliding_window: int = 0):
    """q (B,S,Hq,hd) — S window tokens per row at absolute positions
    ``base_lens[b] + [0, S)``, their K/V already in the pool; pool_k /
    pool_v (num_blocks, bs, Hkv, hd); block_table (B, max_blocks) int32;
    base_lens (B,) int32 tokens resident per row before the window.
    Window query w of row b attends to cache positions ``[0, base_lens[b]
    + w]`` (and, with a sliding window, not below ``base_lens[b] + w + 1
    - sliding_window``). Returns (out (B,S,Hq,hd) in q.dtype,
    lse (B,S,Hq) f32)."""
    B, S, Hq, hd = q.shape
    bs, Hkv = pool_k.shape[1], pool_k.shape[2]
    G = Hq // Hkv
    T = block_table.shape[1] * bs
    table = block_table.long()
    gk = pool_k[table].reshape(B, T, Hkv, hd).float()
    gv = pool_v[table].reshape(B, T, Hkv, hd).float()
    qg = q.reshape(B, S, Hkv, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkstg", qg, gk) / math.sqrt(hd)
    base = base_lens.reshape(-1).long()
    i = base[:, None] + torch.arange(S, device=q.device)[None, :]   # (B,S)
    j = torch.arange(T, device=q.device)
    valid = j[None, None, :] <= i[:, :, None]                       # (B,S,T)
    if sliding_window:
        valid &= j[None, None, :] > i[:, :, None] - sliding_window
    s = s.masked_fill(~valid[:, None, :, :, None], float("-inf"))   # (B,k,S,T,G)
    lse = torch.logsumexp(s, dim=3)                                 # (B,k,S,G)
    w = torch.exp(s - lse[:, :, :, None, :])
    o = torch.einsum("bkstg,btkd->bskgd", w, gv)
    out = o.reshape(B, S, Hq, hd).to(q.dtype)
    return out, lse.permute(0, 2, 1, 3).reshape(B, S, Hq)


def paged_decode_attention_ref(q, pool_k, pool_v, block_table, lengths, *,
                               sliding_window: int = 0):
    """Single-token decode: the window version at S = 1. q (B,Hq,hd);
    lengths (B,) valid tokens per row (the new token's K/V included).
    Returns (out (B,Hq,hd) in q.dtype, lse (B,Hq) f32)."""
    base = lengths.reshape(-1) - 1
    out, lse = paged_window_attention_ref(q[:, None], pool_k, pool_v,
                                          block_table, base,
                                          sliding_window=sliding_window)
    return out[:, 0], lse[:, 0]
