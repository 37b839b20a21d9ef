"""Plain PyTorch version of the decode-attention kernel, and the merge
of sequence-shard partials.

The reference's oracle ``decode_attention_ref`` returns NaN / ``-inf``
for a row that sees no position, while its kernel writes out 0 and lse
``log(1e-30)``. The reference's sharded op runs the kernel, so an empty
shard merges harmlessly there. This version follows the kernel's
convention (``m_safe``, ``max(l, 1e-30)``) so that the port's sharded op
stays finite on the CPU as well; on every row that sees a position it
computes the oracle's function. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, n_valid, *, sliding_window: int = 0):
    """q (B,Hq,hd); k/v (B,Hkv,T,hd); n_valid: an int, a 0-d tensor or a
    (B,) tensor of valid cache positions per row. Row b attends to
    positions ``[max(0, n - window), min(n, T))`` with ``n =
    n_valid[b]``. Returns (out (B,Hq,hd) in q.dtype, lse (B,Hq) f32):
    lse is the log-sum-exp of the masked scores, what the sharded merge
    needs."""
    B, Hq, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = torch.as_tensor(n_valid, device=q.device).reshape(-1, 1).long()
    j = torch.arange(T, device=q.device)[None, :]
    valid = (j < n).expand(B, T)                               # (B, T)
    if sliding_window:
        valid = valid & (j >= n - sliding_window)
    valid = valid[:, None, None, :]
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) / math.sqrt(hd)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float()) / l
    lse = (m_safe + torch.log(l))[..., 0]
    return o.reshape(B, Hq, hd).to(q.dtype), lse.reshape(B, Hq)


def merge_partials(outs, lses):
    """Merge per-shard partials with the closed-form LSE combine: outs
    a list of (B,Hq,hd), lses of (B,Hq) f32. Returns (B,Hq,hd) in the
    partials' dtype."""
    lse = torch.stack(lses)                                    # (n, B, Hq)
    m = lse.amax(dim=0)
    w = torch.exp(lse - m[None])
    num = sum(w[i][..., None] * outs[i].float() for i in range(len(outs)))
    den = w.sum(dim=0)[..., None]
    return (num / den).to(outs[0].dtype)
