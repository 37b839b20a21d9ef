"""Plain PyTorch versions of the flash-attention kernels.

``flash_attention_ref`` is the counterpart of the reference's oracle
``flash_attention_ref``: one-shot masked softmax attention in float32
with a ``-inf`` mask. The CPU path of ``ops`` runs it, and
``chip_smoke.py`` holds the CUDA forward against it on the card. As in
the reference oracle, a query row that sees no key (only possible when T
< S) comes out NaN; the kernel writes 0 there.

``flash_attention_bwd_ref`` is the plain version of the backward kernel:
the gradient by its explicit formulas, in float32, from the forward's
saved out and log-sum-exp. Only tests and ``chip_smoke.py`` use it.
"""
from __future__ import annotations

import math

import torch


def _mask(S, T, causal, sliding_window, device):
    """(S, T) bool: query i (at absolute position T - S + i) sees key j."""
    i = torch.arange(S, device=device)[:, None] + (T - S)
    j = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if sliding_window:
        mask &= j > i - sliding_window
    return mask


def _scores(q, k):
    """q (B,Hq,S,hd), k (B,Hkv,T,hd) -> scaled scores (B,Hkv,G,S,T) f32."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, hd).float()
    return torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(hd)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0, return_lse: bool = False):
    """q (B,Hq,S,hd); k/v (B,Hkv,T,hd) -> (B,Hq,S,hd) in q.dtype. Query i
    sits at absolute position ``T - S + i``; with ``causal`` it sees keys
    ``<= T - S + i``, with a sliding window only keys ``> T - S + i -
    sliding_window``. Softmax in f32. With ``return_lse`` also the rows'
    log-sum-exp (B,Hq,S) f32 (-inf where a row sees no key)."""
    B, Hq, S, hd = q.shape
    T = k.shape[2]
    s = _scores(q, k).masked_fill(
        ~_mask(S, T, causal, sliding_window, q.device), float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    out = o.reshape(B, Hq, S, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, Hq, S)
    return out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            sliding_window: int = 0):
    """The gradient of ``flash_attention_ref`` at (q, k, v) for the
    upstream gradient ``dout``, from the forward's ``out`` and ``lse``
    (B,Hq,S) f32: P = exp(s - lse), D = rowsum(dO * O), dS = P * (dO V^T
    - D), dq = dS K / sqrt(hd), dk = dS^T Q / sqrt(hd), dv = P^T dO, dk /
    dv summed over the G query heads of a KV head; all in f32, returned
    in q.dtype. A row that sees no key (lse = -inf) gets 0 and adds 0."""
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):
        return t.reshape(B, Hkv, G, S, hd).float()

    qg, og, dog = grouped(q), grouped(out), grouped(dout)
    kf, vf = k.float(), v.float()
    lse = lse.reshape(B, Hkv, G, S, 1)
    live = torch.isfinite(lse)
    seen = _mask(S, T, causal, sliding_window, q.device) & live
    p = torch.where(seen, torch.exp(_scores(q, k) - torch.where(live, lse,
                                                                0.0)), 0.0)
    d = torch.where(live, torch.sum(dog * og, dim=-1, keepdim=True), 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    ds = p * (dp - d)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    return (dq.reshape(B, Hq, S, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
