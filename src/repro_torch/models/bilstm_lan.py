"""Bi-LSTM with hierarchically-refined Label Attention Network (LAN) —
the paper's NER model family [Cui & Zhang, arXiv:1908.08676] (§3.2.3;
port of the reference's ``models/bilstm_lan.py``).

Each layer: BiLSTM over the token sequence, then multi-head attention
where the *label embeddings* are keys/values; the label-aware summary is
concatenated to the BiLSTM output ("hierarchical refinement"). The LAST
layer's head-averaged attention scores are the prediction — no
CRF/softmax layer.

The recurrence is a ``lax.scan`` in the reference, outside any Pallas
kernel, so it stays plain torch: a Python loop over the sequence, with
the reference's gate layout (i, f, g, o) and forget bias. ``torch.nn.LSTM``
is not used: its gate layout and bias handling differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models import layers


@dataclass(frozen=True)
class LANConfig:
    vocab_size: int = 4096
    n_labels: int = 9
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    dtype: torch.dtype = torch.float32


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(0.02).to(dtype)


# ------------------------------------------------------------------- LSTM
def init_lstm(gen, d_in: int, d_h: int, dtype, device):
    return {
        "w": layers.dense_init(gen, d_in, 4 * d_h, dtype, device),
        "u": layers.dense_init(gen, d_h, 4 * d_h, dtype, device),
        "b": torch.zeros((4 * d_h,), dtype=dtype, device=device),
    }


def lstm_scan(p, x, reverse: bool = False):
    """x (B, S, d_in) -> h (B, S, d_h).

    ``x @ w`` for every step is one product before the loop; a step then
    adds ``h @ u`` and ``b`` in the reference's order."""
    B, S, _ = x.shape
    d_h = p["u"].shape[0]
    xw = x @ p["w"]                                     # (B, S, 4 d_h)
    h = torch.zeros((B, d_h), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = [None] * S
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        z = torch.addmm(xw[:, t], h, p["u"]) + p["b"]
        i, f, g, o = torch.split(z, d_h, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1)


def bilstm(p, x):
    fwd = lstm_scan(p["fwd"], x)
    bwd = lstm_scan(p["bwd"], x, reverse=True)
    return torch.cat([fwd, bwd], dim=-1)               # (B, S, 2*d_h)


# ------------------------------------------------------------------- LAN
def label_attention(h, label_emb, p, n_heads: int):
    """h (B,S,d), label_emb (L,d) -> (attn_out (B,S,d), scores (B,S,L))."""
    B, S, d = h.shape
    L = label_emb.shape[0]
    hd = d // n_heads
    q = (h @ p["w_q"]).reshape(B, S, n_heads, hd)
    k = (label_emb @ p["w_k"]).reshape(L, n_heads, hd)
    v = (label_emb @ p["w_v"]).reshape(L, n_heads, hd)
    scores = torch.einsum("bshd,lhd->bshl", q, k) / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bshl,lhd->bshd", w, v).reshape(B, S, d)
    return out, torch.mean(scores, dim=2)              # head-avg (B,S,L)


def init_lan_layer(gen, d_in: int, d_model: int, dtype, device):
    d_h = d_model // 2
    return {
        "fwd": init_lstm(gen, d_in, d_h, dtype, device),
        "bwd": init_lstm(gen, d_in, d_h, dtype, device),
        "w_q": layers.dense_init(gen, d_model, d_model, dtype, device),
        "w_k": layers.dense_init(gen, d_model, d_model, dtype, device),
        "w_v": layers.dense_init(gen, d_model, d_model, dtype, device),
    }


def init_params(gen, cfg: LANConfig, device):
    """Random params drawn from ``gen`` (None only on the meta device)."""
    lans = []
    d_in = cfg.d_model
    for _ in range(cfg.n_layers):
        lans.append(init_lan_layer(gen, d_in, cfg.d_model, cfg.dtype, device))
        d_in = 2 * cfg.d_model      # [h ; label-attn] concat feeds next layer
    return {
        "embed": _normal(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype,
                         device),
        "label_embed": _normal(gen, (cfg.n_labels, cfg.d_model), cfg.dtype,
                               device),
        "lan_layers": lans,
    }


def forward(params, cfg: LANConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) -> per-token label logits (B,S,n_labels): the last
    layer's head-averaged, pre-softmax label-attention scores."""
    x = params["embed"][tokens.long()]
    scores = None
    for lp in params["lan_layers"]:
        h = bilstm(lp, x)                              # (B,S,d_model)
        attn, scores = label_attention(h, params["label_embed"], lp,
                                       cfg.n_heads)
        x = torch.cat([h, attn], dim=-1)
    return scores


def loss(params, cfg: LANConfig, tokens, labels, mask=None):
    """Token cross-entropy of the last layer's label scores: labels (B,S)
    label ids, ``mask`` (B,S) weights (padding 0)."""
    return layers.softmax_xent(forward(params, cfg, tokens), labels, mask)


def predict(params, cfg: LANConfig, tokens):
    return torch.argmax(forward(params, cfg, tokens), dim=-1)
