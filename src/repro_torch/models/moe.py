"""Mixture-of-Experts FFN with capacity-based top-k dispatch (PyTorch port
of the reference ``models/moe.py``, its one-device path).

The dispatch is sort-free: each (token, choice) pair's slot in its
expert comes from a one-hot prefix count (cumsum + scatter), in the
order of the pairs, so the pairs a full expert drops are the
reference's. The expert products are plain batched GEMMs (``bmm``), as
the reference leaves them to XLA outside any Pallas kernel.

The sharded branches (expert-parallel / expert-tensor-parallel
``shard_map`` bodies and the weight-stationary ``moe_decode_ffn``) are
the sharding slice of ROADMAP.md: ``moe_ffn`` with a plan raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(gen, cfg, device, lead: tuple = ()):
    """``router`` (d, E) in f32, and per-expert ``w_in`` / ``w_gate``
    (E, d, f) and ``w_out`` (E, f, d) in ``cfg.dtype``, each with a
    leading ``lead`` (the stacked layers)."""
    d, E, f, dtype = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.dtype
    p = {
        "router": layers.dense_init(gen, d, E, torch.float32, device, lead),
        "w_in": layers.dense_init(gen, d, f, dtype, device, lead + (E,)),
        "w_out": layers.dense_init(gen, f, d, dtype, device, lead + (E,)),
    }
    if cfg.act in layers.GATED_ACTS:
        p["w_gate"] = layers.dense_init(gen, d, f, dtype, device, lead + (E,))
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Static per-expert slot count for a block of ``n_tokens``."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / max(cfg.n_experts, 1))
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(x2d, router, cfg):
    """Returns (weights (T, k) f32, ids (T, k) int64, aux_loss scalar).

    The router product is in f32 (on the card TF32 must be off, as it is
    by default for matmuls). The top-k keeps ``jax.lax.top_k``'s order:
    descending, the lower expert index first on a tie (a stable sort;
    ``torch.topk`` promises no tie order)."""
    logits = x2d.float() @ router                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss
    me = probs.mean(0)                                         # (E,)
    ce = F.one_hot(ids[:, 0], cfg.n_experts).float().mean(0)
    aux = cfg.n_experts * torch.sum(me * ce)
    zloss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return w, ids, cfg.router_aux_weight * aux + 1e-3 * zloss


def dispatch_tables(ids, w, e0: int, E_loc: int, C: int):
    """Slot assignment for experts [e0, e0 + E_loc).

    Returns (token_idx (E_loc, C) int64 in [0, T], T = the pad row,
    gate_w (E_loc, C) f32). Pair p = (token p // k, choice p % k) takes
    slot ``pos`` = the number of earlier pairs routed to its expert, and
    is dropped when ``pos >= C``."""
    T, k = ids.shape
    P = T * k
    pair_e = ids.reshape(P)
    pair_t = torch.arange(T, device=ids.device).repeat_interleave(k)
    pair_w = w.reshape(P).float()
    le = pair_e - e0
    in_range = (le >= 0) & (le < E_loc)
    le = torch.where(in_range, le, E_loc)                      # E_loc = dump
    onehot = F.one_hot(le, E_loc + 1)                          # (P, E_loc+1)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = in_range & (pos < C)
    row = torch.where(keep, le, E_loc)
    col = torch.where(keep, pos, 0)
    # every dropped or out-of-range pair writes the dump row's slot 0:
    # which of them wins is unspecified (on CUDA as in XLA), and harmless,
    # because the dump row is sliced off; kept pairs have distinct slots
    tok = torch.full((E_loc + 1, C), T, dtype=torch.int64, device=ids.device)
    tok.index_put_((row, col), torch.where(keep, pair_t, T))
    gw = torch.zeros((E_loc + 1, C), dtype=torch.float32, device=ids.device)
    gw.index_put_((row, col), torch.where(keep, pair_w, 0.0))
    return tok[:E_loc], gw[:E_loc]


def expert_compute(g, p_experts, cfg):
    """g: (E_loc, C, d) -> (E_loc, C, d) through each expert's FFN (the
    reference's ``einsum "ecd,edf->ecf"``: one batched GEMM per matrix)."""
    w_in, w_out = p_experts["w_in"], p_experts["w_out"]
    if "w_gate" in p_experts:
        h = layers.act_fn(cfg.act)(torch.bmm(g, p_experts["w_gate"])) * \
            torch.bmm(g, w_in)
    else:
        h = layers.act_fn(cfg.act)(torch.bmm(g, w_in))
    return torch.bmm(h, w_out)


def combine(y, tok, ids, T: int, e0: int, E_loc: int):
    """out (T, d) with out[t] the sum of the outputs ``y`` (E_loc, C, d)
    of the slots ``tok`` (E_loc, C) that hold token t: the reference's
    ``zeros.at[tok].add(y)`` without atomics. A token's k choices go to k
    distinct experts; their outputs are added in expert order (the order
    of the reference's scatter on the CPU) as a fixed left fold, so the
    bits do not change from run to run (an ``index_add_`` on CUDA adds in
    the order its atomics land: with top-8 that changes the result)."""
    C, d = tok.shape[1], y.shape[-1]
    slot = torch.full((T + 1, E_loc), E_loc * C, dtype=torch.int64,
                      device=y.device)
    flat = torch.arange(E_loc * C, device=y.device).reshape(E_loc, C)
    experts = torch.arange(E_loc, device=y.device)[:, None].expand(E_loc, C)
    slot.index_put_((tok, experts), flat)      # the pad row T is sliced off
    # each token's k experts ascending; a dropped or out-of-range choice
    # points at the zero row E_loc * C
    eids = torch.sort(ids - e0, dim=-1).values
    ok = (eids >= 0) & (eids < E_loc)
    src = torch.where(ok, slot[:T].gather(1, torch.clamp(eids, 0, E_loc - 1)),
                      E_loc * C)
    yp = torch.cat([y.reshape(E_loc * C, d), y.new_zeros((1, d))])
    out = yp[src[:, 0]]
    for j in range(1, src.shape[1]):
        out = out + yp[src[:, j]]
    return out


def moe_ffn_local(x2d, p, cfg, *, e0: int = 0, E_loc: int | None = None):
    """Contribution of experts [e0, e0 + E_loc) for tokens x2d (T, d).
    Returns (out (T, d) — partial if E_loc < n_experts, aux_loss)."""
    T, d = x2d.shape
    E_loc = cfg.n_experts if E_loc is None else E_loc
    C = capacity(T, cfg)
    w, ids, aux = route(x2d, p["router"], cfg)
    tok, gw = dispatch_tables(ids, w, e0, E_loc, C)
    xp = torch.cat([x2d, x2d.new_zeros((1, d))])
    g = xp[tok]                                                # (E_loc, C, d)
    pe = {k_: v for k_, v in p.items() if k_ != "router"}
    if E_loc < cfg.n_experts:
        pe = {k_: v[e0:e0 + E_loc] for k_, v in pe.items()}
    y = expert_compute(g, pe, cfg)
    y = y * gw[..., None].to(y.dtype)
    return combine(y, tok, ids, T, e0, E_loc).to(x2d.dtype), aux


def moe_ffn(x, p, cfg, plan=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss). One device only."""
    if plan is not None:
        raise NotImplementedError("sharded MoE (expert / tensor parallel, "
                                  "moe_decode_ffn): the 'sharding' slice of "
                                  "ROADMAP.md")
    B, S, d = x.shape
    out, aux = moe_ffn_local(x.reshape(B * S, d), p, cfg)
    return out.reshape(B, S, d), aux
