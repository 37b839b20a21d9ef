"""Mixture-of-Experts FFN with capacity-based top-k dispatch (PyTorch port
of the reference ``models/moe.py``).

The dispatch is sort-free: each (token, choice) pair's slot in its
expert comes from a one-hot prefix count (cumsum + scatter), in the
order of the pairs, so the pairs a full expert drops are the
reference's. The expert products are plain batched GEMMs (``bmm``), as
the reference leaves them to XLA outside any Pallas kernel.

Two distributed modes (picked by divisibility against the mesh ``model``
axis — see ``repro_torch.sharding.rules``), each a local body over a
rank's blocks (the reference's ``shard_map`` bodies):

* **EP** (expert-parallel, kimi-k2): each model rank owns the experts
  ``[i E_loc, (i+1) E_loc)``, dispatches its local tokens to them, and
  the partial outputs are all-reduced over ``model``.
* **TP** (expert-tensor-parallel, grok-1): every model rank holds all
  experts but a ``d_ff / model`` slice; the expert contraction is
  partial over d_ff and all-reduced.

Capacity comes from the body's local token count, so which pairs a full
expert drops follows the reference's sharded semantics. At decode a
plan takes :func:`moe_decode_ffn`, the weight-stationary body.
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
    if E_loc < cfg.n_experts and \
            all(v.shape[0] == cfg.n_experts for v in pe.values()):
        # a sub-range of whole expert weights: slice the block (a local
        # body hands the block over already sliced)
        pe = {k_: v[e0:e0 + E_loc] for k_, v in pe.items()}
    y = expert_compute(g, pe, cfg)
    y = y * gw[..., None].to(y.dtype)
    return combine(y, tok, ids, T, e0, E_loc).to(x2d.dtype), aux


def _rows(x, plan, B: int):
    """(the body's plan, this rank's rows of x, the batch axes they are
    split over, whether the body sliced them): a local body's ``P(b_ax,
    None, None)`` block. Activations already split over ``plan.rows`` are
    that block; activations whole on every rank are narrowed to it (their
    gradient summed back over those axes), and the body's plan counts
    the axes among its rows."""
    if plan.rows:
        return plan, x, plan.rows, False
    b_ax = plan._div(B, plan.batch_axes)
    axes = (b_ax,) if isinstance(b_ax, str) else tuple(b_ax or ())
    if not axes:
        return plan, x, (), False
    body = plan.bind(axes)
    return body, body.local_block(body.psum_grad(x, axes), (b_ax,)), axes, \
        True


def moe_decode_ffn(x, p, cfg, plan):
    """Weight-stationary MoE decode (§Perf, kimi-k2 x decode_32k).

    At decode the token batch is ~MBs while the expert weights are ~GBs
    per layer, so gathering the FSDP-sharded expert rows moves 5 orders
    of magnitude more bytes than the tokens. Instead: keep the 2-D weight
    layout resident (EP: (E/model, d/fsdp, f); TP: (E, d/fsdp, f/model)),
    all-gather the TOKENS over the batch axes, contract partially, and
    all-reduce the partial token outputs — over fsdp for the
    d-contraction, over model for the expert (EP) or f (TP) partials.
    """
    B, S, d = x.shape
    maxis = plan.model_axis
    fsdp = tuple(a for a in (plan.weight_fsdp if isinstance(
        plan.weight_fsdp, tuple) else (plan.weight_fsdp,)) if a)
    n_model = plan.axis_size(maxis)
    n_fsdp = plan.axis_size(fsdp) if fsdp else 1
    ep = plan.moe_mode == "ep"
    E_loc = cfg.n_experts // n_model if ep else cfg.n_experts
    d_loc = d // n_fsdp
    f_ax = fsdp or None
    if ep:      # weight specs mirroring rules.param_spec's moe branch
        wspec = {"router": (None,), "w_in": (maxis, f_ax, None),
                 "w_gate": (maxis, f_ax, None), "w_out": (maxis, None, f_ax)}
    else:
        wspec = {"router": (None,), "w_in": (None, f_ax, maxis),
                 "w_gate": (None, f_ax, maxis), "w_out": (None, maxis, f_ax)}
    pb = {k_: plan.local_block(v, wspec[k_], model_partial=True)
          for k_, v in p.items()}
    # ---- gather all tokens (tiny at decode) to every rank: x holds this
    # rank's rows, or every row already
    b_axes = plan.rows
    xg = plan.all_gather(x, 0, b_axes) if b_axes else x
    T = xg.shape[0] * xg.shape[1]
    x2d = xg.reshape(T, d)
    w, ids, aux = route(x2d, pb["router"], cfg)       # replicated compute
    e0 = plan.coord(maxis) * E_loc if ep else 0
    C = capacity(T, cfg)
    tok, gw = dispatch_tables(ids, w, e0, E_loc, C)
    xp = torch.cat([x2d, x2d.new_zeros((1, d))])
    g = xp[tok]                                       # (E_loc, C, d)
    # ---- partial contraction over this rank's d rows
    i_f = plan.flat_index(fsdp) if fsdp else 0
    g_loc = g[..., i_f * d_loc:(i_f + 1) * d_loc]
    h = torch.bmm(g_loc, pb["w_in"])
    if "w_gate" in pb:
        hg = torch.bmm(g_loc, pb["w_gate"])
        if fsdp:
            h = plan.all_reduce(h, fsdp)
            hg = plan.all_reduce(hg, fsdp)
        h = layers.act_fn(cfg.act)(hg) * h
    else:
        if fsdp:
            h = plan.all_reduce(h, fsdp)
        h = layers.act_fn(cfg.act)(h)
    y = torch.bmm(h, pb["w_out"])                     # (E_loc, C, d_loc)
    y = y * gw[..., None].to(y.dtype)
    out = combine(y, tok, ids, T, e0, E_loc)          # (T, d_loc)
    # EP: expert partials; TP: f partials — both close over model
    out = plan.all_reduce(out, maxis)
    if fsdp:                                          # reassemble d
        out = plan.all_gather(out, 1, fsdp)
    out = out.reshape(xg.shape[0], S, d).to(x.dtype)
    if b_axes:                                        # back to my rows
        i_b = plan.flat_index(b_axes)
        out = out[i_b * B:(i_b + 1) * B]
    aux = plan.pmean(aux, b_axes + (maxis,))
    return out, aux


def moe_ffn(x, p, cfg, plan=None):
    """x: (B, S, d). plan: ``repro_torch.sharding.rules.ParallelPlan`` or
    None. Returns (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    if plan is None or plan.mesh is None or not plan.moe_mode:
        out, aux = moe_ffn_local(x.reshape(B * S, d), p, cfg)
        return out.reshape(B, S, d), aux
    if plan.kind == "decode":
        return moe_decode_ffn(x, p, cfg, plan)

    maxis = plan.model_axis
    plan, xb, b_axes, sliced = _rows(x, plan, B)
    Bb, Sb, _ = xb.shape
    if plan.moe_mode == "ep":
        E_loc = cfg.n_experts // plan.axis_size(maxis)
        e0 = plan.coord(maxis) * E_loc
        wspec = {k_: (None,) if k_ == "router" else (maxis, None, None)
                 for k_ in p}
    else:   # tp: all experts, d_ff sliced over the model axis
        E_loc, e0 = cfg.n_experts, 0
        wspec = {k_: (None,) if k_ == "router" else (None, None, maxis)
                 for k_ in p}
        wspec["w_out"] = (None, maxis, None)
    pb = {k_: plan.local_block(v, wspec[k_], model_partial=True)
          for k_, v in p.items()}
    xin = plan.psum_grad(xb.reshape(Bb * Sb, d), maxis)
    out, aux = moe_ffn_local(xin, pb, cfg, e0=e0, E_loc=E_loc)
    out = plan.psum(out, maxis).reshape(Bb, Sb, d)
    aux = plan.pmean(aux, b_axes + (maxis,))
    if sliced:
        out = plan.gather_along(out, 0, b_axes)
    return out, aux
