"""GQA attention: causal (optionally sliding-window) attention for
prefill, and single-token / multi-token-window decode against the paged
KV block pool or the fixed per-slot stripe cache; cross-attention to
precomputed encoder K / V (whisper's decoder), unmasked.

On CUDA tensors the hot paths take the hand-written CUDA kernels (on
meta tensors their ops: ``kernels.kernel_route``), the
sites where the reference means its Pallas kernels to run on a TPU: prefill
attention goes through ``kernels.flash_attention`` and the stripe decode
read through ``kernels.decode_attention`` (the stripe read in place,
with one valid length per row). On CPU tensors both stay plain torch
(einsum + masked softmax), as the reference leaves them to XLA. Stripe
chunk windows (``verify_decode_attention``) stay plain torch on every
device: their per-row bases fit neither reference kernel. The paged read
goes through the gather path (``use_kernel=False``) or through
``kernels.paged_attention`` (``use_kernel=True``): the CUDA kernel on
CUDA tensors, its plain version on CPU tensors.

Under a ``ParallelPlan`` (``repro_torch.sharding.rules``) a cache's
layout is its placement. A plain cache is whole on every rank and takes
the paths above. A stripe cache placed by ``cache_spec`` is a DTensor:
sequence-sharded stripes decode through :func:`seq_shard_decode` on each
rank's slice of keys and merge the ranks' (out, LSE) pairs
(flash-decoding). The projections are column-parallel and ``w_o``
row-parallel where the plan splits them over the model axis; prefill and
train attention then run on this rank's heads.

Cache updates are **in place**: where the reference returns a new pool
or stripe from a donated functional ``.at[].set``, these functions write
the new tokens' K/V into the caller's tensors with ``index_put_`` and
return the same tensors. A stripe write past the stripe's end is
dropped, as JAX drops an out-of-bounds scatter update
(:func:`_stripe_write`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import kernel_route
from repro_torch.kernels.decode_attention.ops import (
    decode_attention as _decode_kernel)
from repro_torch.kernels.decode_attention.ref import merge_partials
from repro_torch.kernels.flash_attention.ops import attention_bshd
from repro_torch.models import layers
from repro_torch.serve.blocks import SCRATCH_BLOCK

_NEG = torch.finfo(torch.float32).min


def init_attention(gen, cfg, device, dtype=None, lead: tuple = ()):
    d, hd = cfg.d_model, cfg.hd
    dtype = dtype or cfg.dtype
    p = {
        "w_q": layers.dense_init(gen, d, cfg.n_heads * hd, dtype, device,
                                 lead),
        "w_kv": layers.dense_init(gen, d, 2 * cfg.n_kv_heads * hd, dtype,
                                  device, lead),
        "w_o": layers.dense_init(gen, cfg.n_heads * hd, d, dtype, device,
                                 lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return p


def qkv(x, p, cfg, positions=None, mrope_positions=None, plan=None,
        local_heads: bool = False):
    """Project to q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with rope + qk_norm;
    mrope takes its (B, 3, S) ids from ``mrope_positions``.

    Under ``plan`` the projections are column-parallel
    (:meth:`~repro_torch.sharding.rules.ParallelPlan.col_linear`);
    ``local_heads``: q holds only this rank's heads (the heads divide the
    model axis and ``w_q`` is split over it), k and v every head."""
    B, S, _ = x.shape
    hd = cfg.hd
    if plan is None:
        q = x @ p["w_q"]
        kv = x @ p["w_kv"]
    else:
        q = plan.col_linear(x, p["w_q"], gather=not local_heads)
        kv = plan.col_linear(x, p["w_kv"])
    q = q.reshape(B, S, -1, hd)
    kv = kv.reshape(B, S, 2, cfg.n_kv_heads, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope == "rope":
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta)
    # "learned" / "none": the caller adds its positions to the embedding
    return q, k, v


def _expand_kv(kv, G: int):
    """(B,T,Hkv,hd) -> (B,T,Hq,hd) by repeating each kv head G times
    (q head h reads kv head h // G)."""
    if G == 1:
        return kv
    B, T, Hkv, hd = kv.shape
    return kv[:, :, :, None, :].expand(B, T, Hkv, G, hd) \
        .reshape(B, T, Hkv * G, hd)


def _gqa_scores(q, k):
    """q (B,S,Hq,hd), k (B,T,Hkv,hd) -> scores (B,Hq,S,T) in f32."""
    hd = q.shape[-1]
    kx = _expand_kv(k, q.shape[2] // k.shape[2])
    s = torch.einsum("bshd,bthd->bhst", q.float(), kx.float())
    return s / math.sqrt(hd)


def _combine(scores, v, Hq: int):
    """scores (B,Hq,S,T) f32, v (B,T,Hkv,hd) -> out (B,S,Hq*hd); the
    softmax weights are cast to v's dtype before the PV contraction."""
    B, _, S, _ = scores.shape
    vx = _expand_kv(v, Hq // v.shape[2])
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhst,bthd->bshd", w.to(v.dtype), vx)
    return o.reshape(B, S, Hq * v.shape[-1])


Q_CHUNK = 1024  # query-block size for the chunked path


def _masked_attention(q, k, v, q_offset, *, sliding_window=0, causal=True):
    """q (B,S,Hq,hd) at absolute positions q_offset + [0,S)."""
    S, T = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k)
    i = torch.arange(S, device=q.device)[:, None] + q_offset
    j = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if sliding_window:
        mask &= j > i - sliding_window
    scores = scores.masked_fill(~mask, _NEG)
    return _combine(scores, v, q.shape[2])


def causal_attention(q, k, v, *, sliding_window: int = 0, causal: bool = True):
    """Full or sliding-window (causal) attention; q/k/v aligned in time.

    CUDA tensors go through the flash kernel. On the CPU, sequences that
    are a multiple of ``Q_CHUNK`` longer than it run in query chunks, so
    the score tensor never materializes at (S, T)."""
    B, S, Hq, hd = q.shape
    T = k.shape[1]
    if kernel_route(q):
        return attention_bshd(q, k, v, causal=causal,
                              sliding_window=sliding_window) \
            .reshape(B, S, Hq * hd)
    if S <= Q_CHUNK or S % Q_CHUNK:
        return _masked_attention(q, k, v, T - S, sliding_window=sliding_window,
                                 causal=causal)
    outs = [_masked_attention(q[:, c:c + Q_CHUNK], k, v, T - S + c,
                              sliding_window=sliding_window, causal=causal)
            for c in range(0, S, Q_CHUNK)]
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, n_valid, *, sliding_window: int = 0):
    """One new token per sequence attending to the cache.

    q: (B, 1, Hq, hd); k/v_cache: (B, T, Hkv, hd); n_valid: (B,) count
    of valid cache entries (the new token's K/V already written)."""
    scores = _gqa_scores(q, k_cache)                       # (B,Hq,1,T)
    T = k_cache.shape[1]
    j = torch.arange(T, device=q.device)
    n_valid = n_valid.reshape(-1, 1)
    valid = j[None, :] < n_valid                           # (B, T)
    if sliding_window:
        valid &= j[None, :] >= n_valid - sliding_window
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG)
    return _combine(scores, v_cache, q.shape[2])


def verify_decode_attention(q, k_cache, v_cache, base, *, sliding_window=0):
    """Multi-token window decode against a gathered cache.

    q: (B, S, Hq, hd) at absolute positions ``base[b] + [0, S)`` (their
    K/V already written); k/v_cache: (B, T, Hkv, hd); base: (B,) tokens
    cached per row *before* this window. Query j attends to cache
    positions <= base[b] + j."""
    scores = _gqa_scores(q, k_cache)                       # (B,Hq,S,T)
    S, T = q.shape[1], k_cache.shape[1]
    i = base.reshape(-1, 1, 1) + torch.arange(S, device=q.device)[None, :,
                                                                  None]
    j = torch.arange(T, device=q.device)[None, None, :]
    valid = j <= i
    if sliding_window:
        valid &= j > i - sliding_window
    scores = scores.masked_fill(~valid[:, None, :, :], _NEG)
    return _combine(scores, v_cache, q.shape[2])


def _gather(pool, block_table):
    """(num_blocks, bs, Hkv, hd) pool -> (B, max_blocks*bs, Hkv, hd)."""
    B, max_blocks = block_table.shape
    g = pool[block_table.long()]
    return g.reshape(B, max_blocks * pool.shape[1], *pool.shape[2:])


def paged_verify_attention(q, pool_k, pool_v, k_new, v_new, block_table,
                           cache_len, n_write, *, sliding_window: int = 0,
                           use_kernel: bool = False):
    """Multi-token window against the KV block pool: the speculative
    verify step and the chunked-prefill step share this path.

    q/k_new/v_new: (B, S, H*, hd) — S window tokens per row at positions
    ``cache_len[b] + [0, S)``; n_write: (B,) tokens of the window row b
    owns blocks for. Window token j of row b is written **in place** at
    ``(block_table[b, (len+j) // bs], (len+j) % bs)`` when ``j <
    n_write[b]`` and diverted to the scratch block otherwise (diverted
    writes may collide there; scratch is never read into a committed
    output). Returns (out (B, S, Hq*hd), pool_k, pool_v)."""
    bs = pool_k.shape[1]
    B, S = q.shape[:2]
    max_blocks = block_table.shape[1]
    base = cache_len.to(torch.int32).reshape(-1)            # (B,)
    steps = torch.arange(S, device=q.device)
    pos = base[:, None].long() + steps[None, :]             # (B,S)
    safe = steps[None, :] < n_write.reshape(-1, 1)
    # past the table only diverted pad positions occur; clamp the lookup
    # as the reference's gather does
    logical = torch.clamp(pos // bs, max=max_blocks - 1)
    phys = torch.where(safe, block_table.long().gather(1, logical),
                       SCRATCH_BLOCK)
    pool_k[phys, pos % bs] = k_new.to(pool_k.dtype)
    pool_v[phys, pos % bs] = v_new.to(pool_v.dtype)
    if use_kernel:
        from repro_torch.kernels.paged_attention.ops import (
            paged_window_attention as _window_kernel)
        out, _ = _window_kernel(q, pool_k, pool_v, block_table, base,
                                sliding_window=sliding_window)
        return out.reshape(B, S, -1), pool_k, pool_v
    out = verify_decode_attention(q, _gather(pool_k, block_table),
                                  _gather(pool_v, block_table), base,
                                  sliding_window=sliding_window)
    return out, pool_k, pool_v


def paged_decode_attention(q, pool_k, pool_v, k_new, v_new, block_table,
                           cache_len, *, sliding_window: int = 0,
                           use_kernel: bool = False):
    """Decode one token per sequence against the shared KV block pool.

    q/k_new/v_new: (B, 1, H*, hd); pool_k/pool_v: (num_blocks, bs, Hkv,
    hd); block_table: (B, max_blocks) int32; cache_len: (B,) tokens
    already cached per row. The new token's K/V is written in place at
    ``(block_table[b, len // bs], len % bs)`` first; then row b attends
    to its ``len + 1`` tokens, through the gather (``use_kernel=False``)
    or the paged-window kernel at S = 1. Returns (out, pool_k, pool_v)."""
    bs = pool_k.shape[1]
    idx = cache_len.to(torch.int32).reshape(-1)             # (B,)
    rows = torch.arange(idx.shape[0], device=q.device)
    phys = block_table.long()[rows, (idx // bs).long()]
    pool_k[phys, (idx % bs).long()] = k_new[:, 0].to(pool_k.dtype)
    pool_v[phys, (idx % bs).long()] = v_new[:, 0].to(pool_v.dtype)
    B = block_table.shape[0]
    if use_kernel:
        from repro_torch.kernels.paged_attention.ops import (
            paged_decode_attention as _paged_kernel)
        out, _ = _paged_kernel(q[:, 0], pool_k, pool_v, block_table, idx + 1,
                               sliding_window=sliding_window)
        return out.reshape(B, 1, -1), pool_k, pool_v
    out = decode_attention(q, _gather(pool_k, block_table),
                           _gather(pool_v, block_table), idx + 1,
                           sliding_window=sliding_window)
    return out, pool_k, pool_v


def _stripe_write(cache, new, pos):
    """Write ``new`` (B,S,Hkv,hd) into the stripe ``cache`` (B,T,Hkv,hd)
    in place at positions ``pos`` (B,S); a position >= T is dropped.

    No host sync and no real position changes: a dropped write is sent
    to a site that receives the same value anyway — the row's first
    window position (written with ``new[:, 0]``) when that one is in
    range, else position T - 1 rewritten with its own old value."""
    B, T = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)[:, None]
    new = new.to(cache.dtype)
    ok = pos < T
    head_ok = ok[:, :1]
    anchor = torch.where(head_ok, pos[:, :1], T - 1)          # (B,1)
    keep = torch.where(head_ok[..., None, None], new[:, :1],
                       cache[rows, anchor])
    cache[rows, torch.where(ok, pos, anchor)] = torch.where(
        ok[..., None, None], new, keep)
    return cache


def stripe_verify_attention(q, k_cache, v_cache, k_new, v_new, cache_len, *,
                            sliding_window: int = 0):
    """Multi-token window against the stripe cache: window token j of
    row b writes its K/V at ``cache_len[b] + j`` (dropped past the
    stripe) and attends to cache positions <= ``cache_len[b] + j``.
    Returns (out (B,S,Hq*hd), k_cache, v_cache)."""
    S = q.shape[1]
    base = cache_len.reshape(-1)
    pos = base[:, None].long() + torch.arange(S, device=q.device)[None, :]
    _stripe_write(k_cache, k_new, pos)
    _stripe_write(v_cache, v_new, pos)
    out = verify_decode_attention(q, k_cache, v_cache, base,
                                  sliding_window=sliding_window)
    return out, k_cache, v_cache


def stripe_decode_attention(q, k_cache, v_cache, k_new, v_new, cache_len, *,
                            sliding_window: int = 0):
    """One token per row against the stripe cache: cache_len (B,) tokens
    already cached per row (a scalar applies to every row). The new K/V
    goes to ``cache_len[b]`` (dropped at capacity), then row b attends
    to its ``cache_len[b] + 1`` tokens, through the decode kernel on CUDA
    tensors (the stripe read in place). Returns (out, k_cache, v_cache)."""
    B = q.shape[0]
    idx = cache_len.reshape(-1).expand(B)
    _stripe_write(k_cache, k_new, idx[:, None].long())
    _stripe_write(v_cache, v_new, idx[:, None].long())
    if kernel_route(q):
        out, _ = _decode_kernel(q[:, 0], k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), idx + 1,
                                sliding_window=sliding_window)
        return out.reshape(B, 1, -1), k_cache, v_cache
    out = decode_attention(q, k_cache, v_cache, idx + 1,
                           sliding_window=sliding_window)
    return out, k_cache, v_cache


def seq_shard_decode(q, k_slice, v_slice, k_new, v_new, idx, t0: int, *,
                     sliding_window: int = 0):
    """One rank's part of decode against a sequence-sharded stripe cache:
    ``k_slice`` / ``v_slice`` (B, T_loc, Hkv, hd) hold keys ``[t0, t0 +
    T_loc)``. The new K/V is written in place at ``idx - t0`` (dropped
    when it falls outside the slice), then the decode kernel reads the
    slice with the count ``max(n - t0, 0)``, n = idx + 1, never clamped
    above: the kernel reads ``[max(0, count - window), min(count,
    T_loc))``, so a sliding window stays exact across slices. A slice
    wholly outside a row's window gives out 0 and an LSE that weighs
    nothing in :func:`merge_partials`. idx: (B,) tokens cached per row.
    Returns (out (B,Hq,hd), lse (B,Hq) f32)."""
    T_loc = k_slice.shape[1]
    pos = idx.reshape(-1, 1).long() - t0
    pos = torch.where(pos < 0, T_loc, pos)      # before the slice: dropped
    _stripe_write(k_slice, k_new, pos)
    _stripe_write(v_slice, v_new, pos)
    n_loc = torch.clamp_min(idx.reshape(-1) + 1 - t0, 0)
    return _decode_kernel(q[:, 0], k_slice.transpose(1, 2),
                          v_slice.transpose(1, 2), n_loc,
                          sliding_window=sliding_window)


def _heads_split(plan, cfg, p) -> bool:
    """Attention runs on this rank's heads when q and kv heads divide the
    model axis (the head-boundary rule of ``ParallelPlan.param_spec``)
    and ``w_q`` is split over it by heads."""
    if plan is None:
        return False
    nm = plan.axis_size(plan.model_axis)
    return nm > 1 and cfg.n_heads % nm == 0 and cfg.n_kv_heads % nm == 0 \
        and plan.split_dim(p["w_q"]) == 1


def _my_kv_heads(t, cfg, plan):
    """This rank's kv heads of ``t`` (B,S,Hkv,hd), whole on every rank:
    the kv columns are [K heads | V heads], so ``w_kv``'s column block is
    no head block and the whole projection is cut instead."""
    m = plan.model_axis
    hk = cfg.n_kv_heads // plan.axis_size(m)
    return plan.psum_grad(t, m).narrow(2, plan.coord(m) * hk, hk)


def _out_proj(o, p, plan, *, local: bool = False):
    """o @ w_o; under ``plan`` row-parallel (``local``: ``o`` holds this
    rank's heads)."""
    if plan is None:
        return o @ p["w_o"]
    return plan.row_linear(o, p["w_o"], local=local)


def attention_block(x, p, cfg, *, mode: str, cache=None, cache_len=None,
                    positions=None, mrope_positions=None, causal=True,
                    sliding_window=None, block_table=None,
                    paged_kernel=False, n_write=None, plan=None,
                    kv_seq=None):
    """Full attention sub-block incl. output proj. Returns (out, new_cache).

    In prefill/train mode ``cache`` is unused and prefill returns this
    layer's fresh ``{k, v}``. In decode mode ``cache`` is the layer's
    paged pool dict(k=(num_blocks,bs,Hkv,hd), ...) with ``block_table``
    set, or its stripes dict(k=(B,T,Hkv,hd), ...) without; ``x`` with
    more than one token per row is a multi-token window (chunked prefill
    / verify) whose paged writes past ``n_write[b]`` divert to scratch.
    The cache is updated in place and returned.

    ``kv_seq`` (axes, t0): the stripes are this rank's slice of a cache
    sequence-sharded over ``axes``, starting at key t0 (decode of one
    token a row only); ``plan`` then gathers and merges the slices'
    partials."""
    win = cfg.sliding_window if sliding_window is None else sliding_window
    split = mode != "decode" and _heads_split(plan, cfg, p)
    if plan is not None:
        # q_norm reads only this rank's heads when they are split: its
        # gradient here is a partial sum over the model axis
        p = {k: v if k in ("w_q", "w_kv", "w_o") else
             plan.gather(v, model_partial=split and k == "q_norm")
             for k, v in p.items()}
    if mode == "decode":
        B, S, _ = x.shape
        idx = cache_len.to(torch.int32)
        if S > 1:
            idx = idx.reshape(-1)
            pos = idx[:, None] + torch.arange(S, device=x.device)[None, :]
            q, k, v = qkv(x, p, cfg, positions=pos,
                          mrope_positions=mrope_positions, plan=plan)
            if block_table is None:
                o, k_cache, v_cache = stripe_verify_attention(
                    q, cache["k"], cache["v"], k, v, idx, sliding_window=win)
            else:
                nw = torch.full((B,), S, dtype=torch.int32,
                                device=x.device) \
                    if n_write is None else n_write
                o, k_cache, v_cache = paged_verify_attention(
                    q, cache["k"], cache["v"], k, v, block_table, idx, nw,
                    sliding_window=win, use_kernel=paged_kernel)
        else:
            pos = idx if positions is None else positions
            q, k, v = qkv(x, p, cfg, positions=pos.reshape(-1, 1),
                          mrope_positions=mrope_positions, plan=plan)
            if kv_seq is not None and kv_seq[0]:
                axes, t0 = kv_seq
                o, lse = seq_shard_decode(q, cache["k"], cache["v"], k, v,
                                          idx.reshape(-1).expand(B), t0,
                                          sliding_window=win)
                outs = plan.all_gather(o[None], 0, axes)
                lses = plan.all_gather(lse[None], 0, axes)
                o = merge_partials(list(outs), list(lses)).reshape(B, 1, -1)
                k_cache, v_cache = cache["k"], cache["v"]
            elif block_table is None:
                o, k_cache, v_cache = stripe_decode_attention(
                    q, cache["k"], cache["v"], k, v, idx, sliding_window=win)
            else:
                o, k_cache, v_cache = paged_decode_attention(
                    q, cache["k"], cache["v"], k, v, block_table,
                    idx.reshape(-1), sliding_window=win,
                    use_kernel=paged_kernel)
        return _out_proj(o, p, plan), {"k": k_cache, "v": v_cache}
    q, k, v = qkv(x, p, cfg, positions=positions,
                  mrope_positions=mrope_positions, plan=plan,
                  local_heads=split)
    ka, va = (k, v) if not split else \
        (_my_kv_heads(t, cfg, plan) for t in (k, v))
    o = causal_attention(q, ka, va, sliding_window=win, causal=causal)
    new_cache = {"k": k, "v": v} if mode == "prefill" else None
    return _out_proj(o, p, plan, local=split), new_cache


# ------------------------------------------------------------- cross-attn
def init_cross_attention(gen, cfg, device, dtype=None, lead: tuple = ()):
    d, hd = cfg.d_model, cfg.hd
    dtype = dtype or cfg.dtype
    return {
        "w_q": layers.dense_init(gen, d, cfg.n_heads * hd, dtype, device,
                                 lead),
        "w_kv": layers.dense_init(gen, d, 2 * cfg.n_kv_heads * hd, dtype,
                                  device, lead),
        "w_o": layers.dense_init(gen, cfg.n_heads * hd, d, dtype, device,
                                 lead),
    }


def cross_attention_block(x, enc_kv, p, cfg):
    """x (B,S,d) attends to precomputed encoder K/V (B,T,Hkv,hd): no
    rope, no qk_norm, no mask (the flash kernel, non-causal, on CUDA
    tensors)."""
    B, S, _ = x.shape
    q = (x @ p["w_q"]).reshape(B, S, cfg.n_heads, cfg.hd)
    o = causal_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return o @ p["w_o"]


def encode_cross_kv(enc_out, p, cfg):
    """Encoder output (B,T,d) -> this layer's cross K / V (B,T,Hkv,hd),
    views of one projection."""
    B, T, _ = enc_out.shape
    kv = (enc_out @ p["w_kv"]).reshape(B, T, 2, cfg.n_kv_heads, cfg.hd)
    return {"k": kv[:, :, 0], "v": kv[:, :, 1]}
