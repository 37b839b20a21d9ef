"""Backbone blocks + the loop over layers (dense, moe, rwkv, hybrid and
decoder_x kinds; decoder_x is a dense block with a cross-attention
sub-block after its self-attention).

A block apply function is ``(x, p, cfg, mode, cache, extras, plan) ->
(x, new_cache, aux)``. Block params are stacked with a leading L axis and the
stack is a Python loop over layers (the reference's ``lax.scan``); with
``cfg.remat`` a training layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scan body).

Under a ``ParallelPlan`` a layer's params are DTensors (or whole plain
tensors). Every sub-block reads its own blocks of its weights: attention,
cross-attention and the MLP are tensor-parallel (column-parallel
projections, row-parallel ``w_o`` / ``w_out``), so are the RWKV6
time-mix and channel-mix and the SSM (each rank computes its heads or
channels and runs its scan on them), and the MoE FFN runs its expert- /
tensor-parallel body. Only the block's norms are gathered whole at
block entry; a sub-block gathers its own small params (``mu``,
``bonus_u``, ``decay_base``, ``ln_out``, ``A_log``, ``D``,
``dt_bias``, ``q_norm`` / ``k_norm``), all inside the checkpointed
layer, and a sub-block whose heads or channels do not split over
``model`` gathers its weights whole. Caches placed by ``cache_spec``
(DTensors) are read and written through each rank's local tensor: the
recurrent state's is this rank's heads / channels. Between train layers
the residual stream is a DTensor under ``constrain_residual``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, moe, rwkv6, ssm
from repro_torch.sharding.rules import DTensor, layer_slice


def init_block(gen, cfg, *, kind: str, device, lead: tuple = ()):
    """One block's params, or ``lead`` stacked blocks drawn at once."""
    d, dtype = cfg.d_model, cfg.dtype

    def ones():
        return torch.ones(lead + (d,), dtype=dtype, device=device)

    if kind == "rwkv":
        return {
            "ln1": ones(),
            "tmix": rwkv6.init_time_mix(gen, cfg, device, lead=lead),
            "ln2": ones(),
            "cmix": rwkv6.init_channel_mix(gen, cfg, device, lead=lead),
        }
    p = {
        "ln1": ones(),
        "attn": attention.init_attention(gen, cfg, device, lead=lead),
        "ln2": ones(),
    }
    if kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg, device, lead=lead)
    else:
        p["ffn"] = layers.init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device,
                                   lead)
    if kind == "hybrid":
        p["ssm"] = ssm.init_ssm(gen, cfg, device, lead=lead)
        p["ln_attn_out"] = ones()
        p["ln_ssm_out"] = ones()
    if kind == "decoder_x":
        p["lnx"] = ones()
        p["xattn"] = attention.init_cross_attention(gen, cfg, device,
                                                    lead=lead)
    return p


def block_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.cross_attention:
        return "decoder_x"
    return "dense"


def _layer(tree, l: int):
    """Layer ``l``'s view of a tree of L-stacked tensors (a DTensor's
    layer stays a DTensor)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return layer_slice(tree, l)


def _local_layer(tree, l: int):
    """Layer ``l`` of a cache: a DTensor's is a view of this rank's local
    tensor, so in-place writes land in the cache."""
    return {k: (v.to_local() if isinstance(v, DTensor) else v)[l]
            for k, v in tree.items()}


def _planned(plan) -> bool:
    return plan is not None and plan.mesh is not None


def _cache_shards(cache, plan) -> dict:
    """extras for a cache placed by ``cache_spec``: the sequence slice of
    the stripes (``kv_seq``), this rank's part of dim 2 of the stacked
    leaf. (The recurrent state's local tensor is this rank's heads /
    channels: the bodies read that from its shape.)"""
    out = {}
    if "k" in cache and isinstance(cache["k"], DTensor):
        axes, t0, _ = plan.shard_of(cache["k"], 2)
        out["kv_seq"] = (axes, t0)
    return out


def apply_block(x, p, cfg, *, kind, mode, cache=None, extras=None,
                plan=None):
    """Returns (x, new_cache, aux). extras: dict with positions /
    mrope_positions / cache_len / block_table / paged_kernel / n_write /
    enc_kv (this layer's cross K / V) as applicable. ``aux`` is the MoE
    FFN's load-balancing loss (an f32 scalar tensor), 0.0 for the other
    kinds."""
    extras = extras or {}
    eps = cfg.norm_eps
    aux = 0.0
    if _planned(plan):
        # the sub-blocks read their own blocks; the norms are gathered
        p = {k: v if isinstance(v, dict) else plan.gather(v)
             for k, v in p.items()}
    else:
        plan = None

    if kind == "rwkv":
        tcache = None if cache is None else {"state": cache["state"],
                                             "last_x": cache["last_x_t"]}
        ccache = None if cache is None else {"last_x": cache["last_x_c"]}
        h, tnew = rwkv6.time_mix(layers.rmsnorm(x, p["ln1"], eps),
                                 p["tmix"], cfg, tcache, plan)
        x = x + h
        h, cnew = rwkv6.channel_mix(layers.rmsnorm(x, p["ln2"], eps),
                                    p["cmix"], cfg, ccache, plan)
        x = x + h
        if mode == "train":
            return x, None, aux
        return x, {"state": tnew["state"], "last_x_t": tnew["last_x"],
                   "last_x_c": cnew["last_x"]}, aux

    h = layers.rmsnorm(x, p["ln1"], eps)
    acache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    attn_out, new_cache = attention.attention_block(
        h, p["attn"], cfg, mode=mode, cache=acache,
        cache_len=extras.get("cache_len"),
        positions=extras.get("positions"),
        mrope_positions=extras.get("mrope_positions"),
        block_table=extras.get("block_table"),
        paged_kernel=extras.get("paged_kernel", False),
        n_write=extras.get("n_write"), plan=plan,
        kv_seq=extras.get("kv_seq"))
    if kind == "hybrid":
        # attention and the SSM both read the same normed h; their
        # outputs are normed and averaged
        scache = None if cache is None else {"state": cache["ssm_state"]}
        ssm_out, snew = ssm.ssm_block(h, p["ssm"], cfg, scache, plan)
        attn_out = layers.rmsnorm(attn_out, p["ln_attn_out"], eps)
        ssm_out = layers.rmsnorm(ssm_out, p["ln_ssm_out"], eps)
        x = x + 0.5 * (attn_out + ssm_out)
        if new_cache is not None:
            new_cache["ssm_state"] = snew["state"]
    else:
        x = x + attn_out
    if kind == "decoder_x":
        hx = layers.rmsnorm(x, p["lnx"], eps)
        x = x + attention.cross_attention_block(hx, extras["enc_kv"],
                                                p["xattn"], cfg, plan)
    h = layers.rmsnorm(x, p["ln2"], eps)
    if kind == "moe":
        hook = moe.span_hook.hook
        if hook is None:
            ffn_out, aux = moe.moe_ffn(h, p["moe"], cfg, plan)
        else:
            # a traced engine step: the FFN's device work as one span
            with hook:
                ffn_out, aux = moe.moe_ffn(h, p["moe"], cfg, plan)
        x = x + ffn_out
    else:
        x = x + layers.mlp(h, p["ffn"], cfg.act, plan)
    return x, (new_cache if mode != "train" else None), aux


def apply_stack(x, blocks, cfg, *, kind, mode, cache=None, extras=None,
                enc_kv=None, plan=None):
    """Apply the stacked layer params, one layer at a time. Returns (x,
    cache, aux): ``aux`` sums the layers' aux losses (0.0 without MoE).

    Prefill (``cache`` None) returns every fresh cache leaf stacked over
    L: ``k`` / ``v`` (L,B,S,Hkv,hd), ``ssm_state`` (L,B,di,N), or
    ``state`` (L,B,H,hd,hd) / ``last_x_t`` / ``last_x_c`` (L,B,d). In
    decode mode ``cache`` is a dict of (L, ...) tensors — the paged pool
    or the per-slot stripes — and each layer's slice is updated in
    place: attention writes its K/V into the slice itself, the other
    leaves are copied over. The same dict is returned. Train mode
    returns no cache; with ``cfg.remat`` each layer keeps only its input
    and recomputes the rest in the backward pass (the flash forward runs
    twice a layer).

    decoder_x: layer l cross-attends to ``enc_kv`` {k, v} (L,B,T,Hkv,hd)
    at prefill, which returns them as the cache's ``xk`` / ``xv``; in
    decode mode it reads the cache's ``xk`` / ``xv`` in place.

    ``plan`` (a ``ParallelPlan`` bound to the activations' rows): blocks
    run their tensor-parallel bodies; a train layer takes the residual
    stream as a DTensor constrained by ``constrain_residual``."""
    if enc_kv is None and cache is not None and "xk" in cache:
        enc_kv = {"k": cache["xk"], "v": cache["xv"]}
    planned = _planned(plan)
    if planned and cache is not None:
        extras = {**(extras or {}), **_cache_shards(cache, plan)}
    L = blocks["ln1"].shape[0]
    fresh = []
    aux = 0.0
    remat = cfg.remat and mode == "train"
    for l in range(L):
        c = None if cache is None else _local_layer(cache, l)
        ex = extras if enc_kv is None else \
            {**(extras or {}), "enc_kv": _local_layer(enc_kv, l)}
        if planned and mode == "train":
            x = plan.constrain_residual(plan.act_dtensor(x))
        if remat:
            x, a = checkpoint(_train_layer, x, _layer(blocks, l), cfg, kind,
                              ex, plan if planned else None,
                              use_reentrant=False)
            new_c = None
        else:
            if planned:
                x = plan.act_local(x)
            x, new_c, a = apply_block(x, _layer(blocks, l), cfg, kind=kind,
                                      mode=mode, cache=c, extras=ex,
                                      plan=plan if planned else None)
        aux = aux + a
        if mode == "prefill":
            fresh.append(new_c)
        elif c is not None:
            for key, t in new_c.items():
                if t is not c[key]:
                    c[key].copy_(t)
    if mode == "prefill":
        out = {key: torch.stack([f[key] for f in fresh]) for key in fresh[0]}
        if enc_kv is not None:
            out["xk"], out["xv"] = enc_kv["k"], enc_kv["v"]
        return x, out, aux
    return x, cache, aux


def _train_layer(x, p, cfg, kind, extras, plan=None):
    if plan is not None:
        x = plan.act_local(x)
    x, _, aux = apply_block(x, p, cfg, kind=kind, mode="train",
                            extras=extras, plan=plan)
    return x, aux
