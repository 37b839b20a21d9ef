"""Backbone blocks + the loop over layers (dense, moe, rwkv, hybrid and
decoder_x kinds; decoder_x is a dense block with a cross-attention
sub-block after its self-attention).

A block apply function is ``(x, p, cfg, mode, cache, extras) -> (x,
new_cache, aux)``. Block params are stacked with a leading L axis and the
stack is a Python loop over layers (the reference's ``lax.scan``); with
``cfg.remat`` a training layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scan body).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, moe, rwkv6, ssm


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
    """Layer ``l``'s view of a tree of L-stacked tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def apply_block(x, p, cfg, *, kind, mode, cache=None, extras=None):
    """Returns (x, new_cache, aux). extras: dict with positions /
    mrope_positions / cache_len / block_table / paged_kernel / n_write /
    enc_kv (this layer's cross K / V) as applicable. ``aux`` is the MoE
    FFN's load-balancing loss (an f32 scalar tensor), 0.0 for the other
    kinds."""
    extras = extras or {}
    eps = cfg.norm_eps
    aux = 0.0

    if kind == "rwkv":
        tcache = None if cache is None else {"state": cache["state"],
                                             "last_x": cache["last_x_t"]}
        ccache = None if cache is None else {"last_x": cache["last_x_c"]}
        h, tnew = rwkv6.time_mix(layers.rmsnorm(x, p["ln1"], eps),
                                 p["tmix"], cfg, tcache)
        x = x + h
        h, cnew = rwkv6.channel_mix(layers.rmsnorm(x, p["ln2"], eps),
                                    p["cmix"], cfg, ccache)
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
        n_write=extras.get("n_write"))
    if kind == "hybrid":
        # attention and the SSM both read the same normed h; their
        # outputs are normed and averaged
        scache = None if cache is None else {"state": cache["ssm_state"]}
        ssm_out, snew = ssm.ssm_block(h, p["ssm"], cfg, scache)
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
                                                p["xattn"], cfg)
    h = layers.rmsnorm(x, p["ln2"], eps)
    if kind == "moe":
        ffn_out, aux = moe.moe_ffn(h, p["moe"], cfg)
        x = x + ffn_out
    else:
        x = x + layers.mlp(h, p["ffn"], cfg.act)
    return x, (new_cache if mode != "train" else None), aux


def apply_stack(x, blocks, cfg, *, kind, mode, cache=None, extras=None,
                enc_kv=None):
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
    decode mode it reads the cache's ``xk`` / ``xv`` in place."""
    if enc_kv is None and cache is not None and "xk" in cache:
        enc_kv = {"k": cache["xk"], "v": cache["xv"]}
    L = blocks["ln1"].shape[0]
    fresh = []
    aux = 0.0
    remat = cfg.remat and mode == "train"
    for l in range(L):
        c = None if cache is None else _layer(cache, l)
        ex = extras if enc_kv is None else \
            {**(extras or {}), "enc_kv": _layer(enc_kv, l)}
        if remat:
            x, a = checkpoint(_train_layer, x, _layer(blocks, l), cfg, kind,
                              ex, use_reentrant=False)
            new_c = None
        else:
            x, new_c, a = apply_block(x, _layer(blocks, l), cfg, kind=kind,
                                      mode=mode, cache=c, extras=ex)
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


def _train_layer(x, p, cfg, kind, extras):
    x, _, aux = apply_block(x, p, cfg, kind=kind, mode="train",
                            extras=extras)
    return x, aux
