"""Backbone blocks + the loop over layers (dense, moe, rwkv and hybrid
kinds).

A block apply function is ``(x, p, cfg, mode, cache, extras) -> (x,
new_cache)``. Block params are stacked with a leading L axis and the
stack is a Python loop over layers (the reference's ``lax.scan``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe, rwkv6, ssm


def init_block(gen, cfg, *, kind: str, device, lead: tuple = ()):
    """One block's params, or ``lead`` stacked blocks drawn at once."""
    if kind not in ("dense", "moe", "rwkv", "hybrid"):
        _unported(kind)
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
    return p


_LATER = {"decoder_x": "the 'frontends' slice of ROADMAP.md"}


def _unported(kind: str):
    raise NotImplementedError(f"block kind {kind!r} is not ported yet: "
                              f"{_LATER.get(kind, 'not on the roadmap')}")


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
    """Returns (x, new_cache). extras: dict with positions / cache_len /
    block_table / paged_kernel / n_write as applicable. The MoE FFN's
    aux loss (a training term) is dropped."""
    if kind not in ("dense", "moe", "rwkv", "hybrid"):
        _unported(kind)
    extras = extras or {}
    eps = cfg.norm_eps

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
            return x, None
        return x, {"state": tnew["state"], "last_x_t": tnew["last_x"],
                   "last_x_c": cnew["last_x"]}

    h = layers.rmsnorm(x, p["ln1"], eps)
    acache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    attn_out, new_cache = attention.attention_block(
        h, p["attn"], cfg, mode=mode, cache=acache,
        cache_len=extras.get("cache_len"),
        positions=extras.get("positions"),
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
    h = layers.rmsnorm(x, p["ln2"], eps)
    if kind == "moe":
        x = x + moe.moe_ffn(h, p["moe"], cfg)[0]
    else:
        x = x + layers.mlp(h, p["ffn"], cfg.act)
    return x, (new_cache if mode != "train" else None)


def apply_stack(x, blocks, cfg, *, kind, mode, cache=None, extras=None):
    """Apply the stacked layer params, one layer at a time.

    Prefill (``cache`` None) returns every fresh cache leaf stacked over
    L: ``k`` / ``v`` (L,B,S,Hkv,hd), ``ssm_state`` (L,B,di,N), or
    ``state`` (L,B,H,hd,hd) / ``last_x_t`` / ``last_x_c`` (L,B,d). In
    decode mode ``cache`` is a dict of (L, ...) tensors — the paged pool
    or the per-slot stripes — and each layer's slice is updated in
    place: attention writes its K/V into the slice itself, the other
    leaves are copied over. The same dict is returned."""
    L = blocks["ln1"].shape[0]
    fresh = []
    for l in range(L):
        c = None if cache is None else _layer(cache, l)
        x, new_c = apply_block(x, _layer(blocks, l), cfg, kind=kind,
                               mode=mode, cache=c, extras=extras)
        if mode == "prefill":
            fresh.append(new_c)
        elif c is not None:
            for key, t in new_c.items():
                if t is not c[key]:
                    c[key].copy_(t)
    if mode == "prefill":
        return x, {key: torch.stack([f[key] for f in fresh])
                   for key in fresh[0]}
    return x, cache
