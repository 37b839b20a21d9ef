"""Backbone blocks + the loop over layers (dense kind).

A block apply function is ``(x, p, cfg, mode, cache, extras) -> (x,
new_cache)``. Block params are stacked with a leading L axis and the
stack is a Python loop over layers (the reference's ``lax.scan``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers


def init_block(gen, cfg, *, kind: str, device, lead: tuple = ()):
    """One block's params, or ``lead`` stacked blocks drawn at once."""
    if kind != "dense":
        _unported(kind)
    d, dtype = cfg.d_model, cfg.dtype
    return {
        "ln1": torch.ones(lead + (d,), dtype=dtype, device=device),
        "attn": attention.init_attention(gen, cfg, device, lead=lead),
        "ln2": torch.ones(lead + (d,), dtype=dtype, device=device),
        "ffn": layers.init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device,
                               lead),
    }


_LATER = {"moe": "the 'MoE' slice of ROADMAP.md",
          "rwkv": "the 'recurrent families' slice of ROADMAP.md",
          "hybrid": "the 'recurrent families' slice of ROADMAP.md",
          "decoder_x": "the 'frontends' slice of ROADMAP.md"}


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
    block_table / paged_kernel / n_write as applicable."""
    if kind != "dense":
        _unported(kind)
    extras = extras or {}
    eps = cfg.norm_eps
    h = layers.rmsnorm(x, p["ln1"], eps)
    attn_out, new_cache = attention.attention_block(
        h, p["attn"], cfg, mode=mode, cache=cache,
        cache_len=extras.get("cache_len"),
        positions=extras.get("positions"),
        block_table=extras.get("block_table"),
        paged_kernel=extras.get("paged_kernel", False),
        n_write=extras.get("n_write"))
    x = x + attn_out
    h = layers.rmsnorm(x, p["ln2"], eps)
    x = x + layers.mlp(h, p["ffn"], cfg.act)
    return x, (new_cache if mode != "train" else None)


def apply_stack(x, blocks, cfg, *, kind, mode, cache=None, extras=None):
    """Apply the stacked layer params, one layer at a time.

    cache: the paged pool dict of (L, ...) tensors in decode mode
    (updated in place and returned), else None. Prefill returns the
    fresh K/V stacked over L: dict(k=(L,B,S,Hkv,hd), v=...)."""
    L = blocks["ln1"].shape[0]
    ks, vs = [], []
    for l in range(L):
        c = None if cache is None else {"k": cache["k"][l],
                                        "v": cache["v"][l]}
        x, new_c = apply_block(x, _layer(blocks, l), cfg, kind=kind,
                               mode=mode, cache=c, extras=extras)
        if mode == "prefill":
            ks.append(new_c["k"])
            vs.append(new_c["v"])
    if mode == "prefill":
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache
