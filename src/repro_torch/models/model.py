"""Model factory for the dense, MoE, rwkv and hybrid decoder families.

``build_model(cfg, device)`` returns a ``Model`` whose methods take the
params tree explicitly, as in the JAX reference:
    init(seed)                                          -> params
    prefill(params, batch, last_idx=...)                -> (logits_last, cache)
    prefill(params, batch, cache=..., cache_len=...)    -> chunk window
    decode_step(params, token, cache, cache_len[, block_table=...])
    verify_step(params, tokens, cache, cache_len[, block_table=...])
    init_cache(batch_size, capacity)                    -> zeroed stripes
    init_paged_cache(num_blocks, block_size)            -> zeroed pool

Batch dicts: prefill ``{"tokens": (B, S) int}``; decode ``token (B, 1)``.
Every tensor argument lies on the model's device. Caches (the paged
pool, or the per-slot stripes and recurrent state) are updated in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import layers, transformer


# ===================================================================== init
def init_params(cfg, seed: int = 0, *, device="cuda"):
    """Random params drawn from ``torch.Generator(device).manual_seed(seed)``.
    On the ``meta`` device no numbers are drawn: the tree then only
    carries each leaf's shape and dtype."""
    device = torch.device(device)
    gen = None if device.type == "meta" \
        else torch.Generator(device=device).manual_seed(seed)
    d, dtype = cfg.d_model, cfg.dtype
    kind = transformer.block_kind(cfg)
    vp = padded_vocab(cfg)
    embed = torch.randn((vp, d), generator=gen, dtype=torch.float32,
                        device=device)
    p: dict[str, Any] = {
        "embed": embed.mul_(0.02).to(dtype),
        "blocks": transformer.init_block(gen, cfg, kind=kind, device=device,
                                         lead=(cfg.n_layers,)),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, d, vp, dtype, device)
    return p


def padded_vocab(cfg) -> int:
    """Embedding/head rows padded to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def _embed_tokens(p, cfg, tokens):
    if cfg.frontend != "none" or cfg.rope not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: frontends and non-rotary positions are the "
            "'frontends' slice of ROADMAP.md")
    return p["embed"][tokens.long()]


def _logits(p, cfg, x):
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        # one row would take a matrix-vector product, which sums in
        # another order than the matrix product of a batch: a request
        # prefilled alone would emit logprobs an ulp off its co-batched
        # run. Two rows keep a row's logits independent of its batch.
        out = (rows.expand(2, -1) @ head)[:1].reshape(*x.shape[:-1], -1)
    else:
        out = x @ head
    vp = head.shape[-1]
    if vp != cfg.vocab_size:          # padded ids can never be sampled
        pad = torch.arange(vp, device=out.device) >= cfg.vocab_size
        out = out.masked_fill(pad, -1e9)
    return out


def _rows_at(x, idx):
    """x (B, S, d), idx (B,) -> x[b, idx[b]] as (B, 1, d)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx.long()][:, None, :]


# ===================================================================== model
@dataclass(frozen=True)
class Model:
    cfg: Any
    device: torch.device

    def init(self, seed: int = 0):
        return init_params(self.cfg, seed, device=self.device)

    # ---------------- prefill ----------------
    def prefill(self, params, batch, *, last_idx=None, cache=None,
                cache_len=None, block_table=None, paged_kernel: bool = False,
                n_write=None):
        """last_idx: optional (B,) — per-row index of the last *real*
        token when rows are right-padded to a shared bucket length; None
        gives the logits at the final position. Returns (logits (B, 1,
        V), cache) with the fresh cache leaves stacked over L: k / v
        (L,B,S,Hkv,hd) [+ ssm_state (L,B,di,N)], or state (L,B,H,hd,hd) /
        last_x_t / last_x_c (L,B,d) for rwkv.

        **Chunked mode** (``cache`` is the paged pool): ``batch["tokens"]``
        (B, S) is a chunk window of each row's prompt at offset
        ``cache_len[b]``, written into the pool at positions ``cache_len[b]
        + [0, S)`` (past ``n_write[b]`` diverted to scratch) and attending
        causally to everything resident plus the window's own prefix —
        the :meth:`verify_step` path. Returns (logits (B, S, V), pool), or
        only each row's ``last_idx`` position's logits as (B, 1, V)."""
        cfg = self.cfg
        if cache is not None:
            x, new_cache = self._window(params, batch["tokens"], cache,
                                        cache_len, block_table, paged_kernel,
                                        n_write)
            if last_idx is not None:
                x = _rows_at(x, last_idx)
            return _logits(params, cfg, x), new_cache
        x = _embed_tokens(params, cfg, batch["tokens"])
        x, kv = transformer.apply_stack(x, params["blocks"], cfg,
                                        kind=transformer.block_kind(cfg),
                                        mode="prefill")
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        x_last = x[:, -1:, :] if last_idx is None else _rows_at(x, last_idx)
        return _logits(params, cfg, x_last), kv

    # ---------------- decode ----------------
    def decode_step(self, params, token, cache, cache_len, block_table=None,
                    paged_kernel: bool = False):
        """token (B,1); cache_len (B,) tokens already cached per row (a
        scalar: every row at one length); the new token is written at
        index cache_len[b] of row b. Stripe mode (no ``block_table``):
        ``cache`` is :meth:`init_cache`'s dict, every leaf updated in
        place. Paged mode: ``cache`` is the pool (L, num_blocks,
        block_size, Hkv, hd) per leaf and row b's position j resolves to
        (block_table[b, j // block_size], j % block_size).
        ``paged_kernel`` reads the pool through ``kernels.paged_attention``
        instead of the gather."""
        cfg = self.cfg
        x = _embed_tokens(params, cfg, token)
        extras = {"cache_len": cache_len, "block_table": block_table,
                  "paged_kernel": bool(paged_kernel)}
        x, new_cache = transformer.apply_stack(
            x, params["blocks"], cfg, kind=transformer.block_kind(cfg),
            mode="decode", cache=cache, extras=extras)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, cfg, x), new_cache

    # ---------------- verify (multi-token decode) ----------------
    def verify_step(self, params, tokens, cache, cache_len, block_table=None,
                    paged_kernel: bool = False, n_write=None):
        """Multi-token decode: tokens (B, S) at positions ``cache_len[b] +
        [0, S)``; query j sees cache positions <= cache_len[b] + j, so
        ``logits[:, j]`` equals what the j+1-th of S sequential
        :meth:`decode_step` calls would produce. ``n_write`` (B,) caps
        how many window positions row b writes into its own blocks (the
        rest divert to scratch). Returns (logits (B, S, V), pool)."""
        x, new_cache = self._window(params, tokens, cache, cache_len,
                                    block_table, paged_kernel, n_write)
        return _logits(params, self.cfg, x), new_cache

    def _window(self, params, tokens, cache, cache_len, block_table,
                paged_kernel, n_write):
        """Shared multi-token window body (verify / chunked prefill):
        returns the final-norm hidden states (B, S, d) and the pool."""
        cfg = self.cfg
        kind = transformer.block_kind(cfg)
        if kind in ("rwkv", "hybrid"):
            raise ValueError(f"multi-token window unsupported for family "
                             f"{kind!r} (recurrent state is sequential)")
        x = _embed_tokens(params, cfg, tokens)
        extras = {"cache_len": cache_len.reshape(-1),
                  "block_table": block_table,
                  "paged_kernel": bool(paged_kernel), "n_write": n_write}
        x, new_cache = transformer.apply_stack(
            x, params["blocks"], cfg, kind=kind, mode="decode", cache=cache,
            extras=extras)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, new_cache

    # ---------------- cache ----------------
    def init_cache(self, batch_size: int, capacity: int):
        """Zeroed per-slot cache with room for ``capacity`` tokens: K/V
        stripes ``(L, B, capacity, Hkv, hd)`` in ``cfg.dtype``, the hybrid
        SSM state ``(L, B, di, N)`` in f32, or the rwkv state ``(L, B, H,
        hd, hd)`` in f32 with the token-shift carries ``(L, B, d)``."""
        cfg = self.cfg
        L, B = cfg.n_layers, batch_size
        Hkv, hd, d = cfg.n_kv_heads, cfg.hd, cfg.d_model
        kind = transformer.block_kind(cfg)

        def zeros(shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if kind == "decoder_x":
            transformer._unported(kind)
        if kind == "rwkv":
            return {"state": zeros((L, B, cfg.n_heads, hd, hd),
                                   torch.float32),
                    "last_x_t": zeros((L, B, d)),
                    "last_x_c": zeros((L, B, d))}
        cache = {"k": zeros((L, B, capacity, Hkv, hd)),
                 "v": zeros((L, B, capacity, Hkv, hd))}
        if kind == "hybrid":
            cache["ssm_state"] = zeros((L, B, cfg.dinner,
                                        max(cfg.ssm_state, 1)),
                                       torch.float32)
        return cache

    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Zeroed block-pool KV: ``(L, num_blocks, block_size, Hkv, hd)``
        per leaf, shared by every slot through a per-slot block table
        (see ``serve.blocks``). Only pure-attention families page."""
        cfg = self.cfg
        kind = transformer.block_kind(cfg)
        if kind not in ("dense", "moe"):
            raise ValueError(f"paged KV unsupported for family {kind!r} "
                             "(recurrent/cross-attn leaves are not paged)")
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}


def build_model(cfg, device="cuda") -> Model:
    return Model(cfg, torch.device(device))
