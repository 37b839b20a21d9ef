"""Model factory for the dense, MoE, rwkv, hybrid, audio (encoder +
cross-attention decoder) and vision (patch prefix, M-RoPE) families.

``build_model(cfg, device)`` returns a ``Model`` whose methods take the
params tree explicitly, as in the JAX reference:
    init(seed)                                          -> params
    train_loss(params, batch)                           -> (loss, metrics)
    prefill(params, batch, last_idx=...)                -> (logits_last, cache)
    prefill(params, batch, cache=..., cache_len=...)    -> chunk window
    decode_step(params, token, cache, cache_len[, block_table=...])
    verify_step(params, tokens, cache, cache_len[, block_table=...])
    init_cache(batch_size, capacity)                    -> zeroed stripes
    init_paged_cache(num_blocks, block_size)            -> zeroed pool

Batch dicts: train ``{"tokens": (B, S+1) int}``, prefill ``{"tokens":
(B, S) int}``, each plus ``"frames"`` (B, n_frames, d) for the audio
frontend or ``"patch_embeds"`` (B, n_patches, d) for the vision one
(the frontends' feature extractors are stubs, as in the reference);
decode ``token (B, 1)``.
Every tensor argument lies on the model's device. Caches (the paged
pool, or the per-slot stripes and recurrent state) are updated in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import attention, layers, transformer


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
    if cfg.encoder_layers:
        # rope == "learned" (whisper): the decoder's positions are the
        # computed sinusoid; only the encoder has a table
        blocks = transformer.init_block(gen, cfg, kind="dense",
                                        device=device,
                                        lead=(cfg.encoder_layers,))
        pos = torch.randn((cfg.n_frames, d), generator=gen,
                          dtype=torch.float32, device=device)
        p["encoder"] = {"blocks": blocks,
                        "final_norm": torch.ones((d,), dtype=dtype,
                                                 device=device),
                        "pos_embed": pos.mul_(0.02).to(dtype)}
    return p


def padded_vocab(cfg) -> int:
    """Embedding/head rows padded to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def _embed_tokens(p, cfg, tokens):
    return p["embed"][tokens.long()]


def _mrope_positions(B, n_patches, s_text, device):
    """M-RoPE position ids (B, 3, P + s_text) for one leading image: patch
    i at (0, i // g, i % g) on a g x g grid, text from g on all three."""
    g = max(int(n_patches ** 0.5), 1)
    pi = torch.arange(n_patches, device=device)
    patch = torch.stack([torch.zeros_like(pi), pi // g, pi % g])  # (3, P)
    ti = torch.arange(s_text, device=device) + g
    pos = torch.cat([patch, ti.expand(3, s_text)], dim=1)        # (3, P+S)
    return pos[None].expand(B, 3, pos.shape[1]).to(torch.int32)


def _positions_added(x, cfg, positions):
    """x plus the learned-rope sinusoid at ``positions``, in x's dtype."""
    if cfg.rope != "learned":
        return x
    return x + layers.sinusoidal_pos(positions, cfg.d_model, x.dtype)


def _build_inputs(p, cfg, batch, *, drop_last_token: bool):
    """Returns (x (B,S,d), extras, prefix, enc_kv) for a prefill or, with
    ``drop_last_token`` (the last token is only a label), a train step:
    the vision patches lead the text (``prefix`` of them) with their
    M-RoPE ids in ``extras``; the audio frames run the encoder, whose
    output every decoder layer projects to its cross K / V (``enc_kv``,
    stacked over L)."""
    tokens = batch["tokens"]
    if drop_last_token:
        tokens = tokens[:, :-1]
    B, S_text = tokens.shape
    extras, prefix, enc_kv = {}, 0, None
    x = _embed_tokens(p, cfg, tokens)
    if cfg.frontend == "vision":
        pe = batch["patch_embeds"].to(cfg.dtype)                # (B,P,d)
        x = torch.cat([pe, x], dim=1)
        prefix = pe.shape[1]
        extras["mrope_positions"] = _mrope_positions(B, prefix, S_text,
                                                     x.device)
    else:
        x = _positions_added(x, cfg, torch.arange(S_text,
                                                  device=x.device)[None])
    if cfg.frontend == "audio":
        enc = _run_encoder(p, cfg, batch["frames"].to(cfg.dtype))
        L = p["blocks"]["ln1"].shape[0]
        kvs = [attention.encode_cross_kv(
            enc, transformer._layer(p["blocks"]["xattn"], l), cfg)
            for l in range(L)]
        enc_kv = {key: torch.stack([kv[key] for kv in kvs])
                  for key in ("k", "v")}                         # (L,B,T,H,hd)
    return x, extras, prefix, enc_kv


def _run_encoder(p, cfg, frames):
    """The audio encoder: frames plus the position table, dense blocks
    attending without a mask (the flash kernel, non-causal, on CUDA
    tensors), then the final rmsnorm."""
    e = p["encoder"]
    x = frames + e["pos_embed"][None, : frames.shape[1], :]
    for l in range(e["blocks"]["ln1"].shape[0]):
        bp = transformer._layer(e["blocks"], l)
        hh = layers.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        o, _ = attention.attention_block(hh, bp["attn"], cfg, mode="train",
                                         causal=False, sliding_window=0)
        x = x + o
        hh = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + layers.mlp(hh, bp["ffn"], cfg.act)
    return layers.rmsnorm(x, e["final_norm"], cfg.norm_eps)


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

    # ---------------- train ----------------
    def train_loss(self, params, batch):
        """Next-token cross-entropy plus the summed MoE aux loss: batch
        ``{"tokens": (B, S+1)}`` (+ frames / patch embeds), the first S
        tokens in, ``tokens[:, 1:]`` the labels; a vision prefix is cut
        off before the logits. Returns (total, {"xent", "aux"}), f32
        scalars. Attention takes the flash kernel (and its backward) on
        CUDA tensors; with ``cfg.remat`` every layer is recomputed in the
        backward pass."""
        cfg = self.cfg
        x, extras, prefix, enc_kv = _build_inputs(params, cfg, batch,
                                                  drop_last_token=True)
        x, _, aux = transformer.apply_stack(x, params["blocks"], cfg,
                                            kind=transformer.block_kind(cfg),
                                            mode="train", extras=extras,
                                            enc_kv=enc_kv)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if prefix:
            x = x[:, prefix:, :]
        logits = _logits(params, cfg, x)
        loss = layers.softmax_xent(logits, batch["tokens"][:, 1:])
        if not torch.is_tensor(aux):       # no MoE layer: filled on the
            aux = torch.zeros_like(loss)   # device, no host copy (a sync)
        return loss + aux, {"xent": loss, "aux": aux}

    # ---------------- prefill ----------------
    def prefill(self, params, batch, *, last_idx=None, cache=None,
                cache_len=None, block_table=None, paged_kernel: bool = False,
                n_write=None):
        """last_idx: optional (B,) — per-row index of the last *real*
        text token when rows are right-padded to a shared bucket length
        (a vision prefix is added to it); None gives the logits at the
        final position. Returns (logits (B, 1, V), cache) with the fresh
        cache leaves stacked over L: k / v (L,B,S,Hkv,hd) [+ ssm_state
        (L,B,di,N), or the cross K / V xk / xv (L,B,n_frames,Hkv,hd)], or
        state (L,B,H,hd,hd) / last_x_t / last_x_c (L,B,d) for rwkv.

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
        x, extras, prefix, enc_kv = _build_inputs(params, cfg, batch,
                                                  drop_last_token=False)
        x, kv, _ = transformer.apply_stack(x, params["blocks"], cfg,
                                           kind=transformer.block_kind(cfg),
                                           mode="prefill", extras=extras,
                                           enc_kv=enc_kv)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        x_last = x[:, -1:, :] if last_idx is None \
            else _rows_at(x, last_idx + prefix)
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
        instead of the gather. The new token sits at position cache_len[b]
        for the learned sinusoid and on all three M-RoPE sections (the
        reference's numbering: after a vision prefix of P patches on a g
        x g grid, text prefilled from g continues from P + S_text)."""
        cfg = self.cfg
        B = token.shape[0]
        x = _embed_tokens(params, cfg, token)
        x = _positions_added(x, cfg, cache_len.reshape(-1, 1))
        extras = {"cache_len": cache_len, "block_table": block_table,
                  "paged_kernel": bool(paged_kernel)}
        if cfg.rope == "mrope":
            extras["mrope_positions"] = cache_len.to(torch.int32) \
                .reshape(-1, 1, 1).expand(B, 3, 1)
        x, new_cache, _ = transformer.apply_stack(
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
        B, S = tokens.shape
        idx = cache_len.reshape(-1)
        pos = idx[:, None] + torch.arange(S, device=idx.device)[None, :]
        x = _positions_added(_embed_tokens(params, cfg, tokens), cfg, pos)
        extras = {"cache_len": idx, "block_table": block_table,
                  "paged_kernel": bool(paged_kernel), "n_write": n_write}
        if cfg.rope == "mrope":
            extras["mrope_positions"] = pos[:, None, :].expand(
                B, 3, S).to(torch.int32)
        x, new_cache, _ = transformer.apply_stack(
            x, params["blocks"], cfg, kind=kind, mode="decode", cache=cache,
            extras=extras)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, new_cache

    # ---------------- cache ----------------
    def init_cache(self, batch_size: int, capacity: int):
        """Zeroed per-slot cache with room for ``capacity`` tokens: K/V
        stripes ``(L, B, capacity, Hkv, hd)`` in ``cfg.dtype`` [+ the
        cross K / V ``xk`` / ``xv`` ``(L, B, n_frames, Hkv, hd)``], the
        hybrid SSM state ``(L, B, di, N)`` in f32, or the rwkv state ``(L,
        B, H, hd, hd)`` in f32 with the token-shift carries ``(L, B,
        d)``."""
        cfg = self.cfg
        L, B = cfg.n_layers, batch_size
        Hkv, hd, d = cfg.n_kv_heads, cfg.hd, cfg.d_model
        kind = transformer.block_kind(cfg)

        def zeros(shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

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
        if kind == "decoder_x":
            cache["xk"] = zeros((L, B, cfg.n_frames, Hkv, hd))
            cache["xv"] = zeros((L, B, cfg.n_frames, Hkv, hd))
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
