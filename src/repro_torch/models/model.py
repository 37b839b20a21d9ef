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
    input_specs(shape)                                  -> meta stand-ins
    init_paged_cache(num_blocks, block_size)            -> zeroed pool

Batch dicts: train ``{"tokens": (B, S+1) int}``, prefill ``{"tokens":
(B, S) int}``, each plus ``"frames"`` (B, n_frames, d) for the audio
frontend or ``"patch_embeds"`` (B, n_patches, d) for the vision one
(the frontends' feature extractors are stubs, as in the reference);
decode ``token (B, 1)``.
Every tensor argument lies on the model's device. Caches (the paged
pool, or the per-slot stripes and recurrent state) are updated in
place.

Each method takes ``plan=`` (a ``repro_torch.sharding.rules.
ParallelPlan``; None, or a plan without a mesh, is the one-device path).
Under a plan the params may be DTensors (``plan.param_shardings``) or
whole plain tensors. A DTensor input (a train batch placed by
``batch_spec``, a decode cache placed by ``cache_spec``) splits the
call's batch rows over the axes it is sharded on: each rank computes
its rows, and the logits come back whole on every rank. Plain inputs
are whole on every rank, and every rank computes every row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import attention, layers, transformer
from repro_torch.sharding.rules import DTensor


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


def _embed_tokens(p, cfg, tokens, plan=None):
    if plan is not None:
        return plan.embed(p["embed"], tokens.long())
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


def _build_inputs(p, cfg, batch, *, drop_last_token: bool, plan=None):
    """Returns (x (B,S,d), extras, prefix, enc_kv) for a prefill or, with
    ``drop_last_token`` (the last token is only a label), a train step:
    the vision patches lead the text (``prefix`` of them) with their
    M-RoPE ids in ``extras``; the audio frames run the encoder, whose
    output every decoder layer projects to its cross K / V (``enc_kv``,
    stacked over L). Under ``plan`` the embedding is vocab-parallel and
    the cross projections are gathered whole."""
    tokens = batch["tokens"]
    if drop_last_token:
        tokens = tokens[:, :-1]
    B, S_text = tokens.shape
    extras, prefix, enc_kv = {}, 0, None
    x = _embed_tokens(p, cfg, tokens, plan)
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
        xattn = [transformer._layer(p["blocks"]["xattn"], l)
                 for l in range(L)]
        if plan is not None:
            xattn = [plan.gather_tree(t) for t in xattn]
        kvs = [attention.encode_cross_kv(enc, t, cfg) for t in xattn]
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


def _logits(p, cfg, x, plan=None):
    """x @ the output head, padded ids masked; under ``plan`` the head is
    vocab-parallel (column-parallel, the logits gathered)."""
    def head(a):
        if cfg.tie_embeddings:
            e = p["embed"] if plan is None else plan.gather(p["embed"])
            return a @ e.T
        if plan is None:
            return a @ p["lm_head"]
        return plan.col_linear(a, p["lm_head"])

    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        # one row would take a matrix-vector product, which sums in
        # another order than the matrix product of a batch: a request
        # prefilled alone would emit logprobs an ulp off its co-batched
        # run. Two rows keep a row's logits independent of its batch.
        out = head(rows.expand(2, -1))[:1].reshape(*x.shape[:-1], -1)
    else:
        out = head(x)
    vp = out.shape[-1]
    if vp != cfg.vocab_size:          # padded ids can never be sampled
        pad = torch.arange(vp, device=out.device) >= cfg.vocab_size
        out = out.masked_fill(pad, -1e9)
    return out


def _rows_at(x, idx):
    """x (B, S, d), idx (B,) -> x[b, idx[b]] as (B, 1, d)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx.long()][:, None, :]


def _planned(plan) -> bool:
    return plan is not None and plan.mesh is not None


def _whole_outside_layers(params, plan):
    """The params a call uses outside the layer loop whole on this rank,
    but for the embedding and the head (vocab-parallel bodies)."""
    out = dict(params)
    for k in ("final_norm", "encoder"):
        if k in out:
            out[k] = plan.gather_tree(out[k])
    return out


def _split_rows(plan, lead, dim: int):
    """``plan`` bound to the mesh axes dim ``dim`` of ``lead`` (a DTensor
    input, or None) is sharded over, with a function that takes this
    rank's rows of a per-row tensor, whole or a DTensor."""
    rows = plan.shard_of(lead, dim)[0] if isinstance(lead, DTensor) else ()
    plan = plan.bind(rows)

    def mine(t):
        if isinstance(t, DTensor):      # placed by batch_spec: its rows
            return plan.local_block(t, plan._rows_spec(t.ndim))
        if not rows or t is None or t.ndim == 0:
            return t
        n = t.shape[0] // plan.axis_size(rows)
        i = plan.flat_index(rows)
        return t[i * n:(i + 1) * n]

    return plan, mine


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


# ===================================================================== model
@dataclass(frozen=True)
class Model:
    cfg: Any
    device: torch.device

    def init(self, seed: int = 0):
        return init_params(self.cfg, seed, device=self.device)

    # ---------------- train ----------------
    def train_loss(self, params, batch, plan=None):
        """Next-token cross-entropy plus the summed MoE aux loss: batch
        ``{"tokens": (B, S+1)}`` (+ frames / patch embeds), the first S
        tokens in, ``tokens[:, 1:]`` the labels; a vision prefix is cut
        off before the logits. Returns (total, {"xent", "aux"}), f32
        scalars. Attention takes the flash kernel (and its backward) on
        CUDA tensors; with ``cfg.remat`` every layer is recomputed in the
        backward pass.

        Under a plan each rank takes the loss of its rows (a batch placed
        by ``batch_spec``) and the mean over the row axes is every
        rank's loss; MoE layers run their expert- / tensor-parallel
        bodies."""
        cfg = self.cfg
        if _planned(plan):
            plan, _ = _split_rows(plan, batch["tokens"], 0)
            batch = {k: _local(v) for k, v in batch.items()}
            params = _whole_outside_layers(params, plan)
        else:
            plan = None
        x, extras, prefix, enc_kv = _build_inputs(params, cfg, batch,
                                                  drop_last_token=True,
                                                  plan=plan)
        x, _, aux = transformer.apply_stack(x, params["blocks"], cfg,
                                            kind=transformer.block_kind(cfg),
                                            mode="train", extras=extras,
                                            enc_kv=enc_kv, plan=plan)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if prefix:
            x = x[:, prefix:, :]
        logits = _logits(params, cfg, x, plan)
        loss = layers.softmax_xent(logits, batch["tokens"][:, 1:])
        if plan is not None and plan.rows:
            loss = plan.pmean(loss, plan.rows)
        if not torch.is_tensor(aux):       # no MoE layer: filled on the
            aux = torch.zeros_like(loss)   # device, no host copy (a sync)
        return loss + aux, {"xent": loss, "aux": aux}

    # ---------------- prefill ----------------
    def prefill(self, params, batch, *, last_idx=None, cache=None,
                cache_len=None, block_table=None, paged_kernel: bool = False,
                n_write=None, plan=None):
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
        only each row's ``last_idx`` position's logits as (B, 1, V).

        Under a plan, a batch placed by ``batch_spec`` returns its fresh
        cache leaves as DTensors split over the same rows (dim 1)."""
        cfg = self.cfg
        if cache is not None:
            return self._window(params, batch["tokens"], cache, cache_len,
                                block_table, paged_kernel, n_write, plan,
                                last_idx)
        mine = None
        if _planned(plan):
            plan, mine = _split_rows(plan, batch["tokens"], 0)
            batch = {k: _local(v) for k, v in batch.items()}
            last_idx = mine(last_idx)
            params = _whole_outside_layers(params, plan)
        else:
            plan = None
        x, extras, prefix, enc_kv = _build_inputs(params, cfg, batch,
                                                  drop_last_token=False,
                                                  plan=plan)
        x, kv, _ = transformer.apply_stack(x, params["blocks"], cfg,
                                           kind=transformer.block_kind(cfg),
                                           mode="prefill", extras=extras,
                                           enc_kv=enc_kv, plan=plan)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        x_last = x[:, -1:, :] if last_idx is None \
            else _rows_at(x, last_idx + prefix)
        logits = _logits(params, cfg, x_last, plan)
        if plan is not None and plan.rows:
            logits = plan.all_gather(logits, 0, plan.rows)
            kv = {k: plan.act_dtensor(v, 1) for k, v in kv.items()}
        return logits, kv

    # ---------------- decode ----------------
    def decode_step(self, params, token, cache, cache_len, block_table=None,
                    paged_kernel: bool = False, plan=None):
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
        x g grid, text prefilled from g continues from P + S_text).

        Under a plan a stripe cache placed by ``cache_spec`` splits the
        rows over its batch axes; sequence-sharded stripes decode
        flash-decoding style, head- / channel-sharded recurrent state on
        this rank's heads / channels. A paged pool and plain stripes are
        whole on every rank."""
        cfg = self.cfg
        if _planned(plan):
            lead = next((v for v in cache.values()
                         if isinstance(v, DTensor)), None)
            plan, mine = _split_rows(plan, lead, 1)
            token = mine(token)
            if cache_len.ndim and cache_len.numel() > 1:
                cache_len = mine(cache_len.reshape(-1))
            params = _whole_outside_layers(params, plan)
        else:
            plan = None
        B = token.shape[0]
        x = _embed_tokens(params, cfg, token, plan)
        x = _positions_added(x, cfg, cache_len.reshape(-1, 1))
        extras = {"cache_len": cache_len, "block_table": block_table,
                  "paged_kernel": bool(paged_kernel)}
        if cfg.rope == "mrope":
            extras["mrope_positions"] = cache_len.to(torch.int32) \
                .reshape(-1, 1, 1).expand(B, 3, 1)
        x, new_cache, _ = transformer.apply_stack(
            x, params["blocks"], cfg, kind=transformer.block_kind(cfg),
            mode="decode", cache=cache, extras=extras, plan=plan)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = _logits(params, cfg, x, plan)
        if plan is not None and plan.rows:
            logits = plan.all_gather(logits, 0, plan.rows)
        return logits, new_cache

    # ---------------- verify (multi-token decode) ----------------
    def verify_step(self, params, tokens, cache, cache_len, block_table=None,
                    paged_kernel: bool = False, n_write=None, plan=None):
        """Multi-token decode: tokens (B, S) at positions ``cache_len[b] +
        [0, S)``; query j sees cache positions <= cache_len[b] + j, so
        ``logits[:, j]`` equals what the j+1-th of S sequential
        :meth:`decode_step` calls would produce. ``n_write`` (B,) caps
        how many window positions row b writes into its own blocks (the
        rest divert to scratch). Returns (logits (B, S, V), pool)."""
        return self._window(params, tokens, cache, cache_len, block_table,
                            paged_kernel, n_write, plan)

    def _window(self, params, tokens, cache, cache_len, block_table,
                paged_kernel, n_write, plan=None, last_idx=None):
        """Shared multi-token window body (verify / chunked prefill):
        returns the logits (B, S, V), or only each row's ``last_idx``
        position's as (B, 1, V), and the pool. Under a plan a window
        needs a cache whole on every rank."""
        cfg = self.cfg
        kind = transformer.block_kind(cfg)
        if kind in ("rwkv", "hybrid"):
            raise ValueError(f"multi-token window unsupported for family "
                             f"{kind!r} (recurrent state is sequential)")
        if _planned(plan):
            if any(isinstance(v, DTensor) for v in cache.values()):
                raise ValueError("a multi-token window needs a cache whole "
                                 "on every rank, not one placed by "
                                 "cache_spec")
            plan = plan.bind(())
            params = _whole_outside_layers(params, plan)
        else:
            plan = None
        B, S = tokens.shape
        idx = cache_len.reshape(-1)
        pos = idx[:, None] + torch.arange(S, device=idx.device)[None, :]
        x = _positions_added(_embed_tokens(params, cfg, tokens, plan), cfg,
                             pos)
        extras = {"cache_len": idx, "block_table": block_table,
                  "paged_kernel": bool(paged_kernel), "n_write": n_write}
        if cfg.rope == "mrope":
            extras["mrope_positions"] = pos[:, None, :].expand(
                B, 3, S).to(torch.int32)
        x, new_cache, _ = transformer.apply_stack(
            x, params["blocks"], cfg, kind=kind, mode="decode", cache=cache,
            extras=extras, plan=plan)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if last_idx is not None:
            x = _rows_at(x, last_idx)
        return _logits(params, cfg, x, plan), new_cache

    # ---------------- shape stand-ins ----------------
    def input_specs(self, shape) -> dict:
        """Meta stand-ins of a step's inputs for the dry-run, at the
        reference's shapes and dtypes (no allocation): ``{"batch"}`` for
        train (tokens (B, S + 1)) and prefill (tokens (B, S)), the vision
        frontend's patch prefix taking its share of S and the audio
        frontend's frames beside; for decode, one token against a cache
        of capacity S (:meth:`init_cache` on meta) and a scalar
        ``cache_len``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def spec(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            n = S + (shape.kind == "train")
            batch = {"tokens": spec((B, n))}
            if cfg.frontend == "vision":
                batch["tokens"] = spec((B, n - cfg.n_patches))
                batch["patch_embeds"] = spec((B, cfg.n_patches, cfg.d_model),
                                             cfg.dtype)
            if cfg.frontend == "audio":
                batch["frames"] = spec((B, cfg.n_frames, cfg.d_model),
                                       cfg.dtype)
            return {"batch": batch}
        meta = Model(cfg, torch.device("meta"))
        return {"token": spec((B, 1)), "cache": meta.init_cache(B, S),
                "cache_len": spec(())}

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
