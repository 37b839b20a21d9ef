"""Token sampling for the serving engine (PyTorch port of the reference
``serve/sampling.py``).

Three knobs per request (:class:`SamplingParams`): ``temperature`` (0
selects first-index argmax), ``top_k`` (0 keeps the whole vocabulary;
k keeps every token scoring at least the k-th value, ties included) and
``seed``. The key for a request's n-th emitted token is
``fold_in(fold_in(key(seed), TOKEN_STREAM), n)``: a pure function of the
seed and the emission index, so a sampled stream does not depend on
batch composition, layout or admission timing. The keys follow the
reference's ``jax.random`` stream bit for bit (:mod:`.prng`), so the
port draws the reference's tokens.

Every sample returns the raw ``log_softmax`` logprob of the chosen token
in float32 (before temperature / top-k shaping).

:class:`Rows` stages a batch's sampling parameters on the device
through :func:`stage`: a host-to-device copy from pageable memory
synchronises the stream, so the engine's step copies through pinned
memory and never waits for the device between its launches.

:func:`draft_propose` and :func:`speculative_accept` are the pure
draft-and-verify functions of the reference (acceptance sampling with
the residual correction). Proposals stay on the device: both take and
return device tensors, so a speculative round never reads a token back
to the host before its commit. A batch without a sampled row skips the
random draws (their results would be discarded by the greedy select).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.serve import prng

# fold_in tags separating the independent randomness streams a request
# consumes (token draws vs draft proposals vs accept/residual draws)
TOKEN_STREAM = 0
ACCEPT_STREAM = 1
DRAFT_STREAM = 2

_FMIN = float(np.finfo(np.float32).min)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. The default is greedy argmax."""
    temperature: float = 0.0
    top_k: int = 0                 # 0 = full vocabulary
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(dtype)


def stage(a, device) -> torch.Tensor:
    """A host array on ``device``. To a CUDA device the copy goes through
    pinned memory and does not wait for the stream (a pageable copy
    would synchronise it); the pinned buffer is a private copy, so the
    caller may mutate ``a`` right after."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def stream_keys(seeds, ctrs, stream: int):
    """Host keys ``fold_in(fold_in(key(seed), stream), ctr)`` per row."""
    return prng.fold_in(prng.fold_in(prng.key(_host(seeds, np.int32)),
                                     stream), _host(ctrs, np.int64))


class Rows:
    """One batch's per-row sampling parameters: host arrays, and for a
    batch with any sampled row the token-stream keys, temperatures and
    top-k values as device tensors, staged when the object is built.
    An all-greedy batch copies nothing."""

    def __init__(self, temps, top_ks, seeds, ctrs, device):
        temps = _host(temps, np.float32)
        top_ks = _host(top_ks, np.int64)
        self.sampled = bool((temps > 0.0).any())
        self.max_k = int(top_ks.max(initial=0))
        if self.sampled:
            k0, k1 = stream_keys(seeds, ctrs, TOKEN_STREAM)
            self.k0, self.k1, self.top_ks_t = stage(
                np.stack([k0, k1, top_ks]), device)
            self.temps_t = stage(temps, device)


def _shaped(x, temps_t, top_ks_t, max_k: int):
    """Temperature + top-k shaping of f32 logits ``x`` (N, V): divide by
    ``max(temp, 1e-6)``, then mask every value below the row's k-th
    largest to float32's minimum (``max_k``: the largest top-k of the
    batch, read on the host; a row with top-k 0 keeps everything)."""
    x = x / torch.clamp_min(temps_t, 1e-6)[:, None]
    if max_k <= 0:
        return x
    k = min(max_k, x.shape[-1])
    top = torch.topk(x, k, dim=-1).values                  # descending
    kth = top.gather(1, torch.clamp(top_ks_t - 1, 0, k - 1)[:, None])
    thresh = torch.where(top_ks_t[:, None] > 0, kth,
                         x.amin(-1, keepdim=True))
    return torch.where(x >= thresh, x, _FMIN)


def sample_rows(logits, rows: Rows):
    """Batched sampling of logits (B, V) under staged :class:`Rows`.
    Returns (tokens (B,) int32, logprobs (B,) f32) on the logits'
    device; launches only device work."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    tok = torch.argmax(logits, dim=-1)
    if rows.sampled:
        drawn = prng.categorical(rows.k0, rows.k1, _shaped(
            logits, rows.temps_t, rows.top_ks_t, rows.max_k))
        tok = torch.where(rows.temps_t > 0.0, drawn, tok)
    return tok.to(torch.int32), logp.gather(1, tok[:, None])[:, 0]


def sample(logits, temps, top_ks, seeds, ctrs):
    """Batched sampling: logits (B, V); temps / top_ks / seeds / ctrs (B,)
    (host arrays or tensors). Returns (tokens (B,) int32, logprobs (B,)
    f32 — raw log-softmax of the chosen token). Deterministic per (seed,
    ctr) pair."""
    return sample_rows(logits, Rows(temps, top_ks, seeds, ctrs,
                                    logits.device))


def _device_rows(temps, top_ks, device):
    top_ks = _host(top_ks, np.int64)
    return (stage(_host(temps, np.float32), device), stage(top_ks, device),
            int(top_ks.max(initial=0)))


def _keys_on(k, device):
    return stage(k[0], device), stage(k[1], device)


def draft_propose(logits, temps, top_ks, seeds, ctrs, pos):
    """Draw the draft model's proposal ``pos`` (0..k-1) of the round at
    emission counter ``ctrs``: logits (B, V) -> (tokens (B,) int32,
    probs (B, V) f32 — the shaped distribution each token was drawn
    from). The key stream is disjoint from the token draws and the
    accept / residual draws, and unique per (request, round, position).
    ``temps`` / ``top_ks`` / ``seeds`` / ``ctrs`` / ``pos`` are host
    arrays (or CPU tensors)."""
    dev = logits.device
    logits = logits.float()
    temps_t, top_ks_t, max_k = _device_rows(temps, top_ks, dev)
    shaped = _shaped(logits, temps_t, top_ks_t, max_k)
    tok = torch.argmax(logits, dim=-1)
    if (_host(temps, np.float32) > 0.0).any():
        k = prng.fold_in(stream_keys(seeds, ctrs, DRAFT_STREAM),
                         _host(pos, np.int64))
        drawn = prng.categorical(*_keys_on(k, dev), shaped)
        tok = torch.where(temps_t > 0.0, drawn, tok)
    return tok.to(torch.int32), torch.softmax(shaped, dim=-1)


def speculative_accept(target_logits, draft_probs, proposed, n_spec,
                       temps, top_ks, seeds, ctrs):
    """Batched draft-and-verify acceptance.

    target_logits (B, S, V) from the multi-token verify step;
    draft_probs (B, S-1, V) shaped draft distributions; proposed
    (B, S-1) draft tokens (a device tensor is used where it lies, a host
    array staged); n_spec (B,) proposals actually speculated per row (a
    rider, n_spec 0, gets one token-stream draw back). Returns
    (accepted (B,) int32, tokens (B, S) int32, logprobs (B, S) f32): row
    b commits ``tokens[b, :accepted[b]+1]``. Greedy rows accept while
    the proposal equals the target argmax; sampled rows accept ``d_j``
    with probability ``min(1, p(d_j) / q(d_j))`` and on a rejection draw
    the correction from ``normalize(max(p - q, 0))``."""
    dev = target_logits.device
    tl = target_logits.float()
    B, S, V = tl.shape
    k = S - 1
    dprobs = draft_probs.float().to(dev)
    if isinstance(proposed, torch.Tensor) and proposed.device == dev:
        proposed = proposed.long()
    else:
        proposed = stage(_host(proposed, np.int64), dev)
    n_spec = stage(_host(n_spec, np.int64), dev)
    sampled = bool((_host(temps, np.float32) > 0.0).any())
    temps_t, top_ks_t, max_k = _device_rows(temps, top_ks, dev)
    tgt_argmax = torch.argmax(tl, dim=-1)                          # (B, S)
    j = torch.arange(k, device=dev)
    ok = proposed == tgt_argmax[:, :k]
    if sampled:
        greedy = temps_t <= 0.0
        shaped = _shaped(tl.reshape(B * S, V), temps_t.repeat_interleave(S),
                         top_ks_t.repeat_interleave(S),
                         max_k).reshape(B, S, V)
        p = torch.softmax(shaped, dim=-1)
        q_at = dprobs.gather(-1, proposed[..., None])[..., 0]
        p_at = p[:, :k].gather(-1, proposed[..., None])[..., 0]
        acc = stream_keys(seeds, ctrs, ACCEPT_STREAM)
        u = prng.uniform(prng.bits(*_keys_on(acc, dev), k))
        ok = torch.where(greedy[:, None], ok, u * q_at <= p_at)
    ok &= j[None] < n_spec[:, None]
    a = torch.cumprod(ok.to(torch.int64), dim=-1).sum(-1)          # (B,)
    rows = torch.arange(B, device=dev)
    bonus = tgt_argmax[rows, a]
    if sampled:
        p_a = p[rows, a]
        rejected = a < n_spec
        q_a = dprobs[rows, torch.clamp_max(a, k - 1)]
        resid = torch.clamp_min(p_a - q_a, 0.0)
        norm = resid.sum(-1)
        resid = torch.where((rejected & (norm > 0.0))[:, None],
                            resid / torch.clamp_min(norm, 1e-20)[:, None],
                            p_a)
        bonus_sampled = prng.categorical(
            *_keys_on(prng.fold_in(acc, k), dev),
            torch.log(torch.clamp_min(resid, 1e-30)))
        rider_draw = prng.categorical(
            *_keys_on(stream_keys(seeds, ctrs, TOKEN_STREAM), dev),
            shaped[:, 0])
        bonus = torch.where(greedy, bonus,
                            torch.where(n_spec == 0, rider_draw,
                                        bonus_sampled))
    pos = torch.arange(S, device=dev)[None]
    ext = torch.cat([proposed, proposed[:, -1:]], dim=1)
    tokens = torch.where(pos < a[:, None], ext,
                         torch.where(pos == a[:, None], bonus[:, None], 0))
    logprobs = torch.log_softmax(tl, dim=-1).gather(
        -1, tokens[..., None])[..., 0]
    return a.to(torch.int32), tokens.to(torch.int32), logprobs
