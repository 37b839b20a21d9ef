"""DraftRunner: the small proposer model inside a speculative engine.

One runner owns the draft model's decode state for every engine slot: a
**fixed-stripe** cache (``draft_model.init_cache(B, max_seq)``). Stripe
rollback is free: truncate the valid length; junk past it is never
attended and is overwritten by the next write at that position.

Per speculative round the runner ingests, batched across slots, each
proposing row's **catch-up tokens** (committed tokens the draft has not
cached yet) in ONE chunked-prefill window call, then runs exactly ``k``
**proposal** draws (stripe decode steps). Rows not proposing this round
ride the batch feeding token 0; their writes land past their own valid
stripe extent, or past ``max_seq``, where the stripe write drops them.
Proposals are drawn with the request's sampling params from a dedicated
key stream, and every proposal's shaped distribution is returned for
acceptance sampling.

The proposals stay on the device: each draw feeds the next decode step
as a tensor, and :meth:`propose` returns them as a ``(B, k)`` tensor, so
a round launches its work without reading anything back to the host.
On CUDA tensors every proposal step's attention goes through the
stripe-decode kernel; the catch-up window stays plain torch (a stripe
chunk window). ``steps_run`` counts both, as the reference's does;
``ingest_steps`` counts the windows alone, ``admit_calls`` the batched
prefill calls of admission (on CUDA tensors each runs the flash kernel
once per draft layer).

The engine owns commit / rollback: after acceptance it calls
:meth:`commit` with the new valid draft length, and :meth:`reset` when a
slot retires or is preempted.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve import sampling
from repro_torch.serve.telemetry import NOOP, PID_LOOP

_MIN_BUCKET = 8     # matches the engine's smallest prefill bucket


class DraftRunner:
    def __init__(self, model, params, *, batch_size: int, max_seq: int,
                 tracer=None):
        self.model = model
        self.params = params
        self.device = model.device
        self.B = batch_size
        self.max_seq = max_seq
        self.tracer = NOOP if tracer is None else tracer
        leaves = sorted(model.init_cache(1, _MIN_BUCKET))
        if not set(leaves) <= {"k", "v"}:
            # rollback is truncate-only: recurrent state has no positions
            # to truncate, so rejected proposals would corrupt it
            raise ValueError("draft model must have a pure-attention "
                             "{k, v} cache (rollback is truncate-only); "
                             f"got leaves {leaves}")
        self.caches = model.init_cache(batch_size, max_seq)
        self.len = np.zeros(batch_size, np.int32)   # valid cached tokens
        self.steps_run = 0                          # draft model calls
        self.ingest_steps = 0                       # of them catch-up windows
        self.admit_calls = 0                        # batched prefill calls

    def _dev(self, a) -> torch.Tensor:
        return sampling.stage(a, self.device)

    # --------------------------------------------------------- admission
    def admit(self, members: list) -> None:
        """Prefill the draft cache for freshly admitted slots. ``members``:
        list of (slot, prompt tokens). Prompts group by the engine's
        power-of-two bucket and each group prefills as one batched call,
        its rows copied into their stripes in place."""
        # the ENGINE's bucket rule, imported lazily (the engine imports
        # this module): draft prefill shapes track the target's
        from repro_torch.serve.engine import _bucket
        groups: dict = {}
        for slot, eff in members:
            groups.setdefault(_bucket(len(eff), self.max_seq), []).append(
                (slot, eff))
        for width, group in groups.items():
            toks = np.zeros((len(group), width), np.int32)
            last = np.zeros(len(group), np.int32)
            for j, (slot, eff) in enumerate(group):
                toks[j, :len(eff)] = eff
                last[j] = len(eff) - 1
            _, pref = self.model.prefill(self.params,
                                         {"tokens": self._dev(toks)},
                                         last_idx=self._dev(last))
            for j, (slot, _) in enumerate(group):
                for key, cache in self.caches.items():
                    cache[:, slot, :width] = pref[key][:, j]
            self.admit_calls += 1
        for slot, eff in members:
            self.len[slot] = len(eff)

    # --------------------------------------------------------- proposals
    def propose(self, tails: list, rows: list, k: int, temps, top_ks,
                seeds, ctrs):
        """Catch-up + propose ``k`` tokens for each slot in ``rows``.

        tails[i]: the committed tokens slot i's draft cache has NOT seen
        yet, ending with the newest committed token (never empty for a
        proposing row; None for the rest). ``temps`` / ``top_ks`` /
        ``seeds`` / ``ctrs``: (B,) host arrays of the slots' sampling
        params. Returns (proposed (B, k) int32, draft_probs (B, k, V)
        f32), both on the device; rows not in ``rows`` propose 0.

        All catch-up except each row's last token lands in ONE chunked
        ingest call, so a round costs ``1 + k`` draft calls however far
        the draft fell behind; the last catch-up token then draws the
        first proposal."""
        from repro_torch.serve.engine import _bucket   # lazy, as in admit
        B, L = self.B, self.len
        catch = np.ones(B, np.int64)
        for i in rows:
            catch[i] = len(tails[i])
            assert catch[i] >= 1, (i, int(L[i]))
        pre = int(max(catch[i] for i in rows)) - 1
        if pre > 0:
            W = _bucket(pre, self.max_seq)
            toks = np.zeros((B, W), np.int32)
            for i in rows:
                toks[i, :catch[i] - 1] = tails[i][:-1]
            # logits discarded: the draft only needs the cache, so only
            # position 0 is projected (last_idx 0)
            self.model.prefill(self.params, {"tokens": self._dev(toks)},
                               cache=self.caches,
                               cache_len=self._dev(L.astype(np.int32)),
                               last_idx=self._dev(np.zeros(B, np.int32)))
            for i in rows:
                L[i] += catch[i] - 1        # caches valid through the ingest
            self.steps_run += 1
            self.ingest_steps += 1
        first = np.zeros((B, 1), np.int32)
        mask = np.zeros((B, 1), bool)
        for i in rows:
            first[i, 0] = tails[i][-1]      # draws the first proposal
            mask[i, 0] = True
        tok = self._dev(first)
        mask = self._dev(mask)
        lens = self._dev(L.astype(np.int32))
        proposed, probs_steps = [], []
        for t in range(k):
            logits, _ = self.model.decode_step(self.params, tok, self.caches,
                                               lens + t)
            nxt, probs = sampling.draft_propose(
                logits[:, -1, :], temps, top_ks, seeds, ctrs,
                np.full(B, t, np.int32))
            tok = torch.where(mask, nxt[:, None], 0)
            proposed.append(tok)
            probs_steps.append(probs)
        self.steps_run += k
        if self.tracer.enabled:
            self.tracer.instant("draft_propose", pid=PID_LOOP,
                                args={"rows": len(rows), "k": k,
                                      "catchup_tokens": int(pre)})
        return torch.cat(proposed, dim=1), torch.stack(probs_steps, dim=1)

    # ------------------------------------------------------- bookkeeping
    def commit(self, slot: int, valid_len: int) -> None:
        """The draft's cache for ``slot`` is valid through ``valid_len``
        committed tokens (past it: a rejected proposal's KV, overwritten
        by the next catch-up write at that position)."""
        self.len[slot] = min(valid_len, self.max_seq)

    def reset(self, slot: int) -> None:
        self.len[slot] = 0
