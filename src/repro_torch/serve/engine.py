"""Slot-native serving engine (PyTorch port of the reference
``serve/engine.py``): a paged block-pool KV cache for pure-attention
families, fixed per-slot stripes for the recurrent ones.

The engine slots requests into a fixed-capacity batch (one slot per
sequence). Two cache layouts:

* **Stripes** (``paged=False``; the only layout for rwkv / hybrid,
  whose recurrent state is O(1) in sequence length): every slot owns a
  ``max_seq``-token K/V stripe and / or its recurrent state. Admission
  is gated on free slots alone; a group's batched prefill is copied into
  its slots on device. Recurrent prompts co-batch by exact length only
  (their state cannot absorb pad tokens) and never chunk.
* **Paged** (the default for pure-attention families): KV memory is a
  shared :class:`~repro_torch.serve.blocks.BlockPool` of ``num_blocks x
  block_size`` tokens per layer; a slot holds only the blocks its
  sequence needs, mapped through a per-slot block table. Admission is
  gated on blocks. Decode grows a slot's table lazily as it crosses
  block boundaries; on exhaustion the slot **parks** (skips token
  emission, state intact) until another request frees blocks, and if
  every active slot is parked the newest admission is **preempted**
  (blocks freed, request re-queued for recompute re-admission).

On the paged layout:

* **Prefix sharing + copy-on-write** (``prefix_sharing=True``):
  admission walks the prompt through the pool's prefix index and
  acquires blocks already holding that content; the request prefills
  only its un-shared suffix. A shared block is read-only; the first
  append into a shared tail duplicates it on device first.
* **Kernel reads** (``use_kernel=True``): the paged attention read runs
  ``kernels.paged_attention`` — the CUDA paged-window kernel on the
  card, its plain version on CPU tensors — instead of the gather path.
* **Chunked prefill** (``prefill_chunk``, default 64): a prompt longer
  than the chunk admits with its first chunk only; the rest feeds
  through chunk windows (multi-token steps) in which decode slots ride
  with their single next token.

With ``speculation=k`` (and a draft model) the engine decodes
**speculatively**: each step a :class:`~repro_torch.serve.spec.DraftRunner`
proposes k tokens per slot and the target verifies them in ONE
multi-token step (``model.verify_step``), committing the accepted prefix
plus a bonus / correction token. Paged slots are granted their window
blocks up front (the **watermark**; copy-on-write where shared, degraded
under pressure) and rolled back to the committed length afterwards;
greedy streams are bit-identical to non-speculative decode. The draft's
proposals stay on the device: the verify window is the host's first
column concatenated with the proposal tensor, so ``dispatch_step``
waits for nothing and only the tick's commit reads the results.

Dense (non-MoE) pure-attention prompts are right-padded to power-of-two
buckets; pad positions are never attended and pad tail blocks are never
allocated. MoE targets prefill one row a call at its exact length
(capacity routing shares per-expert slots across a call's tokens, so
pad tokens or co-batched rows could displace a request's own), never
share prefixes, never chunk and never speculate.

Device work is launched by :meth:`ServingEngine.dispatch_step` on the
current CUDA stream (PyTorch returns before the device finishes); the
returned tick's ``commit()`` is the host sync (``.cpu()``) followed by
the per-slot bookkeeping. Caches are updated in place. Admission,
dispatch and commit run under ``torch.no_grad()``: params fresh from a
train step (or any that require grad) serve as detached ones would, and
no kernel without a backward sees a recorded call.

Sampled rows (temperature / top-k) draw from the reference's counter-
based key streams (:mod:`.sampling`). Every host array a step sends to
the card goes through pinned memory without a stream sync, so
``dispatch_step`` returns while the device still computes.

Models with a frontend (audio frames, vision patches) are refused at
construction: a request carries tokens only.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.moe import span_hook
from repro_torch.serve import sampling
from repro_torch.serve.blocks import BlockPool
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.spec import DraftRunner
from repro_torch.serve.telemetry import (NOOP, PID_ENGINE, PID_LOOP, PID_POOL,
                                         PID_REQUESTS, LayerSpans)
from repro_torch.sharding.rules import DTensor

_MIN_BUCKET = 8
# default chunk for chunked prefill (tokens per slot per chunk step)
DEFAULT_PREFILL_CHUNK = 64


@dataclass
class Request:
    rid: int
    prompt: list                    # token ids
    max_new_tokens: int = 8
    stop_tokens: tuple = ()         # EOS ids -> early exit
    priority: int = 0               # scheduler tier (higher = more urgent)
    deadline_s: float | None = None  # absolute SLO deadline on the clock
    sampling: SamplingParams = GREEDY   # greedy | temperature | top-k
    speculation: int | None = None  # draft tokens/step; None = engine
    #                                 default, 0 = opt out of speculation
    prefill_chunk: int | None = None  # per-request chunk width override
    #                                 (None = engine default)
    out_tokens: list = field(default_factory=list)
    out_logprobs: list = field(default_factory=list)  # raw log-softmax of
    #                                 each emitted token, 1:1 with out_tokens
    submitted_s: float = field(default_factory=time.perf_counter)
    done_s: float | None = None
    preemptions: int = 0            # times evicted for recompute readmission
    admitted_s: float | None = None     # first engine-slot admission
    first_token_s: float | None = None  # first *generated* token commit

    @property
    def latency_s(self) -> float:
        return (self.done_s or time.perf_counter()) - self.submitted_s

    @property
    def finished_by_stop(self) -> bool:
        return bool(self.out_tokens) and self.out_tokens[-1] in self.stop_tokens


def _bucket(n: int, cap: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, cap)


class _Tick:
    """One **dispatched** engine step: the device work is launched, the
    host-side bookkeeping is deferred to :meth:`commit`. Between
    ``dispatch_step()`` and ``commit()`` the engine's host state must be
    treated as read-only. Commit is one-shot."""

    __slots__ = ("_commit", "_spans")

    def __init__(self, commit_fn, spans):
        self._commit = commit_fn
        self._spans = spans

    @torch.no_grad()
    def commit(self) -> list:
        """Synchronize on the device results, run the per-slot
        bookkeeping, and return the finished requests. Traced, the
        engine's device spans then take the tick's anchor (see
        :class:`~repro_torch.serve.telemetry.DeviceSpans`)."""
        fn, self._commit = self._commit, None
        if fn is None:
            raise RuntimeError("tick already committed")
        out = fn()
        if self._spans is not None:
            self._spans.commit()
        return out


def _host(t) -> np.ndarray:
    """Device result -> host numpy: the sync point of a tick."""
    return t.cpu().numpy()


class ServingEngine:
    def __init__(self, model, params, *, batch_size: int = 4,
                 max_seq: int = 256, paged: bool | None = None,
                 block_size: int = 16, num_blocks: int | None = None,
                 reserve_blocks: int = 1, prefix_sharing: bool = True,
                 use_kernel: bool = False, draft_model=None,
                 draft_params=None, speculation: int = 0,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 clock=time.perf_counter, tracer=None, device="cuda",
                 plan=None):
        self.device = torch.device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"engine device {self.device} != model device "
                             f"{model.device}")
        if model.cfg.frontend != "none":
            # the reference's engine takes such a model and fails at its
            # first admission, when the prefill finds no frames / patches
            raise ValueError(f"{model.cfg.name}: the {model.cfg.frontend} "
                             "frontend needs frames or patch embeds, and "
                             "engine requests carry tokens only")
        self.model = model
        self.params = params
        # a ParallelPlan goes into every model call, as in the reference;
        # the caches and the pool stay whole on every rank
        self.plan = plan
        self.B = batch_size
        self.max_seq = max_seq
        self.clock = clock
        # span/event recorder; every emission site guards on .enabled
        self.tracer = NOOP if tracer is None else tracer
        # traced: this engine's device spans (its own, whoever else
        # shares the tracer) and the MoE FFN's hook over them
        self._spans = self.tracer.device_spans(self.device.type == "cuda") \
            if self.tracer.enabled else None
        self._moe_spans = LayerSpans(self._spans, "moe-ffn") \
            if self.tracer.enabled else None
        # dispatch_step() calls so far: the number of the tick that a
        # fill's admissions and the next dispatch belong to
        self.ticks = 0
        # the port's own counters, beside the reference's ``metrics``:
        # positions the prefill calls computed (rows x width) and the
        # padding among them
        self.counters = {"prefill_calls": 0, "prefill_call_tokens": 0,
                         "prefill_pad_tokens": 0}
        leaves = sorted(model.init_cache(1, _MIN_BUCKET))
        pure_attn = set(leaves) <= {"k", "v"}
        # MoE routing shares one per-expert capacity over a call's (rows x
        # tokens), so pad tokens / co-batched rows can displace a request's
        # own tokens: MoE prompts prefill one row a call, exact length
        is_moe = bool(getattr(model.cfg, "n_experts", 0))
        # pure-attention caches tolerate right-padded prompts (pad KV is
        # masked, then overwritten); recurrent state does not
        self._paddable = pure_attn and not is_moe
        self._solo_prefill = is_moe
        # recurrent state is O(1) in sequence length: paging buys nothing
        self.paged = pure_attn if paged is None else bool(paged)
        if self.paged and not pure_attn:
            raise ValueError("paged KV requires a pure-attention {k, v} "
                             f"cache; got leaves {leaves}")
        # a shared admission's catch-up tokens decode co-batched, which is
        # bit-exact for dense / GQA but not for MoE (the capacity caveat)
        self.prefix_sharing = bool(prefix_sharing) and self.paged \
            and not is_moe
        self.use_kernel = bool(use_kernel)
        if prefill_chunk is not None and prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1, got "
                             f"{prefill_budget}")
        # chunk windows need the multi-token {k, v} window: recurrent
        # state steps token at a time
        if self._paddable:
            self.prefill_chunk = DEFAULT_PREFILL_CHUNK \
                if prefill_chunk is None else int(prefill_chunk)
        elif prefill_chunk:
            raise ValueError("chunked prefill requires a paddable "
                             "pure-attention non-MoE cache")
        else:
            self.prefill_chunk = 0
        # per-step cap on pending prompt tokens fed across slots
        self.prefill_budget = prefill_budget
        # speculative draft-and-verify: pure-attention targets only (the
        # verify window needs the {k, v} scatter) and never MoE (the
        # window co-batches k + 1 tokens through shared expert capacity)
        self.spec_k = int(speculation)
        if self.spec_k:
            if draft_model is None or draft_params is None:
                raise ValueError("speculation requires a draft model")
            if not pure_attn:
                raise ValueError("speculation requires a pure-attention "
                                 f"{{k, v}} cache; got {leaves}")
            if is_moe:
                raise ValueError("speculation unsupported for MoE targets "
                                 "(expert-capacity caveat)")
            if draft_model.device.type != self.device.type:
                raise ValueError(f"draft model device {draft_model.device} "
                                 f"!= engine device {self.device}")
            self.draft = DraftRunner(draft_model, draft_params,
                                     batch_size=batch_size, max_seq=max_seq,
                                     tracer=self.tracer)
        else:
            self.draft = None
        self.slot_len = np.zeros(batch_size, np.int32)   # tokens in cache
        self.slot_req: list = [None] * batch_size
        # prompt tokens an admission still owes the model (chunk windows
        # or single-token catch-up steps drain them)
        self.slot_pending: list = [[] for _ in range(batch_size)]
        # prefix-index registration frontier per slot, for chunk-written
        # prompt blocks: the canonical parent block the next registration
        # chains after (pool.ROOT for a fresh chain, False when broken),
        # and the prompt position indexed so far
        self.slot_reg: list = [False] * batch_size
        self.slot_reg_pos = np.zeros(batch_size, np.int64)
        self._finished_at_admit: list = []
        self._used_slots: set = set()
        self._waiting: deque = deque()       # preempted, awaiting re-admission
        self._admit_order = np.zeros(batch_size, np.int64)
        self._admit_seq = 0

        if self.paged:
            self.block_size = block_size
            self.blocks_per_slot = -(-max_seq // block_size)
            if num_blocks is None:
                # same token capacity as B fixed stripes, + scratch block 0
                num_blocks = batch_size * self.blocks_per_slot + 1
            self.pool = BlockPool(num_blocks, block_size, tracer=self.tracer)
            self.reserve_blocks = min(reserve_blocks,
                                      max(self.pool.total - 1, 0))
            self.caches = model.init_paged_cache(num_blocks, block_size)
            self.block_table = np.zeros((batch_size, self.blocks_per_slot),
                                        np.int32)
            self.slot_blocks: list = [[] for _ in range(batch_size)]
        else:
            self.pool = None
            self.caches = model.init_cache(batch_size, max_seq)
        self.metrics = {"prefills": 0, "prefill_batches": 0,
                        "decode_steps": 0, "completed": 0,
                        "stop_token_exits": 0, "slot_reuses": 0,
                        "blocks_grown": 0, "parked_slot_steps": 0,
                        "preemptions": 0, "shared_admissions": 0,
                        "cow_copies": 0, "cow_parks": 0,
                        "prefill_tokens_computed": 0,
                        "prefill_tokens_shared": 0,
                        "verify_steps": 0, "draft_steps": 0,
                        "spec_proposed": 0, "spec_accepted": 0,
                        "spec_blocks_rolled_back": 0,
                        "chunked_admissions": 0, "chunk_steps": 0,
                        "chunk_prefill_tokens": 0, "cancelled": 0,
                        # kernel dispatch accounting (use_kernel=True only):
                        # multi-token window steps vs the real query
                        # positions fed through the kernel
                        "kernel_windows": 0, "kernel_positions": 0}

    # ------------------------------------------------------ device work
    def _dev(self, a) -> torch.Tensor:
        return sampling.stage(a, self.device)

    def _prefill_paged(self, tokens, last_idx, samp):
        """Batched prefill for the pool path: returns the first token per
        row (+ logprob) and the prefill KV padded (with zeros, never
        attended) to a block_size multiple so every logical block slices
        full."""
        logits, pref = self.model.prefill(self.params,
                                          {"tokens": self._dev(tokens)},
                                          last_idx=self._dev(last_idx),
                                          plan=self.plan)
        pad = (-tokens.shape[1]) % self.block_size
        if pad:
            pref = {key: F.pad(v, (0, 0, 0, 0, 0, pad))
                    for key, v in pref.items()}
        nxt, logp = sampling.sample_rows(logits[:, -1, :], samp)
        return nxt, logp, pref

    def _admit(self, tokens, last_idx, slots, samp):
        """Batched prefill + stripe insertion: row j of the prefill cache
        goes to slot ``slots[j]`` (K/V at positions [0, S) of its
        stripe), in place, on device. Returns the first token per row and
        its logprob."""
        logits, pref = self.model.prefill(self.params,
                                          {"tokens": self._dev(tokens)},
                                          last_idx=self._dev(last_idx),
                                          plan=self.plan)
        # under a plan a recurrent state comes back as each rank's heads /
        # channels: the engine's caches are whole on every rank
        pref = {key: v.full_tensor() if isinstance(v, DTensor) else v
                for key, v in pref.items()}
        for j, slot in enumerate(slots):
            for key, cache in self.caches.items():
                row = pref[key][:, j]
                cache[:, slot][tuple(slice(0, n) for n in row.shape)] = row
        return sampling.sample_rows(logits[:, -1, :], samp)

    def _prefill(self, members: list, width: int) -> tuple:
        """One prefill call: row j holds the first ``n0`` tokens of
        ``members[j]``'s prompt ((req, slot, n0)), right-padded to
        ``width``; each row's KV goes to its slot (pool blocks or
        stripe). Returns each row's first token and its logprob, on the
        device. The call's positions and padding are counted; traced, its
        host work lands on the engine track (``prefill-launch``,
        ``kv-insert``), its device work from the first copy to the last
        insertion on the device track (``prefill-call``), and each MoE
        FFN it runs as a ``moe-ffn`` span."""
        tr = self.tracer
        if tr.enabled:
            t = tr.clock()
        toks = np.zeros((len(members), width), np.int32)
        last = np.zeros(len(members), np.int32)
        for j, (req, _, n0) in enumerate(members):
            toks[j, :n0] = self._eff_prompt(req)[:n0]
            last[j] = n0 - 1
        self._count_prefill(toks.size, int(last.sum()) + len(members))
        if tr.enabled:
            tick = self.ticks
            mark = self._spans.mark()
            span_hook.hook = self._moe_spans.arm(tick, "prefill-call")
        try:
            samp = self._sampling_rows([req for req, _, _ in members])
            if self.paged:
                nxt, logp, pref = self._prefill_paged(toks, last, samp)
            else:
                nxt, logp = self._admit(toks, last,
                                        [slot for _, slot, _ in members],
                                        samp)
        finally:
            if tr.enabled:
                span_hook.hook = None
        if tr.enabled:
            t = self._sub("prefill-launch", t, tick, "fill")
        if self.paged:
            for j, (req, slot, n0) in enumerate(members):
                eff = self._eff_prompt(req)
                self._insert_paged(pref, j, slot, eff[:n0],
                                   more=n0 < len(eff))
            if tr.enabled:
                self._sub("kv-insert", t, tick, "fill")
        if tr.enabled:
            self._spans.span("prefill-call", mark, self._spans.mark(),
                             {"tick": tick, "rows": len(members),
                              "width": width,
                              "rids": [r.rid for r, _, _ in members]})
        return nxt, logp

    def _count_prefill(self, computed: int, real: int) -> None:
        """Count a prefill call's positions: ``computed`` (rows x width),
        of which ``real`` are prompt tokens and the rest padding."""
        c = self.counters
        c["prefill_calls"] += 1
        c["prefill_call_tokens"] += computed
        c["prefill_pad_tokens"] += computed - real
        if self.tracer.enabled:
            self.tracer.counter("prefill-pad", {"tokens": computed,
                                                "pad": computed - real},
                                pid=PID_ENGINE)

    def _write_block(self, pref, row: int, start: int, phys: int) -> None:
        """Copy one logical block of row ``row`` of the prefill KV (token
        window [start, start+block_size)) into physical pool block
        ``phys`` — in place, on device."""
        for key, pool in self.caches.items():
            pool[:, phys] = pref[key][:, row, start:start + self.block_size]

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate physical block ``src`` into ``dst`` on
        device, all layers."""
        for pool in self.caches.values():
            pool[:, dst] = pool[:, src]

    # ---------------------------------------------------------- telemetry
    def _sub(self, name: str, t0: float, tick: int, phase: str,
             **args) -> float:
        """A host sub-span of loop phase ``phase`` (``fill`` or
        ``dispatch``) on the engine track, from ``t0`` to now; returns
        now. Callers guard on ``tracer.enabled``."""
        tr = self.tracer
        now = tr.clock()
        tr.complete(name, t0, now - t0, pid=PID_ENGINE, tid=self._spans.tid,
                    args={"tick": tick, "phase": phase, **args})
        return now

    def _trace_admit(self, req: Request, slot: int, *,
                     shared: bool = False, chunked: bool = False) -> None:
        """Stamp the admission (first one only) and mark it on the
        request's trace track."""
        if req.admitted_s is None:
            req.admitted_s = self.clock()
        if self.tracer.enabled:
            self.tracer.instant(
                "admitted", pid=PID_REQUESTS, tid=req.rid,
                args={"slot": slot, "shared": shared, "chunked": chunked,
                      "readmission": req.preemptions > 0})

    def _note_first_token(self, req: Request) -> None:
        """Stamp the request's first *generated* token the moment it
        commits (TTFT = ``first_token_s - submitted_s``)."""
        if req.first_token_s is not None:
            return
        req.first_token_s = self.clock()
        if self.tracer.enabled:
            self.tracer.instant("first_token", pid=PID_REQUESTS,
                                tid=req.rid, ts=req.first_token_s)

    def _trace_retire(self, req: Request, status: str) -> None:
        """Render the finished request's lifecycle as spans on its trace
        track, from the request's own stamps."""
        tr = self.tracer
        tr.complete("request", req.submitted_s,
                    req.done_s - req.submitted_s, pid=PID_REQUESTS,
                    tid=req.rid,
                    args={"status": status, "tokens": len(req.out_tokens),
                          "preemptions": req.preemptions})
        if req.first_token_s is None:
            return
        if req.admitted_s is not None:
            tr.complete("prefill", req.admitted_s,
                        req.first_token_s - req.admitted_s,
                        pid=PID_REQUESTS, tid=req.rid)
        tr.complete("decode", req.first_token_s,
                    req.done_s - req.first_token_s,
                    pid=PID_REQUESTS, tid=req.rid)

    # ------------------------------------------------------------- slots
    def free_slots(self) -> list:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @property
    def active(self) -> int:
        return self.B - len(self.free_slots())

    @property
    def waiting(self) -> int:
        """Preempted requests parked off-device, pending re-admission."""
        return len(self._waiting)

    def load(self) -> int:
        """Occupied slots + preempted backlog — least-loaded balancing."""
        return self.active + len(self._waiting)

    # --------------------------------------------------------- pool probes
    @staticmethod
    def _eff_prompt(req: Request) -> list:
        """The tokens a (re-)admission must prefill: the prompt plus any
        tokens already generated before a preemption evicted the slot."""
        return req.prompt + req.out_tokens

    def _match_cost(self, eff: list, chunk: int):
        """Resident-or-cached prefix match for ``eff`` and the admission
        cost with it: ``(blocks, matched, need)``. ``need`` counts the
        un-shared blocks, plus one per **cached** matched block (reviving
        it consumes a free block), plus ONE when the match ends inside a
        *resident* partial tail block (the first append must copy-on-write
        it). In monolithic mode (``chunk == 0``) a match is used only for
        bounded suffixes, ``P - m <= max(block_size, m)``."""
        P = len(eff)
        full = self.pool.blocks_for(P)
        blocks, m = self.pool.match(eff, P - 1)
        if m < self.block_size or \
                (not chunk and P - m > max(self.block_size, m)):
            return [], 0, full
        need = full - len(blocks)
        need += sum(1 for b in blocks if self.pool.refcount(b) == 0)
        if m % self.block_size and self.pool.refcount(blocks[-1]) >= 1:
            need += 1                    # imminent CoW of the shared tail
        return blocks, m, need

    def _chunk_for(self, req: Request) -> int:
        """Chunk width for ``req`` (0 = monolithic admission + serial
        catch-up): the request's override when set, else the engine
        default; always 0 for families that cannot run multi-token
        windows (recurrent); negative overrides clamp to 0 here
        (add_requests rejects them)."""
        if not self._paddable:
            return 0
        if req.prefill_chunk is None:
            return self.prefill_chunk
        return max(int(req.prefill_chunk), 0)

    def pending_chunk_tokens(self) -> int:
        """Pending prompt tokens the active slots will feed through
        chunk windows on the next step — the continuation demand the
        scheduler charges against its per-tick prefill budget before
        admitting new prefills."""
        tot = 0
        for i, r in enumerate(self.slot_req):
            if r is not None and self.slot_pending[i]:
                tot += min(len(self.slot_pending[i]),
                           max(self._chunk_for(r), 1))
        if self.prefill_budget is not None:
            tot = min(tot, self.prefill_budget)
        return tot

    def admission_costs(self, req: Request) -> tuple:
        """``(blocks, prefill_tokens)`` admitting ``req`` right now would
        cost — one prefix-match walk answers both. ``blocks`` is
        :meth:`blocks_needed`'s figure; ``prefill_tokens`` is what the
        admission call itself prefills: the first chunk (or the whole
        prompt when monolithic), 0 for a shared admission, whose
        un-shared suffix is chunk-step work on later ticks."""
        eff = self._eff_prompt(req)
        P = len(eff)
        C = self._chunk_for(req)
        first = min(P, C) if C else P
        if not self.paged:
            return 0, first
        spec = self.pool.blocks_for(min(P + self._spec_window(req),
                                        self.max_seq)) \
            - self.pool.blocks_for(P)
        if self.prefix_sharing:
            _, m, need = self._match_cost(eff, C)
            return need + spec, (0 if m >= self.block_size else first)
        return self.pool.blocks_for(P) + spec, first

    def admit_prefill_tokens(self, req: Request) -> int:
        """Prompt tokens admitting ``req`` right now would run through
        prefill in the admission call itself."""
        return self.admission_costs(req)[1]

    def _spec_window(self, req: Request) -> int:
        """Write positions one speculative step may need past the
        committed length: k proposals + the bonus token's site; 0 when
        the engine or the request opts out."""
        if not self.spec_k:
            return 0
        k = self.spec_k if req.speculation is None \
            else min(req.speculation, self.spec_k)
        return k + 1 if k > 0 else 0

    def blocks_needed(self, req: Request) -> int:
        """Pool blocks this request's admission requires right now: the
        post-sharing cost (a resident prefix match is free; revived
        cached blocks and a shared tail's imminent copy-on-write are
        charged) plus the speculative watermark. A chunked admission
        charges its whole prompt. 0 when not paged."""
        return self.admission_costs(req)[0]

    def blocks_worst_case(self, req: Request) -> int:
        """Upper bound on the request's block demand, independent of
        what is resident — the "can this ever be served" gate."""
        if not self.paged:
            return 0
        return self.pool.blocks_for(len(self._eff_prompt(req)))

    def blocks_available(self) -> int | None:
        return self.pool.available if self.paged else None

    def _admit_ok(self, need: int, planned: int) -> bool:
        avail = self.pool.available - planned
        if need + self.reserve_blocks <= avail:
            return True
        return self.active == 0 and planned == 0 and need <= avail

    def can_admit(self, req: Request, planned_blocks: int = 0, *,
                  need: int | None = None) -> bool:
        """Would admission succeed right now, with ``planned_blocks``
        already promised to earlier picks? Stripe engines admit whenever
        a slot is free; paged engines demand the post-sharing blocks plus
        ``reserve_blocks`` of headroom (waived when idle). Pass ``need``
        when :meth:`blocks_needed`'s answer is already at hand."""
        if not self.paged:
            return True
        if need is None:
            need = self.blocks_needed(req)
        return self._admit_ok(need, planned_blocks)

    def memory_pressure(self) -> float:
        """Fraction of KV memory in use: pool occupancy when paged, slot
        occupancy otherwise."""
        if self.paged:
            return self.pool.occupancy
        return self.active / self.B if self.B else 1.0

    def pool_stats(self) -> dict:
        if not self.paged:
            return {"paged": False, "slots": self.B, "active": self.active,
                    "occupancy": self.memory_pressure()}
        return {"paged": True, "waiting": len(self._waiting),
                # logical view: table entries across slots (a shared
                # block counts once in ``used``, once per table here)
                "logical_blocks": sum(len(b) for b in self.slot_blocks),
                **self.pool.stats()}

    # --------------------------------------------------------- sampling
    def _sampling_rows(self, reqs: list) -> sampling.Rows:
        """Per-row sampling params for a prefill group, staged on the
        device. The counter is the request's emission index. ``None``
        rows (empty slots) stay greedy: their draws are discarded."""
        return sampling.Rows(*self._sampling_arrays(reqs), self.device)

    @staticmethod
    def _sampling_arrays(reqs: list):
        """(temps, top_ks, seeds, ctrs) host arrays for ``reqs``."""
        n = len(reqs)
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        seeds = np.zeros(n, np.int32)
        ctrs = np.zeros(n, np.int32)
        for j, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling or GREEDY
            temps[j] = sp.temperature
            top_ks[j] = sp.top_k
            seeds[j] = sp.seed
            ctrs[j] = len(r.out_tokens)
        return temps, top_ks, seeds, ctrs

    def _sampling_slots(self):
        """Per-slot sampling params for a decode step."""
        return self._sampling_rows(self.slot_req)

    # --------------------------------------------------------- admission
    def add_request(self, req: Request) -> bool:
        """Prefill into a free slot; False if the engine is full."""
        return self.add_requests([req]) == 1

    def _sim_chains(self, eff: list, sim: set) -> None:
        """Record the prefix chains a plain (prefilled) admission will
        register, for in-batch match simulation."""
        bs = self.block_size
        for i in range(self.pool.blocks_for(len(eff))):
            sim.add(tuple(eff[:min((i + 1) * bs, len(eff))]))

    def _sim_match(self, eff: list, max_len: int, sim: set) -> int:
        """Matched length against the union of the real prefix index and
        the chains earlier same-batch plain admissions will register."""
        bs = self.block_size
        pos = 0
        parent = self.pool.ROOT
        while pos + bs <= max_len:
            if tuple(eff[:pos + bs]) in sim:
                parent = False               # sim-only from here on
            else:
                if parent is False:
                    break
                b = self.pool.lookup(parent, tuple(eff[pos:pos + bs]))
                if b is None:
                    break
                parent = b
            pos += bs
        if pos < max_len:
            tail = tuple(eff[pos:max_len])
            if (parent is not False
                    and self.pool.lookup(parent, tail, partial=True)
                    is not None) \
                    or any(c[:max_len] == tuple(eff[:max_len])
                           and len(c) >= max_len for c in sim):
                return max_len
        return pos

    @torch.no_grad()
    def add_requests(self, reqs: list) -> int:
        """Admit as many of ``reqs`` (in order, behind any preempted
        requests awaiting re-admission) as free slots AND pool blocks
        allow. Plain admissions prefill each bucket group as ONE batched
        call; with prefix sharing, a request whose prompt prefix is
        resident (or is being prefilled by an earlier member of this
        batch) acquires those blocks and owes only its un-shared suffix.
        Returns how many of the *caller's* requests were admitted."""
        tr = self.tracer
        t = tr.clock() if tr.enabled else 0.0
        for r in reqs:
            if len(r.prompt) > self.max_seq:
                raise ValueError(f"request {r.rid}: prompt length "
                                 f"{len(r.prompt)} > max_seq {self.max_seq}")
            if r.prefill_chunk is not None and r.prefill_chunk < 0:
                raise ValueError(f"request {r.rid}: prefill_chunk "
                                 f"{r.prefill_chunk} < 0")
            if self.paged and \
                    self.pool.blocks_for(len(r.prompt)) > self.pool.total:
                raise ValueError(f"request {r.rid}: prompt needs "
                                 f"{self.pool.blocks_for(len(r.prompt))} "
                                 f"blocks > pool total {self.pool.total}")
        slots_avail = self.free_slots()
        cand = list(self._waiting) + list(reqs)
        take: list = []          # (req, slot, acquired-blocks | None, m)
        planned = 0
        sim: set = set()         # chains this batch's plain members add
        for r in cand:
            if len(take) >= len(slots_avail):
                break
            eff = self._eff_prompt(r)
            P = len(eff)
            if P > self.max_seq:
                # a preempted request regrew past capacity: finish it as
                # capacity-truncated
                r.done_s = self.clock()
                self.metrics["completed"] += 1
                if self.tracer.enabled:
                    self._trace_retire(r, "truncated")
                self._finished_at_admit.append(r)
                self._waiting.remove(r)
                continue
            slot = slots_avail[len(take)]
            acquired = None
            matched = 0
            if self.paged:
                need = self.pool.blocks_for(P)
                if self.prefix_sharing:
                    blocks, m, cost = self._match_cost(eff,
                                                       self._chunk_for(r))
                    if m >= self.block_size:
                        acquired, matched, need = list(blocks), m, cost
                    else:
                        m_sim = self._sim_match(eff, P - 1, sim)
                        if m_sim >= self.block_size \
                                and (self._chunk_for(r)
                                     or P - m_sim <= max(self.block_size,
                                                         m_sim)):
                            # an earlier member of this batch prefills the
                            # prefix: plan at the post-sharing cost and
                            # resolve the real blocks at insertion time
                            acquired = []
                            need -= self.pool.blocks_for(m_sim)
                            if m_sim % self.block_size:
                                need += 1          # its CoW, like above
                if not self._admit_ok(need, planned):
                    break            # in-order admission: head waits
                planned += need
                if acquired:
                    for b in acquired:
                        # commit the match now: holding a reference keeps
                        # the blocks resident (and indexed); a revived
                        # cached block leaves ``planned`` as it leaves the
                        # free list
                        if self.pool.refcount(b) == 0:
                            planned -= 1
                        self.pool.acquire(b, owner=slot)
                if acquired is None and self.prefix_sharing:
                    # promise only what this admission registers in this
                    # call
                    C = self._chunk_for(r)
                    n0 = min(P, C) if C else P
                    reg = eff if n0 >= P \
                        else eff[:n0 - n0 % self.block_size]
                    if reg:
                        self._sim_chains(reg, sim)
            take.append((r, slot, acquired, matched))
        n_from_waiting = 0
        for r, _, _, _ in take:
            if self._waiting and self._waiting[0] is r:
                self._waiting.popleft()
                n_from_waiting += 1
        # ---- plain admissions first: batched prefill per shape group
        # (a power-of-two bucket for paddable caches, the exact length for
        # recurrent state). A chunked admission contributes only its FIRST
        # chunk (n0 tokens); the remainder becomes the slot's pending queue.
        plain = [(r, s) for r, s, acq, _ in take if acq is None]
        groups: dict = {}
        for n, (req, slot) in enumerate(plain):
            P = len(self._eff_prompt(req))
            C = self._chunk_for(req)
            n0 = min(P, C) if C else P           # first-chunk token count
            if self._solo_prefill:
                key = (n,)                       # one row per prefill call
            elif self._paddable:
                key = _bucket(n0, self.max_seq)
            else:
                key = n0                         # exact-length co-batching
            groups.setdefault(key, []).append((req, slot, n0))
        if tr.enabled:
            self._sub("admit-plan", t, self.ticks, "fill")
        for key, members in groups.items():
            width = key if isinstance(key, int) else members[0][2]
            nxt, logp = self._prefill(members, width)
            if tr.enabled:
                t = tr.clock()
            nxt, logp = _host(nxt), _host(logp)
            if tr.enabled:
                self._sub("prefill-wait", t, self.ticks, "fill")
            for j, (req, slot, n0) in enumerate(members):
                eff = self._eff_prompt(req)
                P = len(eff)
                if slot in self._used_slots:
                    self.metrics["slot_reuses"] += 1
                self._used_slots.add(slot)
                self.slot_req[slot] = req
                self.slot_len[slot] = n0
                self.slot_pending[slot] = list(eff[n0:])
                self._admit_seq += 1
                self._admit_order[slot] = self._admit_seq
                self._trace_admit(req, slot, chunked=n0 < P)
                self.metrics["prefills"] += 1
                self.metrics["prefill_tokens_computed"] += P
                if n0 < P:
                    # mid-prompt logits: the draw is discarded, the first
                    # real token comes from the chunk window that drains
                    # the pending queue
                    self.metrics["chunked_admissions"] += 1
                    continue
                req.out_tokens.append(int(nxt[j]))
                req.out_logprobs.append(float(logp[j]))
                self._note_first_token(req)
                if self._is_done(req):
                    self._retire(slot)
                    self._finished_at_admit.append(req)
            self.metrics["prefill_batches"] += 1
        # ---- shared admissions after: the whole batch's registrations
        # are visible, so in-batch prefixes resolve to real blocks
        for req, slot, acquired, matched in take:
            if acquired is None:
                continue
            self._admit_shared(req, slot, acquired, matched)
        if self.draft is not None:
            # the draft caches every admitted prompt too (its stripes are
            # per slot, shared admissions included), skipping slots that
            # retired at admission, and everything but the newest
            # committed token, which draws the first proposal
            members = []
            for req, slot, _, _ in take:
                if self.slot_req[slot] is not req:
                    continue
                eff = self._eff_prompt(req)
                members.append((slot, eff[:-1] if req.out_tokens else eff))
            if members:
                self.draft.admit(members)
        return len(take) - n_from_waiting

    def _extend_match(self, eff: list, slot: int, blocks: list,
                      m: int) -> int:
        """Extend a committed match chain past ``m`` with whatever this
        batch's prefills registered since planning, acquiring each new
        block for ``slot``. Never re-walks from the root. Only a
        boundary-ended chain can extend."""
        bs = self.block_size
        if m % bs or not blocks:
            return m
        cap = len(eff) - 1
        parent = blocks[-1]
        while m + bs <= cap:
            b = self.pool.lookup(parent, tuple(eff[m:m + bs]))
            if b is None or b in blocks:
                break
            self.pool.acquire(b, owner=slot)
            blocks.append(b)
            parent = b
            m += bs
        tail = tuple(eff[m:cap])
        if tail and m % bs == 0:
            b = self.pool.lookup(parent, tail, partial=True)
            if b is not None and b not in blocks:
                self.pool.acquire(b, owner=slot)
                blocks.append(b)
                m += len(tail)
        return m

    def _admit_shared(self, req: Request, slot: int, acquired: list,
                      matched: int) -> None:
        """Admit ``req`` into ``slot`` reusing resident prefix blocks: the
        chain committed at planning time, extended with blocks this
        batch's prefills registered (an empty ``acquired`` is an in-batch
        promise resolved against the real index here). The un-shared
        suffix (>= 1 token: the match is capped at P-1) becomes the slot's
        pending queue."""
        eff = self._eff_prompt(req)
        P = len(eff)
        C = self._chunk_for(req)
        if acquired:
            blocks = list(acquired)
            m = self._extend_match(eff, slot, blocks, matched)
        else:
            blocks, m, _ = self._match_cost(eff, C)  # m = 0 if unusable now
            for b in blocks:
                self.pool.acquire(b, owner=slot)
        if m < self.block_size:
            # in-batch promise broken (the source retired inside this very
            # batch): a solo plain prefill, chunked like any other
            n0 = min(P, C) if C else P
            nxt, logp = self._prefill([(req, slot, n0)], n0)
            self.slot_req[slot] = req
            self.slot_len[slot] = n0
            self.slot_pending[slot] = list(eff[n0:])
            self.metrics["prefill_batches"] += 1
            self.metrics["prefill_tokens_computed"] += P
            if n0 < P:
                self.metrics["chunked_admissions"] += 1
            else:
                req.out_tokens.append(int(_host(nxt)[0]))
                req.out_logprobs.append(float(_host(logp)[0]))
                self._note_first_token(req)
        else:
            self.slot_blocks[slot] = list(blocks)
            self.block_table[slot, :] = 0
            self.block_table[slot, :len(blocks)] = blocks
            self.slot_req[slot] = req
            self.slot_len[slot] = m
            self.slot_pending[slot] = list(eff[m:])
            # chunk-step registration continues the matched chain only
            # from a block boundary
            if m % self.block_size == 0:
                self.slot_reg[slot] = blocks[-1]
                self.slot_reg_pos[slot] = m
            else:
                self.slot_reg[slot] = False
            self.metrics["shared_admissions"] += 1
            self.metrics["prefill_tokens_shared"] += m
            self.metrics["prefill_tokens_computed"] += P - m
        if slot in self._used_slots:
            self.metrics["slot_reuses"] += 1
        self._used_slots.add(slot)
        self._admit_seq += 1
        self._admit_order[slot] = self._admit_seq
        self._trace_admit(req, slot, shared=m >= self.block_size,
                          chunked=bool(self.slot_pending[slot]))
        self.metrics["prefills"] += 1
        if self._is_done(req):
            self._retire(slot)
            self._finished_at_admit.append(req)

    def _insert_paged(self, pref, row: int, slot: int, eff: list, *,
                      more: bool = False) -> None:
        """Allocate the slot's blocks and copy its prefill KV into the
        pool block by block; with sharing on, advertise each block's
        prompt content in the prefix index. ``more``: the prompt
        continues past ``eff`` (a chunked admission's first chunk) — the
        trailing partial block's registration is deferred to
        ``_register_chunk_progress``."""
        n_tokens = len(eff)
        n_blk = self.pool.blocks_for(n_tokens)
        blocks = self.pool.alloc(n_blk, owner=slot)
        if blocks is None:
            raise RuntimeError("admission accounting let an alloc fail")
        self.slot_blocks[slot] = blocks
        self.block_table[slot, :] = 0
        self.block_table[slot, :n_blk] = blocks
        bs = self.block_size
        parent = self.pool.ROOT if self.prefix_sharing else False
        reg_pos = 0
        for i, phys in enumerate(blocks):
            self._write_block(pref, row, i * bs, phys)
            end = min((i + 1) * bs, n_tokens)
            if parent is not False and (end - i * bs == bs or not more):
                # thread the canonical block as the next link's parent so
                # duplicate chains converge on one indexed copy
                parent = self.pool.register(phys, parent,
                                            tuple(eff[i * bs:end]))
                if parent is None:
                    parent = False
                else:
                    reg_pos = end
        if parent is not False and n_tokens % bs and not more:
            # a partial-tail registration ends the walkable chain
            parent = False
        self.slot_reg[slot] = parent
        self.slot_reg_pos[slot] = reg_pos

    def _register_chunk_progress(self, i: int, final: bool) -> None:
        """Advertise prompt content a chunk / catch-up step just wrote
        into slot ``i``'s blocks: every newly FULL block registers chained
        after the slot's canonical frontier, and once the prompt drains
        (``final``) the trailing partial block registers at the prompt's
        true tail. No-op when the chain is broken."""
        parent = self.slot_reg[i]
        if parent is False or not self.prefix_sharing:
            return
        bs = self.block_size
        end = int(self.slot_len[i])    # prompt content resident through
        pos = int(self.slot_reg_pos[i])
        eff = self._eff_prompt(self.slot_req[i])
        while parent is not False and pos + bs <= end:
            parent = self.pool.register(self.slot_blocks[i][pos // bs],
                                        parent, tuple(eff[pos:pos + bs]))
            if parent is None:
                parent = False
            else:
                pos += bs
        if parent is not False and final and pos < end:
            self.pool.register(self.slot_blocks[i][pos // bs], parent,
                               tuple(eff[pos:end]))
            parent = False     # a partial tail ends the walkable chain
            pos = end
        self.slot_reg[i] = parent
        self.slot_reg_pos[i] = pos

    # ------------------------------------------------------------- decode
    def _is_done(self, req: Request) -> bool:
        return (len(req.out_tokens) >= req.max_new_tokens
                or req.finished_by_stop)

    def _release_blocks(self, slot: int) -> None:
        if self.paged and self.slot_blocks[slot]:
            self.pool.free(self.slot_blocks[slot], owner=slot)
            self.slot_blocks[slot] = []
            self.block_table[slot, :] = 0

    def _clear_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self.slot_pending[slot] = []
        self.slot_reg[slot] = False
        self.slot_reg_pos[slot] = 0
        self._release_blocks(slot)
        if self.draft is not None:
            self.draft.reset(slot)

    def _retire(self, slot: int, *, cancelled: bool = False) -> None:
        req = self.slot_req[slot]
        req.done_s = self.clock()
        if self.tracer.enabled:
            self._trace_retire(req,
                               "cancelled" if cancelled else "completed")
        self._clear_slot(slot)
        if cancelled:
            self.metrics["cancelled"] += 1
            return
        self.metrics["completed"] += 1
        if req.finished_by_stop and len(req.out_tokens) < req.max_new_tokens:
            self.metrics["stop_token_exits"] += 1

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` mid-flight: retire its slot (blocks
        freed, slot recyclable this very tick) or drop it from the
        preempted backlog. Returns False when the engine doesn't hold it.
        Must NOT be called between ``dispatch_step()`` and ``commit()``."""
        for i, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self._retire(i, cancelled=True)
                return True
        for r in list(self._waiting):
            if r.rid == rid:
                self._waiting.remove(r)
                r.done_s = self.clock()
                if self.tracer.enabled:
                    self._trace_retire(r, "cancelled")
                self.metrics["cancelled"] += 1
                return True
        return False

    def _preempt(self, slot: int) -> None:
        """Evict a slot under pool exhaustion: free its blocks and queue
        the request for recompute re-admission. Freeing only drops this
        slot's references: blocks shared with a live slot stay resident."""
        req = self.slot_req[slot]
        req.preemptions += 1
        self._clear_slot(slot)
        self._waiting.append(req)
        self.metrics["preemptions"] += 1
        if self.tracer.enabled:
            self.tracer.instant("preempt", pid=PID_REQUESTS, tid=req.rid,
                                args={"slot": slot,
                                      "generated": len(req.out_tokens)})

    def _ensure_writable(self, i: int, width: int) -> int:
        """Make positions ``[len, len + width)`` of slot ``i`` safe to
        write: **copy-on-write** a shared tail before any write would land
        in it, drop stale prefix-index entries for in-place writes, and
        allocate blocks through the window's last position (the
        speculative **watermark**: ``width = n_spec + 1`` for a
        speculating slot, a chunk for a chunk window, 1 otherwise).
        Returns how many positions were secured: ``width``, fewer when
        the pool ran out mid-window (the slot speculates or chunks less),
        or 0 — the slot must park."""
        L = int(self.slot_len[i])
        bs = self.block_size
        first_bi = L // bs
        if first_bi < len(self.slot_blocks[i]):
            b = self.slot_blocks[i][first_bi]
            if not self.pool.writable(b):
                got = self.pool.alloc(1, owner=i)
                if got is None:
                    # park, and divert this slot's ride-along write to the
                    # scratch block: the table still names the SHARED
                    # block (restored below once the copy arrives)
                    self.block_table[i, first_bi] = 0
                    self.metrics["cow_parks"] += 1
                    if self.tracer.enabled:
                        self.tracer.instant("cow_park", pid=PID_POOL,
                                            args={"slot": i,
                                                  "block": int(b)})
                    return 0
                self._copy_block(b, got[0])
                self.pool.free([b], owner=i)
                self.slot_blocks[i][first_bi] = got[0]
                self.metrics["cow_copies"] += 1
                if self.tracer.enabled:
                    self.tracer.instant("cow_copy", pid=PID_POOL,
                                        args={"slot": i, "src": int(b),
                                              "dst": int(got[0])})
                b = got[0]
            self.block_table[i, first_bi] = b    # also restores a CoW park
            self.pool.prepare_write(b, L % bs)
        last_bi = (L + width - 1) // bs
        while last_bi >= len(self.slot_blocks[i]):
            bi = len(self.slot_blocks[i])
            got = self.pool.alloc(1, owner=i)
            if got is None:
                return max(bi * bs - L, 0)
            self.slot_blocks[i].extend(got)
            self.block_table[i, bi] = got[0]
            self.metrics["blocks_grown"] += 1
        return width

    def _grow_or_park(self, active: list, want: dict | None = None) -> dict:
        """Make every active slot's write site(s) safe — ``want[i]``
        positions (a speculating slot's watermark or a chunk window), one
        otherwise. Slots the pool cannot serve at all park; slots it can
        only partly serve speculate or chunk less; if nobody can advance,
        preempt newest admissions until the oldest can. Returns {slot:
        positions secured} (parked slots are removed from ``active``)."""
        secured: dict = {}
        parked = []
        for i in list(active):
            got = self._ensure_writable(i, (want or {}).get(i, 1))
            if got == 0:
                parked.append(i)
                active.remove(i)
            else:
                secured[i] = got
        if parked and not active:
            # total stall: every active slot needs a block and none is free
            order = sorted(parked, key=lambda i: self._admit_order[i])
            while len(order) > 1:
                victim = order.pop()            # newest admission recomputes
                parked.remove(victim)
                self._preempt(victim)
                got = self._ensure_writable(order[0], 1)
                if got:                         # oldest advances first
                    oldest = order.pop(0)
                    parked.remove(oldest)
                    active.append(oldest)
                    secured[oldest] = got
                    break
            if len(order) == 1 and not active:
                # one slot owns the whole pool and still needs more:
                # finish it capacity-truncated
                i = order[0]
                parked.remove(i)
                self._finished_at_admit.append(self.slot_req[i])
                self._retire(i)
        self.metrics["parked_slot_steps"] += len(parked)
        if parked and self.tracer.enabled:
            for i in parked:
                self.tracer.instant("park", pid=PID_REQUESTS,
                                    tid=self.slot_req[i].rid,
                                    args={"slot": i})
        return secured

    def _rollback(self, i: int) -> None:
        """Speculative rollback: return pool blocks past the committed
        length. Every freed block was allocated for this slot's watermark
        and is sole-owned (the window was made writable, copied out of
        any sharing, before the verify scatter), so no co-holder's chain
        is ever rolled back."""
        keep = self.pool.blocks_for(max(int(self.slot_len[i]), 1))
        extra = self.slot_blocks[i][keep:]
        if extra:
            self.pool.free(extra, owner=i)
            del self.slot_blocks[i][keep:]
            self.block_table[i, keep:] = 0
            self.metrics["spec_blocks_rolled_back"] += len(extra)

    def _spec_step(self, active: list, n_spec, finished: list,
                   tick: int) -> _Tick:
        """Dispatch one draft-and-verify step. ``n_spec[i]`` proposals for
        each speculating slot (0 for riders: pending catch-up, opted-out
        or watermark-degraded slots, which feed one real token through
        the same verify batch and advance by one, exactly the plain
        step). The window's tokens are the host's first column and the
        draft's proposal tensor, joined on the device; nothing is read
        back before the tick's commit, which commits each row's accepted
        prefix + bonus token, rolls the pool back to the committed
        watermark, and advances the draft."""
        tr = self.tracer
        if tr.enabled:
            t = tr.clock()
            mark = self._spans.mark()
        k = self.spec_k
        temps, top_ks, seeds, ctrs = self._sampling_arrays(self.slot_req)
        rows = [i for i in active if n_spec[i] > 0]
        # the draft only needs each row's UNCACHED committed suffix
        tails = [None] * self.B
        totals = np.zeros(self.B, np.int64)
        for i in rows:
            r = self.slot_req[i]
            dl, P = int(self.draft.len[i]), len(r.prompt)
            tails[i] = (r.prompt[dl:] + r.out_tokens) if dl < P \
                else r.out_tokens[dl - P:]
            totals[i] = P + len(r.out_tokens)
        first = np.zeros((self.B, 1), np.int32)
        n_write = np.zeros(self.B, np.int32)
        for i in active:
            r = self.slot_req[i]
            first[i, 0] = self.slot_pending[i][0] if self.slot_pending[i] \
                else r.out_tokens[-1]
            n_write[i] = n_spec[i] + 1
        if self.paged and self.use_kernel:
            self.metrics["kernel_windows"] += 1
            self.metrics["kernel_positions"] += int(
                sum(n_write[i] for i in active))
        first_d = self._dev(first)
        table = self._dev(self.block_table) if self.paged else None
        lens = self._dev(self.slot_len)
        n_write = self._dev(n_write) if self.paged else None
        if tr.enabled:
            t = self._sub("stage", t, tick, "dispatch", step="spec")
        proposed, dprobs = self.draft.propose(tails, rows, k, temps, top_ks,
                                              seeds, ctrs)
        self.metrics["draft_steps"] = self.draft.steps_run
        toks = torch.cat([first_d, proposed], dim=1)
        logits, _ = self.model.verify_step(
            self.params, toks, self.caches, lens, block_table=table,
            paged_kernel=self.use_kernel, n_write=n_write, plan=self.plan)
        a, out_toks, lps = sampling.speculative_accept(
            logits, dprobs, proposed, n_spec, temps, top_ks, seeds, ctrs)
        self.metrics["decode_steps"] += 1
        self.metrics["verify_steps"] += 1
        if tr.enabled:
            self._sub("launch", t, tick, "dispatch", step="spec")
            self._spans.span("spec-step", mark, self._spans.mark(),
                             {"tick": tick, "rows": len(active)})
        return _Tick(lambda: self._commit_spec(active, n_spec, finished,
                                               totals, a, out_toks, lps), self._spans)

    def _commit_spec(self, active, n_spec, finished, totals, a, out_toks,
                     lps) -> list:
        a, out_toks, lps = _host(a), _host(out_toks), _host(lps)
        k = self.spec_k
        win_proposed = win_accepted = 0     # this verify window's totals
        for i in active:
            r = self.slot_req[i]
            if self.slot_pending[i]:
                # catch-up rider: the fed token was a prompt token; its
                # successor only counts once the suffix is exhausted
                self.slot_len[i] += 1
                self.slot_pending[i].pop(0)
                self._register_chunk_progress(
                    i, final=not self.slot_pending[i])
                if self.paged:
                    self._rollback(i)
                if self.slot_pending[i]:
                    continue
                commit = [int(out_toks[i, 0])]
                lpc = [float(lps[i, 0])]
            else:
                ai = int(min(a[i], n_spec[i]))
                self.slot_len[i] += ai + 1
                commit = [int(t) for t in out_toks[i, :ai + 1]]
                lpc = [float(x) for x in lps[i, :ai + 1]]
                if n_spec[i] > 0:
                    self.metrics["spec_proposed"] += int(n_spec[i])
                    self.metrics["spec_accepted"] += ai
                    win_proposed += int(n_spec[i])
                    win_accepted += ai
                    # draft cache valid through the accepted prefix; it
                    # only ever cached through proposal k - 1
                    self.draft.commit(i, int(totals[i]) + min(ai, k - 1))
                if self.paged:
                    self._rollback(i)
            room = r.max_new_tokens - len(r.out_tokens)
            commit = commit[:room]
            for t_idx, t in enumerate(commit):
                if t in r.stop_tokens:       # stop inside the window
                    commit = commit[:t_idx + 1]
                    break
            r.out_tokens.extend(commit)
            r.out_logprobs.extend(lpc[:len(commit)])
            if commit:
                self._note_first_token(r)
            if self._is_done(r):
                finished.append(r)
                self._retire(i)
        if win_proposed and self.tracer.enabled:
            self.tracer.counter("speculation",
                                {"proposed": win_proposed,
                                 "accepted": win_accepted}, pid=PID_LOOP)
        return finished

    def _chunk_step(self, active: list, chunk_want: dict,
                    finished: list, tick: int) -> _Tick:
        """Dispatch one **chunk window** step: every slot with pending
        prompt tokens feeds up to its chunk of them while decode slots
        ride with their single next token. A row that exhausts its prompt
        inside the window samples at its last real position; every other
        draw is discarded. Parked slots ride with ``n_write`` 0 (all their
        writes divert to scratch)."""
        tr = self.tracer
        if tr.enabled:
            t = tr.clock()
            mark = self._spans.mark()
        W = _bucket(max(chunk_want.get(i, 1) for i in active), self.max_seq)
        toks = np.zeros((self.B, W), np.int32)
        n_write = np.zeros(self.B, np.int32)
        last = np.zeros(self.B, np.int32)
        n_fed: dict = {}
        for i in active:
            r = self.slot_req[i]
            if self.slot_pending[i]:
                c = chunk_want.get(i, 1)
                toks[i, :c] = self.slot_pending[i][:c]
            else:
                c = 1
                toks[i, 0] = r.out_tokens[-1]
            n_fed[i] = c
            n_write[i] = c
            last[i] = c - 1
        samp = self._sampling_slots()
        if self.paged and self.use_kernel:
            self.metrics["kernel_windows"] += 1
            self.metrics["kernel_positions"] += sum(n_fed.values())
        # a stripe window has no n_write: pad positions past a row's count
        # land in its own stripe (never attended, overwritten later) or
        # drop past max_seq
        table = self._dev(self.block_table) if self.paged else None
        toks, lens = self._dev(toks), self._dev(self.slot_len)
        n_write, last = self._dev(n_write), self._dev(last)
        if tr.enabled:
            t = self._sub("stage", t, tick, "dispatch", step="chunk")
        logits, _ = self.model.prefill(
            self.params, {"tokens": toks}, cache=self.caches,
            cache_len=lens, block_table=table, paged_kernel=self.use_kernel,
            n_write=n_write, last_idx=last, plan=self.plan)
        nxt, logp = sampling.sample_rows(logits[:, 0, :], samp)
        self.metrics["decode_steps"] += 1
        self.metrics["chunk_steps"] += 1
        if tr.enabled:
            self._sub("launch", t, tick, "dispatch", step="chunk")
            self._spans.span("chunk-step", mark, self._spans.mark(),
                             {"tick": tick, "rows": len(active)})
        return _Tick(lambda: self._commit_chunk(active, n_fed, finished,
                                                nxt, logp), self._spans)

    def _commit_chunk(self, active, n_fed, finished, nxt, logp) -> list:
        nxt, logp = _host(nxt), _host(logp)
        for i in active:
            r = self.slot_req[i]
            c = n_fed[i]
            self.slot_len[i] += c
            if self.slot_pending[i]:
                del self.slot_pending[i][:c]
                self.metrics["chunk_prefill_tokens"] += c
                if self.paged:
                    self._register_chunk_progress(
                        i, final=not self.slot_pending[i])
                if self.slot_pending[i]:
                    continue
            r.out_tokens.append(int(nxt[i]))
            r.out_logprobs.append(float(logp[i]))
            self._note_first_token(r)
            if self._is_done(r):
                finished.append(r)
                self._retire(i)
        return finished

    def step(self) -> list:
        """One decode step over all active slots:
        ``dispatch_step().commit()``."""
        return self.dispatch_step().commit()

    @torch.no_grad()
    def dispatch_step(self) -> _Tick:
        """Dispatch one decode step over all active slots (each at its own
        length) — a draft-and-verify step when the engine speculates and
        any slot has room to, a chunk-window step when any slot owes more
        than one pending prompt token. Parked slots ride the batch but
        emit nothing. Host-side planning (capacity retires, chunk
        budgeting, speculative windows, block growth) happens here, then
        the device work is *launched*;
        the returned :class:`_Tick`'s ``commit()`` syncs on the result and
        applies the per-slot bookkeeping. Between dispatch and commit the
        engine's slot state must not be mutated.

        Traced, the host work lands on the engine track as ``plan``,
        ``stage`` (host arrays and their copies) and ``launch`` (the
        model and the sampler), and the device's from the first copy to
        the sampler's end on the device track (``decode-step``,
        ``chunk-step`` or ``spec-step``)."""
        tr = self.tracer
        tick = self.ticks
        self.ticks += 1
        t = tr.clock() if tr.enabled else 0.0
        finished, active, chunk_want, n_spec, chunking = self._plan_step()
        if tr.enabled:
            self._sub("plan", t, tick, "dispatch")
        if not active:
            return _Tick(lambda: finished, self._spans)
        if self.spec_k and any(n_spec[i] > 0 for i in active):
            return self._spec_step(active, n_spec, finished, tick)
        if chunking:
            return self._chunk_step(active, chunk_want, finished, tick)
        return self._decode_step(active, finished, tick)

    def _plan_step(self) -> tuple:
        """The host planning of a step: capacity retires, the chunk
        budget, speculative windows and block growth. Returns (finished,
        active, chunk_want, n_spec, chunking)."""
        finished, self._finished_at_admit = self._finished_at_admit, []
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        # any slot past capacity would write out of bounds — finish it now
        for i in list(active):
            if self.slot_len[i] >= self.max_seq:
                finished.append(self.slot_req[i])
                self._retire(i)
                active.remove(i)
        if not active:
            return finished, active, {}, None, False
        # chunk plan: pending prompt tokens each slot feeds this step,
        # budgeted per tick across slots in admission order (every slot
        # still makes >= 1 token of progress on a dry budget)
        chunk_want: dict = {}
        budget = self.prefill_budget
        for i in sorted(active, key=lambda j: self._admit_order[j]):
            if not self.slot_pending[i]:
                continue
            c = min(len(self.slot_pending[i]),
                    max(self._chunk_for(self.slot_req[i]), 1))
            if budget is not None:
                c = max(1, min(c, budget))
                budget -= c
            chunk_want[i] = c
        chunking = any(c > 1 for c in chunk_want.values())
        # plan speculative windows before securing write sites, so the
        # watermark blocks are granted in the same pass. A chunk tick
        # skips speculation: the window belongs to the chunks, and
        # speculation resumes the moment the prompts drain.
        n_spec = np.zeros(self.B, np.int32)
        if self.spec_k and not chunking:
            for i in active:
                r = self.slot_req[i]
                if self.slot_pending[i]:
                    continue                  # catch-up rides plain
                k = self._spec_window(r) - 1
                if k <= 0:
                    continue
                n_spec[i] = max(0, min(
                    k, self.max_seq - 1 - int(self.slot_len[i]),
                    r.max_new_tokens - len(r.out_tokens) - 1))
        if self.paged:
            if chunking:
                want = {i: chunk_want.get(i, 1) for i in active}
            elif n_spec.any():
                want = {i: int(n_spec[i]) + 1 for i in active}
            else:
                want = None
            secured = self._grow_or_park(active, want)
            for i in active:
                # pool pressure degrades the window (possibly to 0: the
                # slot rides non-speculatively); a degraded chunk just
                # feeds fewer tokens this step
                n_spec[i] = min(n_spec[i], secured[i] - 1)
                if i in chunk_want:
                    chunk_want[i] = min(chunk_want[i], secured[i])
            chunking = any(chunk_want.get(i, 0) > 1 for i in active)
            finished.extend(self._finished_at_admit)
            self._finished_at_admit = []
        return finished, active, chunk_want, n_spec, chunking

    def _decode_step(self, active: list, finished: list, tick: int) -> _Tick:
        """Dispatch one plain decode step: one token a slot."""
        tr = self.tracer
        if tr.enabled:
            t = tr.clock()
            mark = self._spans.mark()
        tok = np.zeros((self.B, 1), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue            # parked rows too: their write lands
            if self.slot_pending[i]:            # in the scratch block
                tok[i, 0] = self.slot_pending[i][0]   # catch-up prompt token
            else:
                tok[i, 0] = r.out_tokens[-1]
        samp = self._sampling_slots()
        if self.paged and self.use_kernel:
            self.metrics["kernel_positions"] += len(active)
        table = self._dev(self.block_table) if self.paged else None
        tok, lens = self._dev(tok), self._dev(self.slot_len)
        if tr.enabled:
            t = self._sub("stage", t, tick, "dispatch", step="decode")
            span_hook.hook = self._moe_spans.arm(tick, "decode-step")
        try:
            logits, _ = self.model.decode_step(
                self.params, tok, self.caches, lens, block_table=table,
                paged_kernel=self.use_kernel, plan=self.plan)
            nxt, logp = sampling.sample_rows(logits[:, -1, :], samp)
        finally:
            if tr.enabled:
                span_hook.hook = None
        self.metrics["decode_steps"] += 1
        if tr.enabled:
            self._sub("launch", t, tick, "dispatch", step="decode")
            self._spans.span("decode-step", mark, self._spans.mark(),
                             {"tick": tick, "rows": len(active)})
        return _Tick(lambda: self._commit_decode(active, finished, nxt,
                                                 logp), self._spans)

    def _commit_decode(self, active, finished, nxt, logp) -> list:
        nxt, logp = _host(nxt), _host(logp)
        for i in active:
            r = self.slot_req[i]
            self.slot_len[i] += 1
            if self.slot_pending[i]:
                # catch-up on an un-shared prompt suffix: the fed token was
                # a prompt token; its sample only counts once the suffix
                # is exhausted
                self.slot_pending[i].pop(0)
                if self.paged:
                    self._register_chunk_progress(
                        i, final=not self.slot_pending[i])
                if self.slot_pending[i]:
                    continue
            r.out_tokens.append(int(nxt[i]))
            r.out_logprobs.append(float(logp[i]))
            self._note_first_token(r)
            if self._is_done(r):
                finished.append(r)
                self._retire(i)
        return finished

    # ------------------------------------------------------------- run
    def run(self, requests: list) -> list:
        """Serve a list of requests to completion (batched, slots recycled
        as soon as they free up, preempted requests re-admitted)."""
        pending = list(requests)
        done: list = []
        while pending or self.active or self._waiting \
                or self._finished_at_admit:
            n = self.add_requests(pending)
            del pending[:n]
            done.extend(self.step())
        return done
