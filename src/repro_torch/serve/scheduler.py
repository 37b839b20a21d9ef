"""Request scheduler in front of the ServingEngine: admission queue,
continuous batching, SLO-aware policies, and per-request stats (own copy
of the reference's ``serve/scheduler.py``; host-only Python over the
port's engine).

The paper's front-end (NGINX + parser PaaS) admits requests at arbitrary
concurrency and the deployment's worker slots queue the excess. This
module is the LM analogue for
a single model service: requests arrive asynchronously, the scheduler
fills free engine slots by policy, and every decode tick serves all
active slots (continuous batching).

Policies:
    fifo      arrival order
    spf       shortest-prompt-first (reduces head-of-line blocking from
              long prefills)
    priority  highest ``Request.priority`` tier first, FIFO within a tier
    deadline  earliest ``Request.deadline_s`` first (EDF); requests whose
              deadline has already passed are shed at dequeue time rather
              than burning slots on work nobody can use

With ``max_queue`` set, submission is bounded (NGINX worker-queue
semantics: excess requests are rejected, counted in ``stats.rejected``);
``deadline`` additionally rejects at submit time any request that is
already past its deadline.

Paged engines gate admission on **pool blocks**, not just free slots:
the fill loop stops at the first pick the pool cannot hold (in-order, no
bypass — a blocked head is not starved by smaller requests behind it),
and with ``pressure_shed`` set the scheduler sheds queued work when the
engine reports memory pressure at or above the threshold: the backlog is
trimmed — worst-ranked first (lowest priority / latest deadline / back
of the queue) — until its total block demand fits what the pool can
still hold alongside the resident sequences. Slot exhaustion is no
longer the only shedding trigger; memory is.

Block demand is the engine's ``blocks_needed`` — the **post-sharing**
cost when prefix sharing is on (a prompt whose prefix is already
resident only pays for its un-shared suffix, with revived cached-free
blocks and imminent copy-on-writes charged), **plus the speculative
watermark** on a speculating engine: the blocks a request's first
draft-and-verify window will grow into, so a fill batch doesn't pass
the gate and then mass-park on its first speculative step. A queue of
template-sharing requests is neither over-gated nor over-shed. The
never-servable check at submit keeps the worst-case bound
(``blocks_worst_case``): a prefix match may be gone by the time a
preempted request re-admits — and a window the pool cannot grant only
degrades speculation, never serviceability.

With ``prefill_budget`` set, every tick also charges a **prefill token
budget**: the chunk tokens active slots will feed this step (chunked
prompt ingestion mid-flight) are charged first, and new admissions only
join with the remainder — so a burst of long-prompt arrivals is paced
across ticks instead of stacking admission prefills onto one decode
step. The same value caps the engine's per-step chunk tokens across
slots; an idle engine admits regardless (there is no decode latency to
protect, and an over-budget prompt must not livelock).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.telemetry import PID_REQUESTS

POLICIES = ("fifo", "spf", "priority", "deadline")


@dataclass
class SchedulerStats:
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    shed: int = 0                   # expired deadlines dropped pre-prefill
    ticks: int = 0
    queue_peak: int = 0
    slo_hits: int = 0
    slo_misses: int = 0
    planned_ahead: int = 0          # admission costs precomputed off-tick
    plan_hits: int = 0              # fill() decisions served from the cache
    latencies_s: list = field(default_factory=list)
    queue_wait_s: list = field(default_factory=list)
    completed_by_priority: dict = field(default_factory=dict)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile: the smallest sample such that at
        least ``q`` of the data is <= it (rank ``ceil(q * n)``,
        1-indexed, clamped to [1, n]). The old ``int(q * n)`` index sat
        one past the rank whenever ``q * n`` landed on an integer — p50
        of 10 samples read the 6th, and any q >= (n-1)/n read the max —
        biasing every small-sample percentile high."""
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        rank = max(1, min(math.ceil(q * len(xs)), len(xs)))
        return xs[rank - 1]

    def mean_queue_wait_s(self) -> float:
        if not self.queue_wait_s:
            return 0.0
        return sum(self.queue_wait_s) / len(self.queue_wait_s)


class Scheduler:
    """Admission + slot-filling policy over a ServingEngine."""

    def __init__(self, engine: ServingEngine, *, policy: str = "fifo",
                 max_queue: int = 0, pressure_shed: float | None = None,
                 prefill_budget: int | None = None, clock=None):
        assert policy in POLICIES, policy
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1, got "
                             f"{prefill_budget}")
        self.engine = engine
        self.policy = policy
        self.max_queue = max_queue            # 0 = unbounded
        self.pressure_shed = pressure_shed    # occupancy threshold, None=off
        # per-tick cap on prefill tokens (chunk continuation + new
        # admissions); None = unbudgeted
        self.prefill_budget = prefill_budget
        # shares the engine's clock by default so deadlines, queue waits,
        # and engine latency stamps live on one timeline (virtual in
        # tests) — and the engine's tracer, so queue spans land in the
        # same trace as the lifecycle spans the engine emits
        self.clock = clock if clock is not None else engine.clock
        self.tracer = engine.tracer
        self.queue: deque = deque()
        self.stats = SchedulerStats()
        self._enq_t: dict[int, float] = {}
        self.shed_requests: list = []
        # plan-ahead cache: rid -> (pool_version, (need, cost)); entries
        # are only valid while the pool hasn't changed since they were
        # computed (see _pool_version)
        self._plan: dict[int, tuple[int, tuple]] = {}

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> bool:
        if len(req.prompt) > self.engine.max_seq or \
                (self.engine.paged and self.engine.blocks_worst_case(req)
                 > self.engine.pool.total):
            # unservable: would raise from the engine mid-batch at tick
            # time and take its co-dequeued batchmates down with it
            self.stats.rejected += 1
            return False
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.stats.rejected += 1
            return False
        if self.policy == "deadline" and req.deadline_s is not None \
                and req.deadline_s <= self.clock():
            self.stats.rejected += 1
            return False
        self.queue.append(req)
        self._enq_t[req.rid] = self.clock()
        if self.tracer.enabled:
            self.tracer.instant("submit", pid=PID_REQUESTS, tid=req.rid,
                                ts=self._enq_t[req.rid],
                                args={"queue_depth": len(self.queue)})
        self.stats.admitted += 1
        self.stats.queue_peak = max(self.stats.queue_peak, len(self.queue))
        return True

    # ------------------------------------------------------------ policy
    def _next_index(self) -> int:
        if self.policy == "spf":
            return min(range(len(self.queue)),
                       key=lambda i: len(self.queue[i].prompt))
        if self.policy == "priority":
            # max priority; ties resolved FIFO by queue position
            return max(range(len(self.queue)),
                       key=lambda i: (self.queue[i].priority,
                                      -i))
        if self.policy == "deadline":
            inf = float("inf")
            return min(range(len(self.queue)),
                       key=lambda i: (self.queue[i].deadline_s
                                      if self.queue[i].deadline_s is not None
                                      else inf))
        return 0

    def _shed(self, req: Request) -> None:
        req.done_s = self.clock()
        self._enq_t.pop(req.rid, None)
        self._plan.pop(req.rid, None)
        self.stats.shed += 1
        if self.tracer.enabled:
            self.tracer.instant("shed", pid=PID_REQUESTS, tid=req.rid,
                                ts=req.done_s)
        self.shed_requests.append(req)

    def _shed_index(self) -> int:
        """Worst-ranked queued request — the opposite end of the scale
        ``_next_index`` picks from: lowest priority (latest arrival on
        ties), latest deadline (no-SLO requests first), or the back of
        the queue for fifo/spf."""
        if self.policy == "priority":
            return min(range(len(self.queue)),
                       key=lambda i: (self.queue[i].priority, -i))
        if self.policy == "deadline":
            inf = float("inf")
            return max(range(len(self.queue)),
                       key=lambda i: (self.queue[i].deadline_s
                                      if self.queue[i].deadline_s is not None
                                      else inf))
        return len(self.queue) - 1

    def _shed_for_memory_pressure(self) -> None:
        """When pool occupancy crosses ``pressure_shed``, bound the
        backlog to what the KV pool can still hold next to the resident
        sequences: shed worst-ranked queued requests until the queue's
        total block demand fits the free pool. Fires on *memory*
        pressure — a paged engine can have free slots and still be out
        of KV blocks."""
        avail = self.engine.blocks_available()
        if avail is None:                       # fixed-stripe: slots gate
            return
        demand = sum(self.engine.blocks_needed(r) for r in self.queue)
        while self.queue and demand > avail:
            i = self._shed_index()
            req = self.queue[i]
            del self.queue[i]
            demand -= self.engine.blocks_needed(req)
            self._shed(req)

    # --------------------------------------------------------- plan-ahead
    def _pool_version(self) -> int:
        """Validity stamp for cached admission costs. Only a
        prefix-sharing engine's costs depend on pool state (the
        prefix-match walk reads the index, which ``pool.version`` bumps
        on every mutation); stripe engines and non-sharing paged
        engines price an admission as a pure function of the request,
        so a constant stamp never invalidates — a decode-step alloc or
        a retire's free must not flush plans it cannot have changed."""
        if self.engine.paged and self.engine.prefix_sharing:
            return self.engine.pool.version
        return 0

    def plan_ahead(self, limit: int = 32) -> int:
        """Precompute admission costs for up to ``limit`` queued
        candidates so the next ``fill()`` finds them cached. This is the
        host work the async serve loop hides behind the in-flight device
        step (dispatch → **plan** → commit): it only *reads* engine and
        pool state, so it is safe between dispatch and commit. Returns
        the number of requests planned."""
        v = self._pool_version()
        n = 0
        for req in list(self.queue)[:limit]:
            hit = self._plan.get(req.rid)
            if hit is not None and hit[0] == v:
                continue
            self._plan[req.rid] = (v, self.engine.admission_costs(req))
            n += 1
        self.stats.planned_ahead += n
        return n

    def _planned_costs(self, req: Request) -> tuple:
        """(need, cost) for admitting ``req`` — from the plan-ahead cache
        when still valid, else one fresh prefix-match walk."""
        hit = self._plan.pop(req.rid, None)
        if hit is not None and hit[0] == self._pool_version():
            self.stats.plan_hits += 1
            if self.tracer.enabled:
                self.tracer.instant("plan_hit", pid=PID_REQUESTS,
                                    tid=req.rid)
            return hit[1]
        if self.tracer.enabled:
            self.tracer.instant("plan_miss", pid=PID_REQUESTS,
                                tid=req.rid,
                                args={"stale": hit is not None})
        return self.engine.admission_costs(req)

    # ------------------------------------------------------------- cancel
    def cancel(self, rid: int) -> bool:
        """Abandon a request wherever it lives: still queued (removed,
        nothing was computed) or mid-flight in the engine (slot retired,
        KV blocks freed). Returns False if the rid is unknown — e.g.
        already finished. Must not be called between the engine's
        ``dispatch_step`` and ``commit``."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                req.done_s = self.clock()
                self._enq_t.pop(rid, None)
                self._plan.pop(rid, None)
                return True
        return self.engine.cancel(rid)

    # ------------------------------------------------------------ serving
    def fill(self) -> None:
        """Admission half of a tick: shed on memory pressure, then fill
        free engine slots from the queue (one batched prefill, bounded
        by pool blocks and the per-tick prefill token budget)."""
        if self.pressure_shed is not None and self.queue \
                and self.engine.memory_pressure() >= self.pressure_shed:
            self._shed_for_memory_pressure()
        batch, planned_blocks = [], 0
        budget = None
        if self.prefill_budget is not None:
            # chunk continuation is charged FIRST: slots mid-prompt keep
            # their per-tick token share; new prefills only join with
            # what's left, so a burst of long arrivals cannot starve the
            # decode tick with admission prefill work
            budget = self.prefill_budget \
                - self.engine.pending_chunk_tokens()
        while self.queue and len(batch) < len(self.engine.free_slots()):
            i = self._next_index()
            req = self.queue[i]
            if self.policy == "deadline" and req.deadline_s is not None \
                    and req.deadline_s <= self.clock():
                del self.queue[i]
                self._shed(req)
                continue
            # one prefix-match walk per candidate answers both gates
            # (or zero walks, when plan_ahead() already did it)
            need, cost = self._planned_costs(req)
            if not self.engine.can_admit(req, planned_blocks, need=need):
                break               # pool full: head waits for block frees
            if budget is not None:
                if cost > budget and (batch or self.engine.active):
                    break           # head waits for a tick with room —
                    #                 unless the engine is idle (nothing
                    #                 to protect, and waiting would
                    #                 livelock an over-budget prompt)
                budget -= cost
            del self.queue[i]
            planned_blocks += need
            batch.append(req)
        if batch or self.engine.waiting:
            # even with an empty batch the engine must get a chance to
            # re-admit its preempted requests, or they'd wait forever
            # once the scheduler queue drains
            admitted = self.engine.add_requests(batch)
            # blocks may have gone to engine-internal re-admissions
            # (preempted requests resume first): requeue the remainder
            for req in reversed(batch[admitted:]):
                self.queue.appendleft(req)
            now = self.clock()
            for req in batch[:admitted]:
                t_enq = self._enq_t.pop(req.rid)
                self.stats.queue_wait_s.append(now - t_enq)
                if self.tracer.enabled:
                    # same endpoints as the queue_wait_s stat, so the
                    # trace's queued span IS the reported queue wait
                    self.tracer.complete("queued", t_enq, now - t_enq,
                                         pid=PID_REQUESTS, tid=req.rid)

    def account(self, done: list) -> list:
        """Stats half of a tick: latency/SLO bookkeeping for the finished
        requests one engine step returned."""
        self.stats.ticks += 1
        for r in done:
            self.stats.completed += 1
            self.stats.latencies_s.append(r.latency_s)
            tier = self.stats.completed_by_priority
            tier[r.priority] = tier.get(r.priority, 0) + 1
            if r.deadline_s is not None:
                if r.done_s <= r.deadline_s:
                    self.stats.slo_hits += 1
                else:
                    self.stats.slo_misses += 1
        return done

    def tick(self) -> list:
        """Fill free slots, run one decode step, account the finishers.
        Returns finished requests. The async serve loop runs the same
        three phases but slips plan-ahead work between the engine's
        dispatch and commit."""
        self.fill()
        return self.account(self.engine.step())

    def drain(self) -> list:
        """Run until queue and engine (slots + preempted backlog) empty."""
        out = []
        while self.queue or self.engine.active or self.engine.waiting \
                or self.engine._finished_at_admit:
            out.extend(self.tick())
        return out
