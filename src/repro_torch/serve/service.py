"""Wire a ServingEngine + Scheduler into the paper's PaaS fabric (the
port's copy of the reference's ``serve/service.py``).

A language model becomes one more Prediction-as-a-Service endpoint: N
engine-backed replicas behind the NGINX-style balancer, started by the
supervisor in priority order next to Tika/BERT/NER services. Each
replica owns its own slot-native engine (own KV cache), so replicas
scale serving capacity the same way the paper scales section parsers
across machines.

Payloads are ``{"prompt": [...], "max_new_tokens": n, ...}`` dicts;
the reply carries the generated tokens plus per-request latency so the
front-end can report Table-6-style stage timings. A payload may carry an
``"on_token"`` callable — the replica then streams every generated
``(token, logprob)`` to it as decode ticks commit, instead of the client
seeing output only at completion.

Replicas run on the card unless ``make_lm_service`` is given
``device="cpu"`` (with a model built there).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.balancer import deploy
from repro_torch.core.services import (Replica, RequestError, Service,
                                 ServiceError)
from repro_torch.serve.async_loop import AsyncServeLoop
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import GREEDY, SamplingParams
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.telemetry import MetricsRegistry, prometheus_text


def _scheduler_metrics(sched: Scheduler) -> dict:
    st = sched.stats
    return {"admitted": st.admitted, "completed": st.completed,
            "rejected": st.rejected, "shed": st.shed,
            "ticks": st.ticks, "queue_peak": st.queue_peak,
            "queue_depth": len(sched.queue),
            "slo_hits": st.slo_hits, "slo_misses": st.slo_misses,
            "planned_ahead": st.planned_ahead,
            "plan_hits": st.plan_hits,
            "latency_p50_s": st.percentile(0.50),
            "latency_p99_s": st.percentile(0.99),
            "queue_wait_mean_s": st.mean_queue_wait_s()}


@dataclass
class LMReplica:
    """One engine-backed deployment of an LM service.

    Each replica owns an :class:`AsyncServeLoop` pumping its engine as a
    dispatch → plan-ahead → commit pipeline; ``__call__`` stays a
    synchronous handler (submit a stream handle, pump until it
    resolves) to match the in-process transport of the other PaaS
    replicas, while ``"on_token"`` payloads observe tokens per tick.
    ``load()`` exposes intake + queue depth + occupied slots so the
    balancer can route least-loaded.
    """
    name: str
    scheduler: Scheduler
    _rid: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    loop: AsyncServeLoop = field(init=False, repr=False)
    registry: MetricsRegistry = field(init=False, repr=False)

    def __post_init__(self):
        self.loop = AsyncServeLoop(self.scheduler, name=self.name)
        # one metrics namespace per replica, labelled by replica name so
        # expositions from many replicas merge without collisions. The
        # engine/pool/scheduler/loop stats dicts stay the single source
        # of truth — the registry polls them at collection time. No source
        # refers back to the replica: a cycle through its registry would
        # keep the engine's params and pool on the device after the
        # replica is dropped, until the cycle collector happened to run.
        eng, loop, sched = self.scheduler.engine, self.loop, self.scheduler
        self.registry = MetricsRegistry(labels={"replica": self.name})
        self.registry.source("engine", lambda: eng.metrics)
        self.registry.source("engine", lambda: eng.counters)
        self.registry.source("pool", eng.pool_stats)
        self.registry.source("loop", lambda: loop.metrics)
        self.registry.source("scheduler", lambda: _scheduler_metrics(sched))

    def prometheus_text(self) -> str:
        """This replica's metrics as one Prometheus text exposition."""
        return self.registry.prometheus_text()

    def load(self) -> int:
        return self.loop.load()

    def abort(self) -> int:
        """Fail all in-flight streams with a retryable ServiceError and
        reset serving state — called when the replica is stopped or
        marked down mid-stream (supervisor restart, health flip)."""
        return self.loop.abort()

    def _parse(self, payload: dict, rid: int) -> Request:
        samp = payload.get("sampling", GREEDY)
        if isinstance(samp, dict):
            try:
                samp = SamplingParams(**samp)
            except TypeError as e:
                # client error: no other replica can parse it either
                raise RequestError(f"{self.name}: bad sampling "
                                   f"params {samp!r}: {e}") from e
        if not isinstance(samp, SamplingParams):
            raise RequestError(f"{self.name}: \"sampling\" must be a "
                               f"dict or SamplingParams, got "
                               f"{type(samp).__name__}")
        spec = payload.get("speculation")
        if spec is not None and (isinstance(spec, bool)
                                 or not isinstance(spec, int)
                                 or spec < 0):
            # same client-error contract as "sampling": a value the
            # engine would choke on mid-tick must not look like a
            # replica failure to the balancer
            raise RequestError(f"{self.name}: \"speculation\" must be "
                               f"a non-negative int, got {spec!r}")
        chunk = payload.get("prefill_chunk")
        if chunk is not None and (isinstance(chunk, bool)
                                  or not isinstance(chunk, int)
                                  or chunk < 1):
            # the payload contract is positive-int-or-absent (absent
            # = engine default); non-positive values are a client
            # error, not a replica failure. (Engine-internal
            # Request.prefill_chunk=0 is a valid monolithic opt-out;
            # the HTTP-ish payload deliberately doesn't expose it.)
            raise RequestError(f"{self.name}: \"prefill_chunk\" must "
                               f"be a positive int, got {chunk!r}")
        req = Request(rid=rid, prompt=list(payload["prompt"]),
                      max_new_tokens=payload.get("max_new_tokens", 8),
                      stop_tokens=tuple(payload.get("stop_tokens", ())),
                      priority=payload.get("priority", 0),
                      deadline_s=payload.get("deadline_s"),
                      sampling=samp,
                      speculation=payload.get("speculation"),
                      prefill_chunk=chunk)
        # latency and deadlines live on the scheduler's timeline
        # (virtual in tests, perf_counter in production)
        req.submitted_s = self.scheduler.clock()
        # client errors: no other replica can serve these either, so
        # they must NOT look like replica failures to the balancer
        eng = self.scheduler.engine
        if len(req.prompt) > eng.max_seq:
            raise RequestError(f"{self.name}: prompt length "
                               f"{len(req.prompt)} > max_seq "
                               f"{eng.max_seq}")
        if eng.paged and eng.blocks_worst_case(req) > eng.pool.total:
            raise RequestError(f"{self.name}: prompt needs "
                               f"{eng.blocks_worst_case(req)} KV blocks "
                               f"> pool total {eng.pool.total}")
        if req.deadline_s is not None \
                and req.deadline_s <= self.scheduler.clock():
            raise RequestError(f"{self.name}: deadline already expired")
        return req

    def submit(self, payload: dict):
        """Validate a payload and hand it to the serve loop; returns the
        StreamHandle (callers that want the blocking contract use
        ``__call__``)."""
        with self._lock:
            self._rid += 1
            rid = self._rid
        on_token = payload.get("on_token")
        if on_token is not None and not callable(on_token):
            raise RequestError(f"{self.name}: \"on_token\" must be "
                               f"callable, got {type(on_token).__name__}")
        req = self._parse(payload, rid)
        return self.loop.submit(req, on_token)

    def __call__(self, payload: dict) -> dict:
        # queue-full surfaces from the loop as a retryable ServiceError;
        # sheds and disconnects as RequestError — same taxonomy the
        # drain-based handler had
        return self.loop.wait(self.submit(payload))


def make_lm_service(name: str, model, params, *, n_replicas: int = 1,
                    batch_size: int = 4, max_seq: int = 128,
                    policy: str = "fifo", max_queue: int = 0,
                    priority: int = 2, depends_on: tuple = (),
                    supervisor: Any = None, balancer_policy: str = "rr",
                    with_backup: bool = True, plan=None,
                    paged: bool | None = None, block_size: int = 16,
                    num_blocks: int | None = None,
                    pressure_shed: float | None = None,
                    prefix_sharing: bool = True,
                    use_kernel: bool = False, draft_model=None,
                    draft_params=None, speculation: int = 0,
                    prefill_chunk: int | None = None,
                    prefill_budget: int | None = None,
                    tracer=None, device="cuda") -> Service:
    """Build an LM PaaS: engine replicas -> Replica -> Service -> balancer,
    optionally registered with a Supervisor (started in priority order).

    ``paged``/``block_size``/``num_blocks`` configure each replica's KV
    block pool (paged by default for pure-attention families);
    ``pressure_shed`` arms the scheduler's memory-pressure shedding;
    ``prefix_sharing`` lets admissions reuse resident prompt-prefix
    blocks copy-on-write (on by default for non-MoE paged engines);
    ``use_kernel`` switches paged attention from the gather path to the
    CUDA paged-window kernel, read in place (its plain version on CPU
    tensors). ``"sampling"`` payloads carry per-request
    temperature/top_k/seed, and the reply streams per-token logprobs.
    ``draft_model``/``draft_params``/``speculation`` arm every replica
    for speculative draft-and-verify decode (each replica's engine owns
    its own draft runner; a ``"speculation"`` payload key opts a request
    out or down). ``plan`` (a ``ParallelPlan``) goes into every
    replica's engine and from there into every model call; under a mesh
    every rank builds the same service and serves the same requests.
    ``prefill_chunk`` sets each engine's chunked-prefill width (None =
    the engine default for chunkable families; 0 = monolithic
    admission; requests override per-call with a ``"prefill_chunk"``
    payload key) and ``prefill_budget`` arms the per-tick prefill token
    budget on both the engine's chunk steps and the scheduler's
    admission fill — non-positive values raise a client
    :class:`RequestError` at the payload, ``ValueError`` here.
    ``tracer`` (a :class:`~repro_torch.serve.telemetry.Tracer`) records every
    replica's request lifecycles and tick phases into ONE trace; each
    replica also exposes a labelled metrics registry regardless
    (``service_prometheus_text`` merges them). ``device`` is where every
    replica's engine runs (the model's device)."""
    replicas = []
    for i in range(n_replicas):
        eng = ServingEngine(model, params, batch_size=batch_size,
                            max_seq=max_seq, paged=paged,
                            block_size=block_size, num_blocks=num_blocks,
                            prefix_sharing=prefix_sharing,
                            use_kernel=use_kernel, draft_model=draft_model,
                            draft_params=draft_params,
                            speculation=speculation,
                            prefill_chunk=prefill_chunk,
                            prefill_budget=prefill_budget,
                            tracer=tracer, device=device, plan=plan)
        sched = Scheduler(eng, policy=policy, max_queue=max_queue,
                          pressure_shed=pressure_shed,
                          prefill_budget=prefill_budget)
        lm = LMReplica(f"{name}/{i}", sched)
        replicas.append(Replica(f"{name}/{i}", lm,
                                backup=(with_backup and i == n_replicas - 1
                                        and n_replicas > 1)))
    svc = Service(name, replicas=replicas, priority=priority,
                  depends_on=depends_on)
    deploy(svc, policy=balancer_policy)
    if supervisor is not None:
        supervisor.add(svc)
    return svc


def service_prometheus_text(svc: Service) -> str:
    """One Prometheus text exposition for the whole service: every
    replica's registry (labelled per replica) merged with the
    balancer's upstream counters (labelled per service) — the scrape
    endpoint a deployment would mount next to the paper's NGINX
    front door."""
    regs = [r.handler.registry for r in svc.replicas
            if hasattr(r.handler, "registry")]
    bal = getattr(svc, "balancer", None)
    if bal is not None and hasattr(bal, "metrics_snapshot"):
        breg = MetricsRegistry(labels={"service": svc.name})
        breg.source("balancer", bal.metrics_snapshot)
        regs.append(breg)
    return prometheus_text(regs)
