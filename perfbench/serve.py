"""Drives the program's serving entry for one run: ``AsyncServeLoop
.run_once()`` over ``Scheduler`` and ``ServingEngine(paged=True,
use_kernel=True)``, pumped from this thread (what an LM service replica
runs, without the balancer's threads), fed by the traffic generator, and
timed by the host's clock at the benchmark's own boundaries.

Every token is stamped when ``on_token`` delivers it, every request with
its due time (open loop) or its submission (closed loop). A request that
fails, or that has not finished ``grace_s`` after the window closed,
counts as missing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from perfbench import traffic as gen

clock = time.perf_counter


@dataclass
class Record:
    spec: gen.Spec
    due: float                      # absolute, on ``clock``
    handle: object = None
    times: list = field(default_factory=list)   # token delivery times
    ticks: list = field(default_factory=list)   # the tick that delivered it
    tokens: list = field(default_factory=list)
    done: float | None = None
    error: str | None = None

    @property
    def request(self):
        return None if self.handle is None else self.handle.request

    @property
    def finished(self) -> bool:
        return self.done is not None and self.error is None


class Stack:
    """One engine, its scheduler and serve loop, and the records of every
    request sent to them. ``sync`` (multi-rank runs) makes every rank
    take rank 0's clock reading for its arrival decisions."""

    def __init__(self, model, params, eng_cfg: dict, *, device, tracer=None,
                 plan=None, sync=None):
        from repro_torch.serve.async_loop import AsyncServeLoop
        from repro_torch.serve.engine import ServingEngine
        from repro_torch.serve.scheduler import Scheduler
        bs = int(eng_cfg["block_size"])
        kw = {}
        if "prefill_chunk" in eng_cfg:
            kw["prefill_chunk"] = int(eng_cfg["prefill_chunk"])
        self.engine = ServingEngine(
            model, params, batch_size=int(eng_cfg["slots"]),
            max_seq=int(eng_cfg["max_seq"]), paged=True, block_size=bs,
            num_blocks=int(eng_cfg["pool_tokens"]) // bs + 1,
            use_kernel=True, clock=clock, tracer=tracer, device=device,
            plan=plan, **kw)
        self.scheduler = Scheduler(
            self.engine, prefill_budget=eng_cfg.get("prefill_budget"))
        self.loop = AsyncServeLoop(self.scheduler)
        self.records: list[Record] = []
        self.tick = 0
        self.sync = sync or (lambda t: t)

    def now(self) -> float:
        return self.sync(clock())

    def submit(self, spec: gen.Spec, due: float) -> Record:
        from repro_torch.serve.engine import Request
        rec = Record(spec, due)
        req = Request(rid=len(self.records), prompt=list(spec.prompt),
                      max_new_tokens=spec.max_new)

        def on_token(tok, _lp, rec=rec):
            rec.times.append(clock())
            rec.ticks.append(self.tick)
            rec.tokens.append(int(tok))

        req.submitted_s = clock()
        rec.handle = self.loop.submit(req, on_token)
        self.records.append(rec)
        return rec

    def pump(self) -> None:
        """One tick of the serve loop."""
        self.loop.run_once()
        self.tick += 1

    def settle(self, live: list) -> list:
        """Stamp the records of ``live`` whose handles resolved; returns
        those still running."""
        still = []
        for rec in live:
            h = rec.handle
            if not h.done:
                still.append(rec)
                continue
            rec.done = rec.times[-1] if rec.times else clock()
            if h.error is not None:
                rec.error = repr(h.error)
        return still

    def idle(self) -> bool:
        return not (self.loop.load() or self.engine.waiting)

    def close(self) -> None:
        """Drop the engine's device state (pool, weights) and the records'
        ways back to it, so its memory is freed without waiting for the
        cycle collector."""
        self.loop.abort()
        self.engine.caches = self.engine.params = self.engine.model = None
        for rec in self.records:
            if rec.handle is not None:
                rec.handle.on_token = None
        self.engine = self.scheduler = self.loop = None


def warm_up(stack: Stack, specs: list) -> None:
    """Serve ``specs`` to their end before anything is measured."""
    live = [stack.submit(s, clock()) for s in specs]
    while live:
        stack.pump()
        live = stack.settle(live)
    stack.records.clear()


def run_open(stack: Stack, specs: list, t_open: float, seconds: float,
             grace: float, on_tick=None):
    """Submit each spec when due (``t_open + spec.due``) and pump until
    every request due in the window has ended or the grace is over.
    Returns the time the run gave up on what was left."""
    t_close = t_open + seconds
    pending = sorted(specs, key=lambda s: s.due)
    i, live = 0, []
    while True:
        now = stack.now()
        while i < len(pending) and t_open + pending[i].due <= now:
            live.append(stack.submit(pending[i], t_open + pending[i].due))
            i += 1
        window_left = i < len(pending) and pending[i].due < seconds
        if not live and not window_left:
            return now
        if now > t_close + grace:
            return now
        if stack.idle() and i < len(pending):
            time.sleep(max(0.0, min(t_open + pending[i].due - now, 0.05)))
            continue
        if on_tick is not None:
            on_tick(stack)
        stack.pump()
        live = stack.settle(live)


def run_closed(stack: Stack, stream: gen.ClosedStream, clients: int,
               t_open: float, seconds: float, on_tick=None) -> float:
    """``clients`` callers, each sending its next request as soon as its
    last one ended, from now until the window closes. Returns the close."""
    t_close = t_open + seconds
    live = [stack.submit(s, clock()) for s in stream.first(clients)]
    while stack.now() < t_close:
        if on_tick is not None:
            on_tick(stack)
        stack.pump()
        still = stack.settle(live)
        for _ in range(len(live) - len(still)):
            still.append(stack.submit(stream.next(), clock()))
        live = still
    return t_close

