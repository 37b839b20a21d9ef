"""Async continuous-batching serve loop: dispatch → plan-ahead → commit
(own copy of the reference's ``serve/async_loop.py`` over the port's
engine).

The synchronous ``Scheduler.tick`` serializes host work with the device:
fill slots, block on the decode step, account, repeat — and clients see
tokens only when their request completes. This module restructures the
replica loop around asynchronous kernel launches so both costs
disappear:

- **Pipeline overlap.** ``engine.dispatch_step()`` does all host-side
  planning and *launches* the step's kernels on the current CUDA
  stream; the call returns while the device still computes. The loop uses that window for tick N+1's host
  work — admitting late arrivals to the queue and precomputing
  admission costs via ``scheduler.plan_ahead()`` (one prefix-match walk
  per candidate, cached against ``BlockPool.version``) — then blocks in
  ``tick.commit()`` only when the result is actually needed. Host
  planning time hides behind the device step instead of adding to it.

- **Per-token streaming.** Every request may carry an ``on_token``
  callback; after each commit the loop emits the tokens that appeared
  since the last tick, in order. Token values are **bit-identical** to
  the synchronous drain: the engine's streams are deterministic per
  request regardless of batch composition (mixed-length bit-exact
  decode + counter-based sampling), so overlap changes *when* tokens
  arrive, never *what* they are — ``tests/test_torch_streaming.py``
  enforces this across the engine grid.

- **Cancellation.** ``StreamHandle.cancel()`` (or a callback raising —
  treated as a client disconnect) retires the slot and frees its
  refcounted KV blocks at the next loop boundary; cancels are never
  applied between dispatch and commit, when slot state must not move.

The loop is *driven*, not threaded, by default: ``run_once()`` pumps one
tick, ``wait(handle)`` pumps until a reply is ready — so tests drive it
under a :class:`~repro_torch.serve.clock.VirtualClock` with scripted arrival
traces and zero wall-clock sleeps. ``start()`` runs the same pump on a
daemon thread (event-woken, no polling sleeps) for live replicas, and
``stream()`` is an ``async`` front-end yielding ``(token, logprob)``
pairs for asyncio servers.

Error taxonomy matches the service layer: queue-full and replica aborts
are retryable ``ServiceError``; sheds and client disconnects are the
client's fault (``RequestError``) and must not poison balancer health.
The balancer additionally refuses to retry a request once its first
token has streamed (the client already observed output).
"""
from __future__ import annotations

import asyncio
import threading
from collections import deque

from repro_torch.core.services import RequestError, ServiceError
from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.telemetry import PID_LOOP


class StreamHandle:
    """A submitted request's streaming future.

    ``on_token(token, logprob)`` fires per generated token, in order;
    ``cancel()`` abandons the request at the next loop boundary (the
    reply then carries the tokens generated so far); ``result()`` blocks
    (pumping the loop when it isn't threaded) until the reply dict is
    ready, raising the request's error if it failed.
    """

    def __init__(self, loop: "AsyncServeLoop", req: Request,
                 on_token=None):
        self._loop = loop
        self.request = req
        self.rid = req.rid
        self.on_token = on_token
        self.streamed = 0               # tokens already emitted
        self.cancelled = False
        self.error: Exception | None = None
        self.reply: dict | None = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self) -> None:
        self._done.set()

    def cancel(self) -> None:
        self._loop.cancel(self)

    def result(self) -> dict:
        return self._loop.wait(self)


class AsyncServeLoop:
    """Continuous-batching pump over one Scheduler/ServingEngine pair."""

    def __init__(self, scheduler: Scheduler, *, name: str = "replica",
                 plan_limit: int = 32):
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.name = name
        self.plan_limit = plan_limit
        self.clock = scheduler.clock
        self._intake: deque[StreamHandle] = deque()
        self._cancels: deque[StreamHandle] = deque()
        self._live: dict[int, StreamHandle] = {}
        # the pump lock serializes pumping: the engine is not thread-safe,
        # and callbacks fire with the lock held (reentrant so a callback
        # may cancel). The pump holds it for a whole tick and takes it
        # again at once, so intake and cancels have a lock of their own:
        # a client handing in a request never waits for a device step
        self._lock = threading.RLock()
        self._queue_lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self.metrics = {
            "ticks": 0,                 # committed device steps
            "planned_ahead_ticks": 0,   # ticks that planned >=1 candidate
            "planned": 0,               # total candidates planned in-flight
            "plan_time_s": 0.0,         # host time inside the overlap window
            "commit_wait_s": 0.0,       # host time blocked on the device
        }

    # ------------------------------------------------------------ intake
    def submit(self, req: Request, on_token=None) -> StreamHandle:
        """Hand a request to the loop; returns its stream handle."""
        handle = StreamHandle(self, req, on_token)
        with self._queue_lock:
            self._intake.append(handle)
        self._wake.set()
        return handle

    def cancel(self, handle: StreamHandle) -> None:
        with self._queue_lock:
            if not handle.done:
                self._cancels.append(handle)
        self._wake.set()

    def load(self) -> int:
        """Queued + active + not-yet-admitted work, for least-loaded
        balancing (a snapshot: it does not wait for the pump)."""
        with self._queue_lock:
            n = len(self._intake)
        return n + len(self.scheduler.queue) + self.engine.active

    # ----------------------------------------------------------- pumping
    def _pop(self, queue: deque):
        with self._queue_lock:
            return queue.popleft() if queue else None

    def _admit(self) -> None:
        """Move intake handles into the scheduler queue. Queue-only (no
        engine-slot mutation), so this is safe inside the plan-ahead
        window too — late arrivals join tick N+1's plan."""
        while (handle := self._pop(self._intake)) is not None:
            if handle.done:             # cancelled before admission
                continue
            if handle.rid in self._live:
                handle.error = ServiceError(
                    f"{self.name}: duplicate rid {handle.rid}")
                handle._finish()
                continue
            if not self.scheduler.submit(handle.request):
                handle.error = ServiceError(f"{self.name}: queue full")
                handle._finish()
                continue
            self._live[handle.rid] = handle

    def _apply_cancels(self) -> None:
        """Retire cancelled requests (frees slots + refcounted blocks).
        Only called at loop boundaries — never between dispatch and
        commit."""
        while (handle := self._pop(self._cancels)) is not None:
            if handle.done:
                continue
            handle.cancelled = True
            self.scheduler.cancel(handle.rid)
            self._live.pop(handle.rid, None)
            handle.reply = self._reply(handle.request)
            handle._finish()

    def _collect_shed(self) -> None:
        """Sheds (expired deadline / memory pressure) surface on their
        handles as RequestError — the client's SLO lapsed; retrying
        elsewhere would waste another replica's slots."""
        if not self.scheduler.shed_requests:
            return
        keep = []
        for r in self.scheduler.shed_requests:
            handle = self._live.pop(r.rid, None)
            if handle is None:
                keep.append(r)          # a direct scheduler user's shed
                continue
            handle.error = RequestError(
                f"{self.name}: request {r.rid} shed past its deadline")
            handle._finish()
        self.scheduler.shed_requests[:] = keep

    def _reply(self, r: Request) -> dict:
        return {"tokens": list(r.out_tokens),
                "logprobs": list(r.out_logprobs),
                "latency_s": r.latency_s,
                "replica": self.name}

    def _emit(self) -> None:
        """Stream the tokens each live request gained since last tick. A
        callback that raises is a disconnected client: the request is
        cancelled (slot + blocks recycled) and surfaces RequestError."""
        dead = []
        for rid, handle in self._live.items():
            r = handle.request
            n = len(r.out_tokens)
            if handle.on_token is None:
                handle.streamed = n
                continue
            while handle.streamed < n:
                i = handle.streamed
                try:
                    handle.on_token(r.out_tokens[i], r.out_logprobs[i])
                except Exception as e:
                    handle.error = RequestError(
                        f"{self.name}: client disconnected mid-stream "
                        f"after {i} tokens: {e!r}")
                    dead.append(rid)
                    break
                handle.streamed += 1
        for rid in dead:
            handle = self._live.pop(rid)
            self.scheduler.cancel(rid)
            handle._finish()

    def run_once(self) -> bool:
        """One pipelined tick: admit/cancel → fill → dispatch →
        (plan-ahead window) → commit → account → emit → resolve.
        Returns False when there was nothing to do.

        With a tracer on the engine, every phase lands on the trace's
        serve-loop track as a span — the plan-window and commit-wait
        spans measure the dispatch/commit overlap directly (host work
        hidden vs. time blocked on the device). Timestamps come from
        the loop's clock, so a VirtualClock-driven pump emits a
        deterministic timeline."""
        tr = self.engine.tracer
        trace = tr.enabled
        with self._lock:
            tp = self.clock() if trace else 0.0
            self._apply_cancels()
            if trace:
                now = self.clock()
                tr.complete("apply-cancels", tp, now - tp, pid=PID_LOOP)
                tp = now
            self._admit()
            self.scheduler.fill()
            self._collect_shed()
            if trace:
                now = self.clock()
                tr.complete("fill", tp, now - tp, pid=PID_LOOP)
                tp = now
            eng = self.engine
            if not (eng.active or eng.waiting or eng._finished_at_admit):
                return False
            tick = eng.dispatch_step()
            # ---- overlap window: the device step is in flight --------
            t0 = self.clock()
            if trace:
                tr.complete("dispatch", tp, t0 - tp, pid=PID_LOOP,
                            args={"active": eng.active})
            self._admit()               # late arrivals reach this plan
            planned = self.scheduler.plan_ahead(self.plan_limit)
            t1 = self.clock()
            # ----------------------------------------------------------
            done = tick.commit()
            t2 = self.clock()
            if trace:
                tr.complete("plan-window", t0, t1 - t0, pid=PID_LOOP,
                            args={"planned": planned})
                tr.complete("commit-wait", t1, t2 - t1, pid=PID_LOOP)
            self.scheduler.account(done)
            self.metrics["ticks"] += 1
            self.metrics["planned"] += planned
            if planned:
                self.metrics["planned_ahead_ticks"] += 1
            self.metrics["plan_time_s"] += t1 - t0
            self.metrics["commit_wait_s"] += t2 - t1
            tp = self.clock() if trace else 0.0
            self._emit()
            if trace:
                tr.complete("emit", tp, self.clock() - tp, pid=PID_LOOP,
                            args={"finished": len(done)})
            for r in done:
                handle = self._live.pop(r.rid, None)
                if handle is not None and not handle.done:
                    handle.reply = self._reply(r)
                    handle._finish()
            return True

    def wait(self, handle: StreamHandle) -> dict:
        """Block until the handle resolves — by pumping the loop inline
        when it isn't threaded — then return the reply or raise the
        request's error."""
        if self._thread is not None:
            handle._done.wait()
        else:
            while not handle.done:
                self.run_once()
        if handle.error is not None:
            raise handle.error
        return handle.reply

    def abort(self, error: Exception | None = None) -> int:
        """Fail every in-flight and queued request (replica died / is
        restarting): handles resolve with a retryable ServiceError, and
        scheduler + engine state is torn down so a restart starts clean.
        Returns the number of handles failed."""
        with self._lock:
            err = error if error is not None else ServiceError(
                f"{self.name}: replica aborted mid-stream")
            with self._queue_lock:
                handles = list(self._live.values()) + list(self._intake) \
                    + list(self._cancels)
                self._intake.clear()
                self._cancels.clear()
            self._live.clear()
            n = 0
            for handle in handles:
                if handle.done:
                    continue
                handle.error = err
                handle._finish()
                n += 1
            for req in list(self.scheduler.queue):
                self.scheduler.cancel(req.rid)
            for r in list(self.engine.slot_req):
                if r is not None:
                    self.engine.cancel(r.rid)
            self.engine._waiting.clear()
            self.engine._finished_at_admit.clear()
            return n

    # ---------------------------------------------------------- threaded
    def start(self) -> None:
        """Run the pump on a daemon thread. Event-woken: the thread
        sleeps only when there is no work and wakes on submit/cancel —
        no polling sleeps."""
        if self._thread is not None:
            return
        self._stopping.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"serve-loop:{self.name}")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stopping.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def _run(self) -> None:
        while not self._stopping.is_set():
            self._wake.clear()
            if not self.run_once():
                with self._lock, self._queue_lock:
                    idle = not (self._intake or self._cancels
                                or self.scheduler.queue
                                or self.engine.active
                                or self.engine.waiting)
                if idle and not self._stopping.is_set():
                    self._wake.wait()

    # ----------------------------------------------------------- asyncio
    async def stream(self, req: Request):
        """Async generator yielding ``(token, logprob)`` pairs as they
        materialize, for asyncio front-ends. Pumps the loop inline when
        it isn't threaded; yields control to the event loop between
        ticks so concurrent streams interleave."""
        buf: deque = deque()
        handle = self.submit(req, lambda t, lp: buf.append((t, lp)))
        try:
            while not handle.done:
                if self._thread is None:
                    self.run_once()
                while buf:
                    yield buf.popleft()
                await asyncio.sleep(0)
            while buf:
                yield buf.popleft()
            if handle.error is not None:
                raise handle.error
        finally:
            if not handle.done:
                handle.cancel()
