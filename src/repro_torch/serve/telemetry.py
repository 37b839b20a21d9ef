"""Serve-loop tracing: the span/event recorder the engine and the block
pool emit into (own copy of the part of the reference's
``serve/telemetry.py`` they use).

* :class:`Tracer` — a clock-injectable event recorder. Components emit
  **spans** (named intervals: a request's prefill/decode phases) and
  **instants** (admit, park, preempt, copy-on-write) into a bounded
  ring buffer; :meth:`Tracer.chrome_trace` renders it as Chrome
  trace-event JSON that Perfetto loads directly.
* :class:`NoopTracer` — the default everywhere. Every emitter is an
  empty method and every call site is also guarded on ``.enabled``, so
  an untraced engine allocates nothing for tracing.
"""
from __future__ import annotations

import time
from collections import deque

# Trace "process" ids: Perfetto groups tracks by pid, so the serve
# loop's tick phases, the per-request lifecycles, and the pool's
# occupancy counters land in three separately-collapsible groups.
PID_LOOP = 0        # serve-loop tick phases (one thread track)
PID_REQUESTS = 1    # one thread track per request (tid = rid)
PID_POOL = 2        # block-pool counters + events


class NoopTracer:
    """Default tracer: every emitter is a no-op, ``enabled`` is False so
    call sites can skip even argument construction; its trace is empty."""

    enabled = False

    def instant(self, name, *, pid=0, tid=0, args=None, ts=None):
        pass

    def complete(self, name, start, duration, *, pid=0, tid=0,
                 args=None):
        pass

    def counter(self, name, values, *, pid=0, tid=0, ts=None):
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NOOP = NoopTracer()


class Tracer(NoopTracer):
    """Bounded in-memory trace recorder with Chrome trace-event export.

    ``clock`` is any zero-argument callable returning seconds
    (``time.perf_counter`` by default);
    every event is stamped with it at emission, so trace timelines and
    the serving stack's latency stats live on one time base when both
    share a clock. ``capacity`` bounds the ring buffer — the hot path
    never grows without bound; the oldest events are evicted first and
    counted in ``dropped``.
    """

    enabled = True

    def __init__(self, clock=time.perf_counter, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    # ------------------------------------------------------------- emit
    def _emit(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def instant(self, name, *, pid=0, tid=0, args=None, ts=None):
        """A point event (``ph: "i"``): admit / park / preempt / shed /
        first-token markers."""
        self._emit({"name": name, "ph": "i", "s": "t",
                    "ts": self._us(self.clock() if ts is None else ts),
                    "pid": pid, "tid": tid,
                    **({"args": args} if args else {})})

    def complete(self, name, start, duration, *, pid=0, tid=0,
                 args=None):
        """A closed interval (``ph: "X"``) stamped by the caller —
        lifecycle phases reconstructed at retire time, tick phases
        measured around the work they cover."""
        self._emit({"name": name, "ph": "X", "ts": self._us(start),
                    "dur": self._us(max(duration, 0.0)),
                    "pid": pid, "tid": tid,
                    **({"args": args} if args else {})})

    def counter(self, name, values, *, pid=0, tid=0, ts=None):
        """A counter sample (``ph: "C"``): Perfetto renders each key of
        ``values`` as a stacked series (pool occupancy, spec accepts)."""
        self._emit({"name": name, "ph": "C",
                    "ts": self._us(self.clock() if ts is None else ts),
                    "pid": pid, "tid": tid, "args": dict(values)})

    @staticmethod
    def _us(t: float) -> float:
        # Chrome trace timestamps are microseconds; rounding to 0.1 us
        # keeps the JSON stable against float-repr noise without losing
        # anything a serve loop can resolve
        return round(t * 1e6, 1)

    # ----------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """The ring buffer as a Chrome trace-event object (Perfetto /
        chrome://tracing loadable). Process/thread metadata names the
        tracks; request tracks are labelled by rid. Deterministic for a
        deterministic clock: events render in emission order with
        sorted keys, so two identical scripted runs serialize to
        byte-identical JSON."""
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "tid": 0, "args": {"name": label}}
                  for pid, label in ((PID_LOOP, "serve-loop"),
                                     (PID_REQUESTS, "requests"),
                                     (PID_POOL, "kv-block-pool"))]
        rids = sorted({e["tid"] for e in self._events
                       if e["pid"] == PID_REQUESTS})
        events.extend({"name": "thread_name", "ph": "M",
                       "pid": PID_REQUESTS, "tid": rid,
                       "args": {"name": f"request {rid}"}}
                      for rid in rids)
        events.extend(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}
