"""Serve-loop telemetry: span tracing + a unified metrics registry (own
copy of the reference's ``serve/telemetry.py``, extended with the
engine's host sub-spans and device spans).

* :class:`Tracer` — a clock-injectable event recorder. Components emit
  **spans** (named intervals: a request's queued/prefill/decode phases,
  a tick's fill/dispatch/plan/commit/emit phases, the engine's work
  inside them) and **instants** (admit, park, preempt, copy-on-write,
  shed, cancel) into a bounded ring buffer; :meth:`Tracer.chrome_trace`
  renders the buffer as Chrome trace-event JSON that Perfetto loads
  directly — requests as one named track each, the serve loop's tick
  phases as another, pool occupancy as a counter track, the engine's
  host work and the device's spans as two more. Traces recorded under a
  :class:`~repro_torch.serve.clock.VirtualClock` are deterministic: the
  same scripted workload emits byte-identical JSON.
* **Device spans** (:class:`DeviceSpans`, one an engine, from
  :meth:`Tracer.device_spans`) time device work without a sync of their
  own: on a CUDA device a mark is a timing event recorded on the current
  stream, placed on the tracer's clock through an anchor event that each
  tick's commit records on an idle stream beside one clock read.
  Elsewhere a mark is the clock's reading, since CPU work is
  synchronous.
* :class:`NoopTracer` — the default everywhere. Every emitter is an
  empty method and every call site is also guarded on ``.enabled``, so
  an untraced engine allocates nothing for tracing.
* :class:`MetricsRegistry` — one namespace of polled sources with
  Prometheus text exposition (:meth:`MetricsRegistry.prometheus_text`).
  Existing stats dicts (``engine.metrics``, ``engine.counters``,
  ``pool.stats()``, scheduler/loop/balancer counters) plug in as
  **sources** — callables polled at collection time — so the registry
  unifies them without forking their storage; :func:`prometheus_text`
  merges many registries (one per replica, labelled) into one
  exposition, which is how ``service.py`` and
  ``Supervisor.prometheus_text`` aggregate across replicas.

Tracing is opt-in, the ring buffer bounds memory (oldest events drop
first, ``dropped`` counts them), span emission is O(1) appends with no
I/O, and exporters only walk the buffer when asked.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager

# Trace "process" ids: Perfetto groups tracks by pid, so the serve
# loop's tick phases, the per-request lifecycles, the pool's occupancy
# counters, the engine's host work and the device's spans land in five
# separately-collapsible groups.
PID_LOOP = 0        # serve-loop tick phases (one thread track)
PID_REQUESTS = 1    # one thread track per request (tid = rid)
PID_POOL = 2        # block-pool counters + events
PID_ENGINE = 3      # the engine's host sub-spans inside a loop phase
PID_DEVICE = 4      # device spans, placed on the tracer's clock



def _cuda_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


def _cuda_stream():
    import torch
    return torch.cuda.Stream()


class NoopTracer:
    """Default tracer: every emitter is a no-op, ``enabled`` is False so
    call sites can skip even argument construction. Exporters render an
    empty trace rather than raising, so ``--trace-out`` on an untraced
    run fails loudly at the *flag* level, not deep in a serve loop."""

    enabled = False

    def instant(self, name, *, pid=0, tid=0, args=None, ts=None):
        pass

    def complete(self, name, start, duration, *, pid=0, tid=0,
                 args=None):
        pass

    def counter(self, name, values, *, pid=0, tid=0, ts=None):
        pass

    @contextmanager
    def span(self, name, *, pid=0, tid=0, args=None):
        yield

    def device_spans(self, cuda: bool):
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> int:
        raise RuntimeError("no-op tracer records nothing; construct a "
                           "Tracer and pass it to the engine")


NOOP = NoopTracer()


class Tracer(NoopTracer):
    """Bounded in-memory trace recorder with Chrome trace-event export.

    ``clock`` is any zero-argument callable returning seconds
    (``time.perf_counter`` by default, a ``VirtualClock`` in tests);
    every event is stamped with it at emission, so trace timelines and
    the serving stack's latency stats live on one time base when both
    share a clock. ``capacity`` bounds the ring buffer — the hot path
    never grows without bound; the oldest events are evicted first and
    counted in ``dropped``. ``event`` and ``stream`` make the timing
    events of device spans on a CUDA device and the idle stream their
    anchors are recorded on (``torch.cuda.Event(enable_timing=True)``
    and ``torch.cuda.Stream()`` by default; tests pass stand-ins).
    """

    enabled = True

    def __init__(self, clock=time.perf_counter, capacity: int = 65536,
                 event=_cuda_event, stream=_cuda_stream):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._new_event = event
        self._new_stream = stream
        self._recorders: list = []
        # several engines (one a replica, each on its own thread) may
        # share one tracer: the ring and ``dropped`` change together
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._events)

    # ------------------------------------------------------------- emit
    def _emit(self, ev: dict) -> None:
        with self._lock:
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

    @contextmanager
    def span(self, name, *, pid=0, tid=0, args=None):
        """Context-manager form of :meth:`complete` for host-side work
        measured in place."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, t0, self.clock() - t0, pid=pid, tid=tid,
                          args=args)

    # ------------------------------------------------------ device spans
    def device_spans(self, cuda: bool) -> "DeviceSpans":
        """A recorder of device spans for one engine (see
        :class:`DeviceSpans`), numbered in order of creation (its
        ``tid``); :meth:`chrome_trace` places what its recorders still
        hold."""
        with self._lock:
            rec = DeviceSpans(self, cuda, len(self._recorders))
            self._recorders.append(rec)
        return rec

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
        byte-identical JSON. Device spans still held by a recorder are
        placed first (waiting for the device to finish them)."""
        with self._lock:
            recorders = list(self._recorders)
        for rec in recorders:
            rec.flush()
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "tid": 0, "args": {"name": label}}
                  for pid, label in ((PID_LOOP, "serve-loop"),
                                     (PID_REQUESTS, "requests"),
                                     (PID_POOL, "kv-block-pool"),
                                     (PID_ENGINE, "engine"),
                                     (PID_DEVICE, "device"))]
        rids = sorted({e["tid"] for e in self._events
                       if e["pid"] == PID_REQUESTS})
        events.extend({"name": "thread_name", "ph": "M",
                       "pid": PID_REQUESTS, "tid": rid,
                       "args": {"name": f"request {rid}"}}
                      for rid in rids)
        events.extend(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write_chrome_trace(self, path) -> int:
        """Serialize to ``path``; returns the number of trace events
        written (metadata included)."""
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        return len(trace["traceEvents"])


class DeviceSpans:
    """One engine's device spans, placed on its tracer's clock.

    On a CUDA device a mark is a timing event recorded on the current
    stream, and a span waits here until the device has run it. At each
    tick's commit, after its sync, :meth:`commit` takes the tick's anchor
    without waiting: one clock read, then an event recorded on a stream
    that nothing else uses, so the device reaches it as it is recorded.
    The tick's spans are placed at a later commit, once that anchor has
    been reached: each mark lies its elapsed time before the anchor.
    Taken afresh every tick, so the device's and the host's clocks cannot
    drift apart across spans, and no call waits for the device. Off a
    CUDA device a mark is the clock's reading (CPU work runs as it is
    issued) and a span is emitted at once.

    Each engine keeps its own recorder, so engines that share a tracer
    (one a replica, each pumped on its own thread) place only their own
    spans, each engine's on a thread track of its own (``tid``, which
    its host sub-spans share); the lock guards against :meth:`Tracer.chrome_trace` on another
    thread, which places what is left. Spent events are recorded again,
    so a steady serve allocates none."""

    __slots__ = ("tracer", "cuda", "tid", "_pending", "_placing",
                 "_spare", "_side", "_lock")

    def __init__(self, tracer: Tracer, cuda: bool, tid: int = 0):
        self.tracer = tracer
        self.cuda = cuda
        self.tid = tid
        self._pending: list = []        # spans of the tick in flight
        self._placing: deque = deque()  # (clock, anchor, spans) a tick
        self._spare: list = []
        self._side = None               # the anchors' stream
        self._lock = threading.Lock()

    def mark(self):
        """A point on the device's timeline, for :meth:`span`."""
        if not self.cuda:
            return self.tracer.clock()
        with self._lock:
            ev = self._spare.pop() if self._spare \
                else self.tracer._new_event()
        ev.record()
        return ev

    def span(self, name: str, start, end, args=None) -> None:
        """The device work between two marks, as a span ``name`` on the
        device track."""
        if not self.cuda:
            self.tracer.complete(name, start, end - start, pid=PID_DEVICE,
                                 tid=self.tid, args=args)
            return
        with self._lock:
            self._pending.append((name, start, end, args))

    def commit(self) -> None:
        """Called once the tick's commit has synced: places the spans of
        earlier ticks whose anchors the device has reached, and takes
        this tick's anchor for its own."""
        if not self.cuda:
            return
        with self._lock:
            while self._placing and self._placing[0][1].query():
                self._place(*self._placing.popleft())
            if self._pending:
                self._anchor()

    def flush(self) -> None:
        """Places every span held, waiting for the device to finish
        them (an export, off the serve's path)."""
        if not self.cuda:
            return
        with self._lock:
            if self._pending:
                for _, _, end, _ in self._pending:
                    end.synchronize()
                self._anchor()
            while self._placing:
                now, anchor, spans = self._placing.popleft()
                anchor.synchronize()
                self._place(now, anchor, spans)

    def _anchor(self) -> None:
        if self._side is None:
            self._side = self.tracer._new_stream()
        anchor = self._spare.pop() if self._spare \
            else self.tracer._new_event()
        # the clock read before the record, as the slice's markers are
        # placed: a read after it would add the call's own time
        now = self.tracer.clock()
        anchor.record(self._side)
        self._placing.append((now, anchor, self._pending))
        self._pending = []

    def _place(self, now: float, anchor, spans: list) -> None:
        tr = self.tracer
        for name, a, b, args in spans:
            t0 = now - a.elapsed_time(anchor) / 1e3
            t1 = now - b.elapsed_time(anchor) / 1e3
            tr.complete(name, t0, t1 - t0, pid=PID_DEVICE, tid=self.tid,
                        args=args)
            self._spare += (a, b)
        self._spare.append(anchor)


class LayerSpans:
    """What a traced engine sets as ``models.moe.span_hook.hook`` on its
    own thread while it enqueues a call: a context manager that times
    each call it wraps as a device span ``name`` of ``spans`` (a
    :class:`DeviceSpans`), numbered in call order (``layer``) beside the
    call's tick and step. One an engine, re-armed by :meth:`arm` for
    every call."""

    __slots__ = ("spans", "name", "tick", "step", "layer", "_start")

    def __init__(self, spans: DeviceSpans, name: str):
        self.spans = spans
        self.name = name
        self.arm(0, "")

    def arm(self, tick: int, step: str) -> LayerSpans:
        self.tick, self.step, self.layer = tick, step, 0
        return self

    def __enter__(self):
        self._start = self.spans.mark()

    def __exit__(self, *exc):
        sp = self.spans
        sp.span(self.name, self._start, sp.mark(),
                {"tick": self.tick, "step": self.step, "layer": self.layer})
        self.layer += 1


# =========================================================== metrics
def _sanitize(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:]; everything else
    (the dots of ``serving.open_loop.ttft``-style row names, slashes of
    replica names) maps to ``_``."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


class MetricsRegistry:
    """One namespace of polled sources, with Prometheus text exposition.

    ``labels`` stamp every sample (e.g. ``{"replica": "lm/0"}``) so
    per-replica registries merge into one exposition without name
    collisions. ``source(prefix, fn)`` registers a zero-arg callable
    returning a flat dict of numbers — the bridge that puts
    ``engine.metrics`` / ``engine.counters`` / ``pool.stats()`` /
    scheduler / loop / balancer counters behind this one registry
    instead of ad-hoc dicts: sources are polled at :meth:`collect` time
    and rendered as gauges (their dict semantics: current value,
    resettable by the owner). Non-numeric source values are skipped."""

    def __init__(self, labels: dict | None = None):
        self.labels = dict(labels or {})
        self._sources: list[tuple[str, object]] = []

    def source(self, prefix: str, fn) -> None:
        """Poll ``fn()`` (a flat ``{name: number}`` dict) at collect
        time, exposing each key as gauge ``{prefix}_{key}``."""
        self._sources.append((prefix, fn))

    def collect(self) -> list:
        """``(name, labels, value)`` for every numeric key of every
        source."""
        out = []
        for prefix, fn in self._sources:
            vals = fn()
            for key in sorted(vals):
                v = vals[key]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out.append((_sanitize(f"{prefix}_{key}"), self.labels,
                            float(v)))
        return out

    def prometheus_text(self) -> str:
        return prometheus_text([self])


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_sanitize(k)}="{v}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def prometheus_text(registries) -> str:
    """Merge many registries (one per replica, each with distinguishing
    labels) into one Prometheus text exposition: ``# TYPE`` emitted once
    per metric name, samples from every registry under it."""
    by_name: dict[str, list] = {}
    for reg in registries:
        for name, labels, value in reg.collect():
            by_name.setdefault(name, []).append((labels, value))
    lines = []
    for name in sorted(by_name):
        lines.append(f"# TYPE {name} gauge")
        for labels, value in by_name[name]:
            lines.append(f"{name}{_render_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
