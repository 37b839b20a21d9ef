"""Serve-loop telemetry: span tracing + a unified metrics registry (own
copy of the reference's ``serve/telemetry.py``; host-only Python).

* :class:`Tracer` — a clock-injectable event recorder. Components emit
  **spans** (named intervals: a request's queued/prefill/decode phases,
  a tick's fill/dispatch/plan/commit/emit phases) and **instants**
  (admit, park, preempt, copy-on-write, shed, cancel) into a bounded
  ring buffer; :meth:`Tracer.chrome_trace` renders the buffer as Chrome
  trace-event JSON that Perfetto loads directly — requests as one named
  track each, the serve loop's tick phases as another, pool occupancy
  as a counter track. Traces recorded under a
  :class:`~repro_torch.serve.clock.VirtualClock` are deterministic: the
  same scripted workload emits byte-identical JSON.
* :class:`NoopTracer` — the default everywhere. Every emitter is an
  empty method and every call site is also guarded on ``.enabled``, so
  an untraced engine allocates nothing for tracing.
* :class:`MetricsRegistry` — one namespace of counters / gauges /
  histograms with Prometheus text exposition
  (:meth:`MetricsRegistry.prometheus_text`). Existing stats dicts
  (``engine.metrics``, ``pool.stats()``, scheduler/loop/balancer
  counters) plug in as **sources** — callables polled at collection
  time — so the registry unifies them without forking their storage;
  :func:`prometheus_text` merges many registries (one per replica,
  labelled) into one exposition, which is how ``service.py`` and
  ``Supervisor.prometheus_text`` aggregate across replicas.

Tracing is opt-in, the ring buffer bounds memory (oldest events drop
first, ``dropped`` counts them), span emission is O(1) appends with no
I/O, and exporters only walk the buffer when asked.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

# Trace "process" ids: Perfetto groups tracks by pid, so the serve
# loop's tick phases, the per-request lifecycles, and the pool's
# occupancy counters land in three separately-collapsible groups.
PID_LOOP = 0        # serve-loop tick phases (one thread track)
PID_REQUESTS = 1    # one thread track per request (tid = rid)
PID_POOL = 2        # block-pool counters + events


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

    def write_chrome_trace(self, path) -> int:
        """Serialize to ``path``; returns the number of trace events
        written (metadata included)."""
        trace = self.chrome_trace()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        return len(trace["traceEvents"])


# =========================================================== metrics
def _sanitize(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:]; everything else
    (the dots of ``serving.open_loop.ttft``-style row names, slashes of
    replica names) maps to ``_``."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in name)


class Counter:
    """Monotonic count (``inc`` only; resets are a new process)."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up ({n})")
        self.value += n

    def samples(self):
        return [("", self.value)]


class Gauge:
    """Point-in-time value (queue depth, pool occupancy)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def samples(self):
        return [("", self.value)]


# Latency-shaped default buckets (seconds): sub-ms host work through
# multi-second drains, plus the paper's 700 ms budget as an edge.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   0.7, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Cumulative-bucket histogram, Prometheus exposition semantics:
    ``_bucket{le=...}`` counts observations <= bound, plus ``_sum`` and
    ``_count``."""

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"{name}: need >= 1 bucket")
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1

    def samples(self):
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum = c  # counts are already cumulative per observe()
            out.append((f'_bucket{{le="{b}"}}', cum))
        out.append(('_bucket{le="+Inf"}', self.count))
        out.append(("_sum", self.sum))
        out.append(("_count", self.count))
        return out


class MetricsRegistry:
    """One namespace of instruments + polled sources, with Prometheus
    text exposition.

    ``labels`` stamp every sample (e.g. ``{"replica": "lm/0"}``) so
    per-replica registries merge into one exposition without name
    collisions. ``source(prefix, fn)`` registers a zero-arg callable
    returning a flat dict of numbers — the bridge that puts
    ``engine.metrics`` / ``pool.stats()`` / scheduler / loop / balancer
    counters behind this one registry instead of five ad-hoc dicts:
    sources are polled at :meth:`collect` time and rendered as gauges
    (their dict semantics: current value, resettable by the owner).
    Non-numeric source values are skipped."""

    def __init__(self, labels: dict | None = None):
        self.labels = dict(labels or {})
        self._instruments: dict[str, object] = {}
        self._sources: list[tuple[str, object]] = []

    # ------------------------------------------------------ instruments
    def _get(self, cls, name: str, help: str, **kw):
        name = _sanitize(name)
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, help, **kw)
        elif not isinstance(inst, cls):
            raise ValueError(f"{name}: already registered as "
                             f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def source(self, prefix: str, fn) -> None:
        """Poll ``fn()`` (a flat ``{name: number}`` dict) at collect
        time, exposing each key as gauge ``{prefix}_{key}``."""
        self._sources.append((prefix, fn))

    # ------------------------------------------------------- collection
    def collect(self) -> list:
        """``(name, kind, help, labels, samples)`` tuples for every
        instrument plus every source key — ``samples`` is a list of
        ``(suffix, value)``."""
        out = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            out.append((inst.name, inst.kind, inst.help, self.labels,
                        inst.samples()))
        for prefix, fn in self._sources:
            vals = fn()
            for key in sorted(vals):
                v = vals[key]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out.append((_sanitize(f"{prefix}_{key}"), "gauge", "",
                            self.labels, [("", float(v))]))
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
    labels) into one Prometheus text exposition: ``# HELP``/``# TYPE``
    emitted once per metric name, samples from every registry under
    it."""
    by_name: dict[str, list] = {}
    meta: dict[str, tuple] = {}
    for reg in registries:
        for name, kind, help, labels, samples in reg.collect():
            by_name.setdefault(name, []).append((labels, samples))
            if name not in meta or (help and not meta[name][1]):
                meta[name] = (kind, help)
    lines = []
    for name in sorted(by_name):
        kind, help = meta[name]
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, samples in by_name[name]:
            for suffix, value in samples:
                if "{" in suffix and labels:
                    # fold the registry labels in with the sample's own
                    # (histogram buckets carry le="...")
                    base, inner = suffix.split("{", 1)
                    lab = _render_labels(labels)
                    lines.append(f"{name}{base}{lab[:-1]},{inner}"
                                 f" {_fmt(value)}")
                else:
                    lines.append(f"{name}{suffix}{_render_labels(labels)}"
                                 f" {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)
