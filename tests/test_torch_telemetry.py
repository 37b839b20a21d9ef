"""The port's telemetry: each case of ``tests/test_telemetry.py`` on the
port's CPU engine — tracer determinism, trace / stats reconstruction,
the metrics registry's sources and Prometheus exposition, and streams
unchanged with tracing on (the grid without speculative decode, a later
slice, plus the stripe layout) — and the port's device spans: placed on
the tracer's clock through the tick's anchor event (a fake event class
stands for CUDA's), held out of the ring until placed.

The load-bearing claims: (1) a scripted workload under a VirtualClock
emits **byte-identical** trace JSON run to run, (2) the trace's queued
span and TTFT are the *same numbers* the scheduler/engine report, and
(3) turning tracing on changes no token stream.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.async_loop import AsyncServeLoop
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.telemetry import (NOOP, PID_DEVICE, PID_LOOP,
                                         PID_POOL, PID_REQUESTS, LayerSpans,
                                         MetricsRegistry, Tracer,
                                         prometheus_text)

MAX_SEQ = 64


# ===================================================== tracer unit tests
def test_ring_buffer_bounds_and_counts_drops():
    vc = VirtualClock()
    tr = Tracer(clock=vc, capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4
    assert tr.dropped == 6
    names = [e["name"] for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] == "i"]
    assert names == ["e6", "e7", "e8", "e9"]     # oldest evicted first
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 6


def test_capacity_must_be_positive():
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_noop_is_default_and_inert(tmp_path):
    assert NOOP.enabled is False
    NOOP.instant("x")
    NOOP.complete("x", 0.0, 1.0)
    NOOP.counter("x", {"v": 1})
    with NOOP.span("x"):
        pass
    assert NOOP.chrome_trace()["traceEvents"] == []
    with pytest.raises(RuntimeError, match="no-op tracer"):
        NOOP.write_chrome_trace(tmp_path / "t.json")


def test_span_context_manager_measures_clock():
    vc = VirtualClock()
    tr = Tracer(clock=vc)
    with tr.span("work", pid=PID_LOOP, args={"k": 1}):
        vc.advance(0.5)
    (ev,) = [e for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert ev["name"] == "work"
    assert ev["ts"] == 0.0 and ev["dur"] == 500000.0
    assert ev["args"] == {"k": 1}


def test_negative_duration_clamped():
    tr = Tracer(clock=VirtualClock())
    tr.complete("x", 1.0, -0.5)
    (ev,) = [e for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert ev["dur"] == 0.0


class FakeDevice:
    """A device clock of its own (seconds, far from the host's), and the
    events recorded on it: ``record`` stamps the device's time,
    ``elapsed_time`` is in ms as CUDA's and, as CUDA's, refuses an event
    the device has not reached. While ``behind`` is set, what is recorded
    is not reached until ``synchronize`` (or ``catch_up``)."""

    def __init__(self, t=5000.0):
        self.t = t
        self.made = 0
        self.streams = 0
        self.behind = False
        self.recorded = []

    def event(self):
        self.made += 1
        return FakeEvent(self)

    def stream(self):
        self.streams += 1
        return object()

    def catch_up(self):
        for ev in self.recorded:
            ev.done = True


class FakeEvent:
    def __init__(self, device):
        self.device = device
        self.t = None
        self.done = False
        self.stream = None

    def record(self, stream=None):
        self.t, self.stream = self.device.t, stream
        self.done = not self.device.behind
        self.device.recorded.append(self)

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        if not (self.done and end.done):
            raise RuntimeError("CUDA error: device not ready")
        return (end.t - self.t) * 1e3


def _fake_tracer(dev, **kw):
    return Tracer(event=dev.event, stream=dev.stream, **kw)


def test_device_spans_are_placed_through_the_anchor():
    """A tick's device spans wait for its commit, which takes the anchor
    without waiting: an event on a stream of its own, beside the clock's
    reading; they are placed at a later commit (or an export), each mark
    its elapsed device time before the anchor. Spent events are recorded
    again."""
    vc, dev = VirtualClock(10.0), FakeDevice()
    tr = _fake_tracer(dev, clock=vc)
    rec = tr.device_spans(True)
    a = rec.mark()
    dev.t += 0.002
    b = rec.mark()
    dev.t += 0.001
    c = rec.mark()
    dev.t += 0.004
    d = rec.mark()
    rec.span("decode-step", a, d, {"tick": 3})
    rec.span("moe-ffn", b, c)
    dev.t += 0.010                      # the commit's sync: device idle
    vc.advance(0.5)
    rec.commit()
    assert len(tr) == 0                 # the anchor is taken, not waited on
    assert dev.made == 5 and dev.streams == 1
    assert dev.recorded[-1].stream is not None     # on the anchors' stream
    # the next tick (the device clock ran 1 s fast against the host's
    # meanwhile): its commit places the first tick's spans
    e0 = rec.mark()
    dev.t += 2.0
    e1 = rec.mark()
    rec.span("prefill-call", e0, e1)
    vc.advance(1.0)
    rec.commit()
    spans = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["pid"]) for e in spans] == \
        [("decode-step", PID_DEVICE), ("moe-ffn", PID_DEVICE),
         ("prefill-call", PID_DEVICE)]
    # the anchor at 10.5 s on the clock is 17 ms of device time after a
    assert spans[0]["ts"] == pytest.approx(10.483e6)
    assert spans[0]["dur"] == pytest.approx(7000.0)
    assert spans[0]["args"] == {"tick": 3}
    assert spans[1]["ts"] == pytest.approx(10.485e6)
    assert spans[1]["dur"] == pytest.approx(1000.0)
    # placed by the export through its own tick's anchor, at 11.5 s
    assert spans[2]["ts"] == pytest.approx(9.5e6)
    assert spans[2]["dur"] == pytest.approx(2.0e6)
    assert dev.made == 7 and dev.streams == 1
    # a tick's marks and anchor come from the spare events now
    rec.span("x", rec.mark(), rec.mark())
    rec.commit()
    rec.commit()                        # nothing pending: no anchor
    assert dev.made == 7
    tr.chrome_trace()
    assert dev.made == 7


def test_device_spans_wait_for_their_anchor():
    """A commit places only the ticks whose anchor the device has
    reached; the rest wait for a later commit."""
    vc, dev = VirtualClock(1.0), FakeDevice()
    tr = _fake_tracer(dev, clock=vc)
    rec = tr.device_spans(True)
    dev.behind = True
    rec.span("decode-step", rec.mark(), rec.mark(), {"tick": 0})
    rec.commit()
    rec.span("decode-step", rec.mark(), rec.mark(), {"tick": 1})
    rec.commit()                        # tick 0's anchor not reached yet
    assert len(tr) == 0
    dev.catch_up()
    dev.behind = False
    rec.commit()
    assert [e["args"]["tick"] for e in tr._events] == [0, 1]


def test_engines_sharing_a_tracer_place_only_their_own_spans():
    """Two engines' recorders on one tracer: one's commit neither reads
    nor drops the other's spans, though the other's events are not yet
    reached (CUDA would refuse their elapsed time)."""
    vc, dev = VirtualClock(1.0), FakeDevice()
    tr = _fake_tracer(dev, clock=vc)
    rec_a, rec_b = tr.device_spans(True), tr.device_spans(True)
    rec_a.span("decode-step", rec_a.mark(), rec_a.mark(), {"tick": 0})
    dev.behind = True                   # B's step is still on the device
    rec_b.span("decode-step", rec_b.mark(), rec_b.mark(), {"tick": 7})
    dev.behind = False
    rec_a.commit()
    rec_a.span("decode-step", rec_a.mark(), rec_a.mark(), {"tick": 1})
    rec_a.commit()
    assert [e["args"]["tick"] for e in tr._events] == [0]
    dev.catch_up()
    rec_b.commit()
    rec_b.commit()
    assert sorted(e["args"]["tick"] for e in tr._events) == [0, 7]
    ticks = sorted(e["args"]["tick"] for e in tr.chrome_trace()
                   ["traceEvents"] if e["ph"] == "X")
    assert ticks == [0, 1, 7] and tr.dropped == 0


def test_device_spans_on_threads_are_all_placed():
    """Four recorders on one tracer, each committed on its own thread
    while an export may run: every span is placed once, none dropped."""
    import threading

    dev = FakeDevice()
    tr = _fake_tracer(dev)
    recs = [tr.device_spans(True) for _ in range(4)]

    def serve(k):
        rec = recs[k]
        for tick in range(300):
            rec.span("decode-step", rec.mark(), rec.mark(),
                     {"tick": tick, "engine": k})
            rec.commit()

    threads = [threading.Thread(target=serve, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    tr.chrome_trace()
    for t in threads:
        t.join()
    got = sorted((e["args"]["engine"], e["args"]["tick"])
                 for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X")
    assert got == [(k, t) for k in range(4) for t in range(300)]
    assert tr.dropped == 0


def test_host_device_spans_are_stamped_by_the_clock():
    """Off a CUDA device a mark is the clock's reading: the span is
    emitted at once, and no event or stream is made."""
    vc, dev = VirtualClock(2.0), FakeDevice()
    tr = _fake_tracer(dev, clock=vc)
    rec = tr.device_spans(False)
    a = rec.mark()
    vc.advance(0.25)
    with LayerSpans(rec, "moe-ffn").arm(7, "decode-step"):
        vc.advance(0.5)
    rec.span("decode-step", a, rec.mark())
    rec.commit()
    spans = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"], e.get("args")) for e in spans] \
        == [("moe-ffn", 2.25e6, 0.5e6,
             {"tick": 7, "step": "decode-step", "layer": 0}),
            ("decode-step", 2.0e6, 0.75e6, None)]
    assert dev.made == 0 and dev.streams == 0


def test_device_spans_count_in_the_ring_when_placed():
    """Device spans not yet placed hold no slot of the ring; once placed
    they are events like any other: the oldest drop first and ``dropped``
    counts them."""
    vc, dev = VirtualClock(), FakeDevice()
    tr = _fake_tracer(dev, clock=vc, capacity=4)
    rec = tr.device_spans(True)
    for i in range(3):
        tr.instant(f"e{i}")
    marks = [rec.mark() for _ in range(6)]
    for i in range(3):
        rec.span(f"d{i}", marks[2 * i], marks[2 * i + 1])
    rec.commit()
    assert len(tr) == 3 and tr.dropped == 0
    names = [e["name"] for e in tr.chrome_trace()["traceEvents"]
             if e["ph"] in "iX"]
    assert len(tr) == 4 and tr.dropped == 2
    assert names == ["e2", "d0", "d1", "d2"]
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 2


def test_noop_device_spans_are_inert():
    assert NOOP.device_spans(True) is None
    assert NOOP.chrome_trace()["traceEvents"] == []


# =================================================== registry unit tests
def test_registry_source_polls_and_skips_non_numeric():
    state = {"completed": 1, "label": "text", "flag": True, "ratio": 0.5}
    reg = MetricsRegistry(labels={"replica": "lm/0"})
    reg.source("engine", lambda: state)
    names = {name for name, *_ in reg.collect()}
    assert "engine_completed" in names and "engine_ratio" in names
    assert "engine_label" not in names     # non-numeric skipped
    assert "engine_flag" not in names      # bools are not metrics
    state["completed"] = 7                 # polled, not copied
    text = reg.prometheus_text()
    assert 'engine_completed{replica="lm/0"} 7' in text


def test_prometheus_merge_across_registries():
    regs = []
    for i in range(2):
        reg = MetricsRegistry(labels={"replica": f"lm/{i}"})
        reg.source("engine", lambda i=i: {"served": i + 1,
                                          "wait_s": 0.5 * i})
        reg.source("engine", lambda: {"prefill_calls": 3})
        regs.append(reg)
    text = prometheus_text(regs)
    # TYPE once per name, samples from both registries under it, two
    # sources of one prefix side by side
    assert text.count("# TYPE engine_served gauge") == 1
    assert 'engine_served{replica="lm/0"} 1' in text
    assert 'engine_served{replica="lm/1"} 2' in text
    assert 'engine_wait_s{replica="lm/1"} 0.5' in text
    assert text.count("# TYPE engine_prefill_calls gauge") == 1
    assert 'engine_prefill_calls{replica="lm/1"} 3' in text


def test_metric_names_sanitized():
    reg = MetricsRegistry()
    reg.source("serving", lambda: {"open_loop.ttft/p50": 3})
    text = reg.prometheus_text()
    assert "serving_open_loop_ttft_p50 3" in text


# ================================================== engine integration
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, L).tolist() for L in lens]


def _scripted_serve(model, params, prompts, **kw):
    """One deterministic serve: all requests submitted at t=0, the loop
    pumped on a virtual 10 ms tick with the tracer on the same clock.
    Returns (tracer, scheduler, requests)."""
    vc = VirtualClock()
    tracer = Tracer(clock=vc)
    eng = ServingEngine(model, params, batch_size=4, max_seq=MAX_SEQ,
                        clock=vc, tracer=tracer, device="cpu", **kw)
    sched = Scheduler(eng, clock=vc)
    loop = AsyncServeLoop(sched)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    handles = []
    for r in reqs:
        r.submitted_s = vc()            # scheduler timeline, not wall
        handles.append(loop.submit(r))
    t = 0
    while not all(h.done for h in handles):
        loop.run_once()
        vc.advance(0.01)
        t += 1
        assert t < 500, "serve did not converge"
    return tracer, sched, reqs


def test_trace_byte_identical_under_virtual_clock(stack, tmp_path):
    """Acceptance: two runs of the same scripted workload emit
    byte-identical trace JSON."""
    cfg, model, params = stack
    lens = [5, 9, 7, 12, 6]
    paths = []
    for run in range(2):
        tracer, _, _ = _scripted_serve(model, params,
                                       _prompts(cfg, lens, seed=2))
        p = tmp_path / f"run{run}.json"
        tracer.write_chrome_trace(p)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_trace_validates_and_covers_all_tracks(stack, tmp_path):
    cfg, model, params = stack
    tracer, _, reqs = _scripted_serve(model, params,
                                      _prompts(cfg, [5, 9, 7], seed=3))
    p = tmp_path / "t.json"
    tracer.write_chrome_trace(p)
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "scripts"))
    try:
        from check_trace import validate
    finally:
        sys.path.pop(0)
    assert validate(p) == []
    events = json.loads(p.read_text())["traceEvents"]
    pids = {e["pid"] for e in events}
    assert {PID_LOOP, PID_REQUESTS, PID_POOL} <= pids
    names = {e["name"] for e in events}
    assert {"submit", "queued", "admitted", "first_token", "request",
            "prefill", "decode", "plan-window", "commit-wait",
            "pool"} <= names
    # one lifecycle span per request, every one completed
    lifecycle = [e for e in events
                 if e["name"] == "request" and e["ph"] == "X"]
    assert sorted(e["tid"] for e in lifecycle) \
        == sorted(r.rid for r in reqs)
    assert all(e["args"]["status"] == "completed" for e in lifecycle)


def test_trace_reconstructs_ttft_and_queue_wait(stack):
    """Acceptance: per-request spans reconstruct TTFT and queue wait
    equal to the engine's/scheduler's own reported values."""
    cfg, model, params = stack
    tracer, sched, reqs = _scripted_serve(
        model, params, _prompts(cfg, [5, 9, 7, 12, 6], seed=4))
    events = tracer.chrome_trace()["traceEvents"]

    def us(x):
        return round(x * 1e6, 1)

    # queued spans carry the exact same durations the stats recorded
    queued = sorted(e["dur"] for e in events if e["name"] == "queued")
    assert queued == sorted(us(w) for w in sched.stats.queue_wait_s)

    by_rid = {}
    for e in events:
        if e["name"] in ("submit", "first_token", "request"):
            by_rid.setdefault(e["tid"], {})[e["name"]] = e
    for r in reqs:
        ev = by_rid[r.rid]
        # TTFT from the trace == TTFT from the engine's stamps
        assert ev["first_token"]["ts"] - ev["submit"]["ts"] \
            == pytest.approx(us(r.first_token_s - r.submitted_s))
        # lifecycle span == the request's reported latency
        assert ev["request"]["dur"] == pytest.approx(us(r.latency_s))
        assert ev["request"]["args"]["tokens"] == len(r.out_tokens)


def test_tick_phases_cover_the_pipeline(stack):
    cfg, model, params = stack
    tracer, sched, _ = _scripted_serve(model, params,
                                       _prompts(cfg, [5, 7], seed=5))
    loop_spans = [e for e in tracer.chrome_trace()["traceEvents"]
                  if e["pid"] == PID_LOOP and e["ph"] == "X"]
    phases = {e["name"] for e in loop_spans}
    assert {"apply-cancels", "fill", "dispatch", "plan-window",
            "commit-wait", "emit"} <= phases
    # committed ticks all carry the full dispatch->commit split
    n_commit = sum(1 for e in loop_spans if e["name"] == "commit-wait")
    assert n_commit == sched.stats.ticks
    for e in loop_spans:
        assert e["dur"] >= 0.0


def test_pool_track_alloc_free_and_occupancy(stack):
    cfg, model, params = stack
    tracer, _, _ = _scripted_serve(model, params,
                                   _prompts(cfg, [5, 9, 7], seed=6))
    events = tracer.chrome_trace()["traceEvents"]
    pool = [e for e in events if e["pid"] == PID_POOL]
    assert any(e["name"] == "alloc" for e in pool)
    assert any(e["name"] == "free" for e in pool)
    counters = [e for e in pool if e["ph"] == "C" and e["name"] == "pool"]
    assert counters
    assert all(set(e["args"]) == {"used", "shared", "cached"}
               for e in counters)
    # everything retired: the last occupancy sample (emitted on the
    # final free) shows no held blocks
    assert counters[-1]["args"]["used"] == 0


# ------------------------------------------ tracing-on bit-identity grid
GRID = {
    "paged": ({}, [5, 9, 7, 12, 6]),
    "kernel": ({"use_kernel": True}, [5, 9, 7, 12, 6]),
    "shared_prefix": ({}, None),
    "chunked": ({"prefill_chunk": 8}, [21, 30, 17, 26, 19]),
    "stripes": ({"paged": False}, [5, 9, 7, 12, 6]),
}


@pytest.mark.parametrize("config", list(GRID))
def test_streams_bit_identical_with_tracing_enabled(stack, config):
    """Acceptance: async streams stay bit-identical to the sync drain
    with tracing ENABLED, across the engine grid — observation must not
    perturb the system."""
    cfg, model, params = stack
    kw, lens = GRID[config]
    if config == "shared_prefix":
        stem = _prompts(cfg, [20], seed=7)[0]
        tails = _prompts(cfg, [3, 5, 2], seed=8)
        prompts = [list(stem)] + [stem + tl for tl in tails]
    else:
        prompts = _prompts(cfg, lens, seed=9)

    vc = VirtualClock()
    tracer = Tracer(clock=vc)
    eng = ServingEngine(model, params, batch_size=4, max_seq=MAX_SEQ,
                        clock=vc, tracer=tracer, device="cpu", **kw)
    loop = AsyncServeLoop(Scheduler(eng, clock=vc))
    streams = {i: [] for i in range(len(prompts))}
    handles = {}
    t = 0
    while len(handles) < len(prompts) \
            or not all(h.done for h in handles.values()):
        # arrivals staggered 2 ticks apart: mid-decode admissions
        for i, p in enumerate(prompts):
            if i not in handles and 2 * i <= t:
                handles[i] = loop.submit(
                    Request(rid=i, prompt=list(p), max_new_tokens=4),
                    lambda tok, lp, rid=i: streams[rid].append(tok))
        loop.run_once()
        vc.advance(0.01)
        t += 1
        assert t < 500, "serve did not converge"
    assert len(tracer) > 0              # tracing actually recorded

    ref = ServingEngine(model, params, batch_size=4, max_seq=MAX_SEQ,
                        device="cpu", **kw)   # untraced synchronous run
    ref_done = ref.run([Request(rid=100 + i, prompt=list(p),
                                max_new_tokens=4)
                        for i, p in enumerate(prompts)])
    assert streams == {r.rid - 100: r.out_tokens for r in ref_done}


# ---------------------------------------------- kernel dispatch counters
def test_kernel_dispatch_counters_reach_prometheus(stack):
    """`kernel_windows` counts fused multi-token launches (verify +
    chunk ticks) and `kernel_positions` the total real query positions
    through the paged kernel — so a Prometheus scrape tells fused-window
    launches from single-token decode launches. Gather-path engines
    must leave both at zero."""
    cfg, model, params = stack
    prompts = _prompts(cfg, [20, 9], seed=21)
    eng = ServingEngine(model, params, batch_size=2, max_seq=MAX_SEQ,
                        block_size=8, use_kernel=True, prefill_chunk=8,
                        device="cpu")
    eng.run([Request(rid=i, prompt=list(p), max_new_tokens=4)
             for i, p in enumerate(prompts)])
    # chunk ticks ran fused windows; decode ticks added 1 position per
    # active row with no window launch
    assert eng.metrics["kernel_windows"] > 0
    assert eng.metrics["chunk_steps"] >= eng.metrics["kernel_windows"]
    assert eng.metrics["kernel_positions"] > eng.metrics["kernel_windows"]
    reg = MetricsRegistry(labels={"replica": "lm/0"})
    reg.source("engine", lambda: eng.metrics)
    text = reg.prometheus_text()
    assert 'engine_kernel_windows{replica="lm/0"}' in text
    assert 'engine_kernel_positions{replica="lm/0"}' in text
    gather = ServingEngine(model, params, batch_size=2, max_seq=MAX_SEQ,
                           block_size=8, use_kernel=False, prefill_chunk=8,
                           device="cpu")
    gather.run([Request(rid=10 + i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(prompts)])
    assert gather.metrics["kernel_windows"] == 0
    assert gather.metrics["kernel_positions"] == 0


# ------------------------------------------------- service-level scrape
def test_service_and_supervisor_prometheus_exposition(stack):
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.serve.service import (make_lm_service,
                                           service_prometheus_text)
    cfg, model, params = stack
    sup = Supervisor()
    svc = make_lm_service("lm", model, params, n_replicas=1,
                          batch_size=2, max_seq=MAX_SEQ, supervisor=sup,
                          device="cpu")
    sup.start_all()
    prompt = _prompts(cfg, [5], seed=10)[0]
    out = svc.balancer({"prompt": prompt, "max_new_tokens": 3})
    assert len(out["tokens"]) == 3
    text = service_prometheus_text(svc)
    assert 'engine_completed{replica="lm/0"} 1' in text
    # the port's own counters beside the reference's: one prefill call of
    # 5 prompt tokens in a bucket of 8
    assert 'engine_prefill_calls{replica="lm/0"} 1' in text
    assert 'engine_prefill_pad_tokens{replica="lm/0"} 3' in text
    assert 'scheduler_completed{replica="lm/0"} 1' in text
    assert 'balancer_served{service="lm"} 1' in text
    assert "# TYPE engine_completed gauge" in text
    # fleet-level scrape: replica + balancer + supervisor accounting
    fleet = sup.prometheus_text()
    assert 'engine_completed{replica="lm/0"} 1' in fleet
    assert 'supervisor_up{service="lm"} 1' in fleet
    assert 'supervisor_restart_attempts{service="lm"} 0' in fleet
