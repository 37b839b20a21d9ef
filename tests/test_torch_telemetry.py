"""The port's telemetry: each case of ``tests/test_telemetry.py`` on the
port's CPU engine — tracer determinism, trace / stats reconstruction,
the metrics registry and Prometheus exposition, and streams unchanged
with tracing on (the grid without speculative decode, a later slice,
plus the stripe layout).

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
from repro_torch.serve.telemetry import (NOOP, PID_LOOP, PID_POOL,
                                         PID_REQUESTS, Counter, Gauge,
                                         Histogram, MetricsRegistry, Tracer,
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


# =================================================== registry unit tests
def test_counter_monotonic():
    c = Counter("hits")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)


def test_gauge_moves_both_ways():
    g = Gauge("depth")
    g.set(5)
    g.inc()
    g.dec(2)
    assert g.value == 4


def test_histogram_cumulative_buckets():
    h = Histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    samples = dict(h.samples())
    assert samples['_bucket{le="0.1"}'] == 1
    assert samples['_bucket{le="1.0"}'] == 3
    assert samples['_bucket{le="+Inf"}'] == 4
    assert samples["_count"] == 4
    assert samples["_sum"] == pytest.approx(6.05)


def test_registry_kind_mismatch_raises():
    reg = MetricsRegistry()
    reg.counter("ticks")
    assert reg.counter("ticks") is reg.counter("ticks")   # create-or-get
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("ticks")


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
        reg.counter("served", help="requests served").inc(i + 1)
        h = reg.histogram("wait", buckets=(1.0,))
        h.observe(0.5)
        regs.append(reg)
    text = prometheus_text(regs)
    # HELP/TYPE once per name, samples from both registries under it
    assert text.count("# TYPE served counter") == 1
    assert text.count("# HELP served requests served") == 1
    assert 'served{replica="lm/0"} 1' in text
    assert 'served{replica="lm/1"} 2' in text
    # registry labels fold into the histogram's own le label
    assert 'wait_bucket{replica="lm/0",le="1.0"} 1' in text
    assert 'wait_count{replica="lm/1"} 1' in text


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
    assert 'scheduler_completed{replica="lm/0"} 1' in text
    assert 'balancer_served{service="lm"} 1' in text
    assert "# TYPE engine_completed gauge" in text
    # fleet-level scrape: replica + balancer + supervisor accounting
    fleet = sup.prometheus_text()
    assert 'engine_completed{replica="lm/0"} 1' in fleet
    assert 'supervisor_up{service="lm"} 1' in fleet
    assert 'supervisor_restart_attempts{service="lm"} 0' in fleet
