"""The engine's host sub-spans, device spans and prefill-padding counter
on the port's CPU engine.

* Sub-spans (``engine`` track) lie inside the loop phase that ran them,
  with that phase's tick number; device spans (``device`` track) inside
  the phase that enqueued them, one ``moe-ffn`` a MoE layer a call.
* The serve loop's own spans (pid 0) and every ``dispatch`` span are the
  reference engine's events, span for span, under a VirtualClock: the new
  instrumentation adds tracks and moves nothing on the old ones; and
  ``engine.metrics`` is still the reference's, key for key.
* Untraced, no new site reads the tracer's clock, makes an event or
  builds a span object.
* The padding counter is Σ(width − P) over the prefill calls.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serve.async_loop import AsyncServeLoop as JaxLoop
from repro.serve.clock import VirtualClock as JaxClock
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro.serve.telemetry import Tracer as JaxTracer
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.models.moe import span_hook
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.async_loop import AsyncServeLoop
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.telemetry import (PID_DEVICE, PID_ENGINE, PID_LOOP,
                                         Tracer)
from repro_torch.weights import params_from_numpy

MAX_SEQ = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense():
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


@pytest.fixture(scope="module")
def moe():
    # dropless, so a row's experts never depend on its co-batched rows
    cfg = dataclasses.replace(get_config("grok-1-314b").reduced(),
                              capacity_factor=2.0)
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


class TickingClock:
    """A clock that moves 1 µs on every read, so that spans measured
    around work have lengths and nesting is visible."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-6
        return self.t


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 250, n).tolist() for n in lens]


def _loop_serve(model, params, prompts, clock, tracer, *, max_new=4,
                engine=ServingEngine, request=Request, loop=AsyncServeLoop,
                scheduler=Scheduler, **kw):
    """Requests arriving two ticks apart through the async serve loop (the
    port's, or with the reference's classes the reference's). Returns
    (engine, streams)."""
    if engine is ServingEngine:
        kw["device"] = "cpu"
    eng = engine(model, params, batch_size=4, max_seq=MAX_SEQ, clock=clock,
                 tracer=tracer, **kw)
    lp = loop(scheduler(eng, clock=clock))
    streams = {i: [] for i in range(len(prompts))}
    handles = {}
    t = 0
    while len(handles) < len(prompts) \
            or not all(h.done for h in handles.values()):
        for i, p in enumerate(prompts):
            if i not in handles and 2 * i <= t:
                r = request(rid=i, prompt=list(p), max_new_tokens=max_new)
                r.submitted_s = clock()
                handles[i] = lp.submit(
                    r, lambda tok, lp_, rid=i: streams[rid].append(tok))
        lp.run_once()
        if hasattr(clock, "advance"):
            clock.advance(0.01)
        t += 1
        assert t < 500, "serve did not converge"
    return eng, streams


def _x(events, pid, name=None):
    return [e for e in events if e["ph"] == "X" and e["pid"] == pid
            and (name is None or e["name"] == name)]


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and \
        e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


CASES = {
    "paged": ("dense", {}, [5, 9, 7, 12, 6]),
    "chunked": ("dense", {"prefill_chunk": 8}, [21, 30, 17, 26]),
    "stripes": ("dense", {"paged": False}, [5, 9, 7, 12]),
    "moe": ("moe", {}, [5, 9, 7, 12]),
    # the target drafts for itself: k 2, every proposal accepted
    "spec": ("dense", {"speculation": 2}, [5, 9, 7, 12]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sub_spans_nest_in_their_loop_phase(request, case):
    """Every engine sub-span lies inside the loop phase it names, the
    tick-th ``dispatch`` or the ``fill`` before it; every device span
    inside the phase that enqueued it, and each ``moe-ffn`` inside its
    step's span, one a MoE layer."""
    fixture, kw, lens = CASES[case]
    model, params = request.getfixturevalue(fixture)
    if "speculation" in kw:
        kw = {**kw, "draft_model": model, "draft_params": params}
    clock = TickingClock()
    tracer = Tracer(clock=clock)
    eng, _ = _loop_serve(model, params, _prompts(lens, seed=11), clock,
                         tracer, **kw)
    events = tracer.chrome_trace()["traceEvents"]
    dispatch = _x(events, PID_LOOP, "dispatch")
    fills = _x(events, PID_LOOP, "fill")
    assert len(dispatch) == eng.ticks

    def fill_of(e):
        # the fill holding e, and the number of the tick it fed
        (f,) = [f for f in fills if _inside(e, f)]
        return sum(1 for d in dispatch if d["ts"] < f["ts"])

    subs = _x(events, PID_ENGINE)
    names = {e["name"] for e in subs}
    assert {"plan", "stage", "launch", "admit-plan", "prefill-launch",
            "prefill-wait"} <= names
    for e in subs:
        tick, phase = e["args"]["tick"], e["args"]["phase"]
        if phase == "dispatch":
            assert _inside(e, dispatch[tick]), e
        else:
            assert phase == "fill" and fill_of(e) == tick, e
    # per dispatched step: plan, then stage, then launch, one after another
    for tick in range(eng.ticks):
        mine = [e for e in subs if e["args"]["tick"] == tick
                and e["args"]["phase"] == "dispatch"]
        assert mine[0]["name"] == "plan"
        if len(mine) > 1:
            assert [e["name"] for e in mine] == ["plan", "stage", "launch"]
            assert mine[0]["ts"] + mine[0]["dur"] <= mine[1]["ts"]
            assert mine[1]["ts"] + mine[1]["dur"] <= mine[2]["ts"]
    steps = {"decode": "decode-step", "chunk": "chunk-step",
             "spec": "spec-step"}
    dev = _x(events, PID_DEVICE)
    kinds = {"chunked": "chunk-step", "spec": "spec-step"}
    assert kinds.get(case, "decode-step") in {e["name"] for e in dev}
    for e in dev:
        tick = e["args"]["tick"]
        if e["name"] == "prefill-call":
            assert fill_of(e) == tick, e
        elif e["name"] != "moe-ffn":
            assert _inside(e, dispatch[tick]), e
    launches = [e for e in subs if e["name"] == "launch"]
    assert len(launches) == sum(1 for e in dev if e["name"].endswith("-step"))
    assert {steps[e["args"]["step"]] for e in launches} == \
        {e["name"] for e in dev if e["name"].endswith("-step")}
    L = model.cfg.n_layers
    moe_spans = [e for e in dev if e["name"] == "moe-ffn"]
    outer = [e for e in dev if e["name"] != "moe-ffn"]
    if case != "moe":
        assert not moe_spans
        return
    for o in outer:
        mine = [e for e in moe_spans if e["args"]["tick"] == o["args"]["tick"]
                and e["args"]["step"] == o["name"] and _inside(e, o)]
        assert [e["args"]["layer"] for e in mine] == \
            list(range(L)) * (len(mine) // L) and len(mine) >= L, o
    n_calls = sum(1 for e in outer if e["name"] in ("decode-step",
                                                    "prefill-call"))
    assert len(moe_spans) == L * n_calls


def test_loop_spans_are_the_references():
    """Under a VirtualClock the serve loop's spans (pid 0) and every span
    named ``dispatch`` (what ``dispatch_ms.decode`` reads) are the
    reference engine's events, one for one; the port only adds the
    ``engine`` and ``device`` tracks. ``engine.metrics`` is the
    reference's, and the port's counters live beside it."""
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                               dtype=jnp.float32)
    cfg = get_config("qwen3-4b").reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = _prompts([5, 9, 7, 12, 6], seed=12)
    jclock = JaxClock()
    jtracer = JaxTracer(clock=jclock)
    jeng, jstreams = _loop_serve(jmodel, jparams, prompts, jclock, jtracer,
                                 engine=JaxEngine, request=JaxRequest,
                                 loop=JaxLoop, scheduler=JaxScheduler,
                                 block_size=8)
    clock = VirtualClock()
    tracer = Tracer(clock=clock)
    eng, streams = _loop_serve(build_model(cfg, device="cpu"), params,
                               prompts, clock, tracer, block_size=8)
    assert streams == jstreams
    ev = tracer.chrome_trace()["traceEvents"]
    jev = jtracer.chrome_trace()["traceEvents"]
    assert _x(ev, PID_LOOP) == _x(jev, PID_LOOP)
    assert [e for e in ev if e["name"] == "dispatch"] == \
        [e for e in jev if e["name"] == "dispatch"]
    assert {e["pid"] for e in ev} - {e["pid"] for e in jev} == \
        {PID_ENGINE, PID_DEVICE}
    assert eng.metrics == jeng.metrics
    assert not set(eng.counters) & set(eng.metrics)


def _make_engine(model, params, tracer=None, **kw):
    return ServingEngine(model, params, batch_size=4, max_seq=MAX_SEQ,
                         block_size=8, device="cpu", tracer=tracer, **kw)


@pytest.mark.parametrize("traced", [False, True])
def test_prefill_padding_counter(dense, moe, traced):
    """One admission batch: dense prompts share power-of-two buckets
    (5 → 8; 9, 13 → 16; 20 → 32), MoE prompts prefill one a call at
    their length. The counter is Σ rows x width and Σ(width − P), and
    traced, the ``prefill-pad`` counter events sum to the same."""
    lens = [5, 9, 13, 20]
    for (model, params), calls, computed in ((dense, 3, 8 + 2 * 16 + 32),
                                             (moe, 4, sum(lens))):
        tracer = Tracer(clock=VirtualClock()) if traced else None
        eng = _make_engine(model, params, tracer)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=2)
                for i, p in enumerate(_prompts(lens, seed=13))]
        assert eng.add_requests(reqs) == 4
        assert eng.counters == {"prefill_calls": calls,
                                "prefill_call_tokens": computed,
                                "prefill_pad_tokens": computed - sum(lens)}
        if traced:
            pads = [e for e in tracer.chrome_trace()["traceEvents"]
                    if e["name"] == "prefill-pad"]
            assert len(pads) == calls
            assert all(e["ph"] == "C" and e["pid"] == PID_ENGINE
                       for e in pads)
            assert sum(e["args"]["tokens"] for e in pads) == computed
            assert sum(e["args"]["pad"] for e in pads) == computed - sum(lens)


class Inert(Tracer):
    """Tracing off, with every way in barred: reading its clock, making a
    device event or emitting anything raises."""

    enabled = False

    def __init__(self):
        def barred(*a, **k):
            raise AssertionError("an untraced site reached the tracer")

        super().__init__(clock=barred, event=barred, stream=barred)
        self.instant = self.complete = self.counter = barred
        self.device_spans = barred


@pytest.mark.parametrize("case", ["paged", "chunked", "moe"])
def test_untraced_engine_reads_no_clock_and_makes_no_event(request,
                                                           monkeypatch,
                                                           case):
    """With tracing off the new sites read no clock, make no event and
    build no span object: every way into the tracer raises, and building
    a ``LayerSpans`` or leaving the MoE hook set would be seen."""
    fixture, kw, lens = CASES[case]
    model, params = request.getfixturevalue(fixture)

    def no_spans(*a, **k):
        raise AssertionError("a span object was built untraced")

    monkeypatch.setattr(engine_mod, "LayerSpans", no_spans)
    eng, streams = _loop_serve(model, params, _prompts(lens, seed=14),
                               VirtualClock(), Inert(), **kw)
    assert span_hook.hook is None
    assert all(streams.values()) and eng.ticks > 0
    assert eng.counters["prefill_calls"] > 0


def test_moe_streams_identical_with_tracing(moe):
    """The tiny MoE config serves the same streams with tracing on and
    off (same arrivals, same ticks); traced, every decode step holds one
    ``moe-ffn`` span a layer."""
    model, params = moe
    prompts = _prompts([5, 9, 7, 12, 6, 11], seed=15)
    out = {}
    for traced in (False, True):
        clock = VirtualClock()
        tracer = Tracer(clock=clock) if traced else None
        eng, out[traced] = _loop_serve(model, params, prompts, clock, tracer,
                                       max_new=6)
    assert out[True] == out[False]
    ev = tracer.chrome_trace()["traceEvents"]
    steps = _x(ev, PID_DEVICE, "decode-step")
    spans = _x(ev, PID_DEVICE, "moe-ffn")
    L = model.cfg.n_layers
    assert steps and len(steps) == len(
        [e for e in spans if e["args"]["step"] == "decode-step"]) // L
    for s in steps:
        layers = sorted(e["args"]["layer"] for e in spans
                        if e["args"]["step"] == "decode-step"
                        and e["args"]["tick"] == s["args"]["tick"])
        assert layers == list(range(L))


def test_engines_on_threads_share_one_tracer(moe):
    """A traced and an untraced MoE engine, each pumped on its own thread,
    and two traced ones sharing one tracer: each serves the streams it
    serves alone, the untraced one adds no span (the MoE hook is its
    thread's own), and every traced call holds one ``moe-ffn`` a layer,
    numbered 0..L-1 in order."""
    model, params = moe
    L = model.cfg.n_layers
    prompts = _prompts([5, 9, 7, 12], seed=16)
    _, alone = _loop_serve(model, params, prompts, VirtualClock(), None)
    for traced in ((True, False), (True, True)):
        tracer = Tracer()
        got, errors = {}, []

        def serve(k, on):
            try:
                got[k] = _loop_serve(model, params, prompts, time.perf_counter,
                                     tracer if on else None)
            except BaseException as e:          # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=serve, args=(k, on))
                   for k, on in enumerate(traced)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert all(streams == alone for _, streams in got.values())
        dev = _x(tracer.chrome_trace()["traceEvents"], PID_DEVICE)
        calls = [e for e in dev if e["name"] in ("decode-step",
                                                 "prefill-call")]
        spans = [e for e in dev if e["name"] == "moe-ffn"]
        assert len(spans) == L * len(calls)
        # each traced engine's steps on its own track, within its ticks
        for k, (eng, _) in got.items():
            if traced[k]:
                steps = [e for e in dev if e["name"] == "decode-step"
                         and e["tid"] == eng._spans.tid]
                assert 0 < len(steps) <= eng.ticks
        assert {e["tid"] for e in dev} == set(range(sum(traced)))
        for c in calls:
            mine = sorted(e["args"]["layer"] for e in spans
                          if e["tid"] == c["tid"]
                          and e["args"]["step"] == c["name"]
                          and _inside(e, c))
            assert mine == list(range(L)), c
        assert tracer.dropped == 0
        assert span_hook.hook is None
