"""The port's async continuous-batching serve loop, driven on a
``VirtualClock`` with scripted arrival traces (no wall-clock sleeps):
each case of ``tests/test_streaming.py`` on the port's CPU engine.

The grid holds the port's async streams to the port's *own* synchronous
drain, bit for bit (tokens exact and logprobs within 2e-5 where the
arrival pattern changes whether a chunk window or a prefill computes a
prompt's last logits, as the reference's test allows) — not to the
reference's async run, whose
async-vs-sync exactness fails on the reference side by a 1.4e-6 logprob
difference between two XLA programs (ROADMAP.md Queue 3). The
speculative entry is a self-draft engine (k = 3), as in the reference's
grid. Every threaded wait is bounded, then asserted complete.
"""
import asyncio
import threading

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.configs.base import get_config
from repro_torch.core.balancer import deploy
from repro_torch.core.services import (Replica, RequestError, Service,
                                       ServiceError)
from repro_torch.models.model import build_model
from repro_torch.serve.async_loop import AsyncServeLoop
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.service import make_lm_service

MAX_SEQ = 64
WAIT_S = 120.0


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


def _build_loop(model, params, *, batch_size=4, vc=None, **kw):
    vc = vc or VirtualClock()
    eng = ServingEngine(model, params, batch_size=batch_size,
                        max_seq=MAX_SEQ, clock=vc, device="cpu", **kw)
    sched = Scheduler(eng, clock=vc)
    return eng, sched, AsyncServeLoop(sched), vc


def _pump(loop, vc, *, until, limit=2000):
    t = 0
    while not until():
        loop.run_once()
        vc.advance(0.01)
        t += 1
        assert t < limit, "serve loop did not converge"
    return t


GRID = {
    "paged": ({}, [5, 9, 7, 12, 6]),
    "kernel": ({"use_kernel": True}, [5, 9, 7, 12, 6]),
    "shared_prefix": ({}, None),
    "chunked": ({"prefill_chunk": 8}, [21, 30, 17, 26, 19]),
    "stripes": ({"paged": False}, [5, 9, 7, 12, 6]),
    "speculative": ("SPEC", [5, 9, 7, 12, 6]),
}


@pytest.mark.parametrize("config", list(GRID))
def test_async_streams_bit_identical_to_sync_drain(stack, config):
    """Staggered arrivals through the async loop emit, per request, the
    token / logprob stream the port's synchronous drain emits — greedy
    and sampled."""
    cfg, model, params = stack
    kw, lens = GRID[config]
    if kw == "SPEC":
        kw = {"draft_model": model, "draft_params": params,
              "speculation": 3}
    if config == "shared_prefix":
        stem = _prompts(cfg, [20], seed=7)[0]
        tails = _prompts(cfg, [3, 5, 2, 4], seed=8)
        prompts = [list(stem)] + [stem + tl for tl in tails]
    else:
        prompts = _prompts(cfg, lens, seed=2)

    def mk(base):
        return [Request(rid=base + i, prompt=list(p), max_new_tokens=4,
                        sampling=SamplingParams(temperature=0.8, top_k=8,
                                                seed=3)
                        if i == 1 else SamplingParams())
                for i, p in enumerate(prompts)]

    eng, sched, loop, vc = _build_loop(model, params, **kw)
    reqs = mk(0)
    streams = {r.rid: [] for r in reqs}
    handles = {}

    def drive():
        for i, r in enumerate(reqs):
            if r.rid not in handles and 2 * i <= drive.t:
                handles[r.rid] = loop.submit(
                    r, lambda tok, lp, rid=r.rid:
                        streams[rid].append((tok, lp)))
        drive.t += 1
        return len(handles) == len(reqs) \
            and all(h.done for h in handles.values())
    drive.t = 0
    _pump(loop, vc, until=drive)

    ref = ServingEngine(model, params, batch_size=4, max_seq=MAX_SEQ,
                        device="cpu", **kw)
    ref_done = {r.rid - 100: r for r in ref.run(mk(100))}
    assert len(ref_done) == len(reqs)
    for r in reqs:
        reply = handles[r.rid].reply
        toks = [t for t, _ in streams[r.rid]]
        lps = [lp for _, lp in streams[r.rid]]
        assert toks == reply["tokens"] == ref_done[r.rid].out_tokens, \
            (config, r.rid)
        assert lps == reply["logprobs"], (config, r.rid)
        if config in ("shared_prefix", "chunked"):
            # the arrival pattern decides which computation yields the
            # prompt-final logits (a chunk window over the pool, or a
            # prefill): tokens stay exact, logprobs to the 2e-5 contract
            # (as in tests/test_streaming.py)
            np.testing.assert_allclose(lps, ref_done[r.rid].out_logprobs,
                                       rtol=2e-5, atol=2e-5)
        else:
            assert lps == ref_done[r.rid].out_logprobs, (config, r.rid)
        assert len(toks) == 4
    if eng.paged:
        eng.pool.check()
        assert eng.pool.available == eng.pool.total


def test_tokens_stream_incrementally_not_at_completion(stack):
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params)
    (p,) = _prompts(cfg, [6], seed=3)
    seen_ticks = []
    tick = [0]
    h = loop.submit(Request(rid=1, prompt=p, max_new_tokens=6),
                    lambda t, lp: seen_ticks.append(tick[0]))

    def drive():
        tick[0] += 1
        return h.done
    _pump(loop, vc, until=drive)
    assert len(seen_ticks) == 6
    assert seen_ticks[0] < seen_ticks[-1]
    assert seen_ticks == sorted(seen_ticks)
    assert h.reply["tokens"] == h.request.out_tokens


def test_cancel_mid_stream_recycles_slot_and_blocks(stack):
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=2)
    pa, pb, pc = _prompts(cfg, [5, 8, 6], seed=4)
    got_a = []
    ha = loop.submit(Request(rid=1, prompt=pa, max_new_tokens=30),
                     lambda t, lp: got_a.append(t))
    hb = loop.submit(Request(rid=2, prompt=pb, max_new_tokens=4))
    hc = loop.submit(Request(rid=3, prompt=pc, max_new_tokens=4))
    _pump(loop, vc, until=lambda: len(got_a) >= 3)
    ha.cancel()
    _pump(loop, vc, until=lambda: ha.done)
    assert ha.cancelled
    assert ha.reply["tokens"] == got_a
    assert 3 <= len(got_a) < 30
    assert eng.metrics["cancelled"] == 1
    _pump(loop, vc, until=lambda: hb.done and hc.done)
    assert len(hb.reply["tokens"]) == len(hc.reply["tokens"]) == 4
    assert sched.stats.completed == 2
    eng.pool.check()
    assert eng.pool.available == eng.pool.total


def test_cancel_while_queued_never_occupies_a_slot(stack):
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=1)
    pa, pb = _prompts(cfg, [5, 7], seed=5)
    ha = loop.submit(Request(rid=1, prompt=pa, max_new_tokens=6))
    hb = loop.submit(Request(rid=2, prompt=pb, max_new_tokens=2))
    _pump(loop, vc, until=lambda: len(ha.request.out_tokens) >= 1)
    hb.cancel()
    _pump(loop, vc, until=lambda: hb.done)
    assert hb.cancelled and hb.reply["tokens"] == []
    _pump(loop, vc, until=lambda: ha.done)
    assert len(ha.reply["tokens"]) == 6
    assert hb.request.out_tokens == []
    assert eng.pool.available == eng.pool.total


@pytest.fixture(scope="module")
def prop_stack(stack):
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=3)
    return cfg, eng, sched, loop, vc


@settings(max_examples=8, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["arrive", "cancel",
                                           "disconnect"]),
                          st.integers(min_value=0, max_value=7),
                          st.integers(min_value=0, max_value=3)),
                min_size=3, max_size=12))
def test_random_arrival_cancel_disconnect_traces(prop_stack, trace):
    cfg, eng, sched, loop, vc = prop_stack
    prompts = _prompts(cfg, [4, 6, 5, 7, 5, 6, 4, 8], seed=6)
    handles, streams, poisoned = {}, {}, set()
    rid = [0]

    def arrive(_):
        rid[0] += 1
        r = rid[0]
        streams[r] = []

        def tap(tok, lp, r=r):
            if r in poisoned:
                raise ConnectionResetError("client went away")
            streams[r].append(tok)
        handles[r] = loop.submit(
            Request(rid=r, prompt=list(prompts[r % len(prompts)]),
                    max_new_tokens=5), tap)

    def live():
        return [h for h in handles.values() if not h.done]

    def cancel(i):
        alive = live()
        if alive:
            alive[i % len(alive)].cancel()

    def disconnect(i):
        alive = live()
        if alive:
            poisoned.add(alive[i % len(alive)].rid)

    for op, i, gap in trace:
        {"arrive": arrive, "cancel": cancel, "disconnect": disconnect}[op](i)
        for _ in range(gap):
            loop.run_once()
            vc.advance(0.01)
            eng.pool.check()
            for r, h in handles.items():
                assert streams[r] == h.request.out_tokens[:len(streams[r])]
    _pump(loop, vc, until=lambda: all(h.done for h in handles.values()))
    for r, h in handles.items():
        if h.cancelled:
            assert h.reply is not None
        elif r in poisoned and h.error is not None:
            assert isinstance(h.error, RequestError)
        else:
            assert h.reply["tokens"] == h.request.out_tokens
    assert eng.active == 0 and eng.waiting == 0
    eng.pool.check()
    assert eng.pool.available == eng.pool.total
    assert not loop._live and not loop._intake and not loop._cancels


def test_replica_kill_mid_stream_is_service_error(stack):
    cfg, model, params = stack
    svc = make_lm_service("lm_kill", model, params, n_replicas=2,
                          batch_size=2, max_seq=MAX_SEQ, with_backup=False,
                          device="cpu")
    svc.start()
    rep0 = svc.replicas[0]
    got = []
    handle = rep0.handler.submit({"prompt": [5, 6, 7], "max_new_tokens": 8,
                                  "on_token": lambda t, lp: got.append(t)})
    loop = rep0.handler.loop
    while len(got) < 2:
        loop.run_once()
    rep0.set_up(False)
    with pytest.raises(ServiceError, match="abort"):
        loop.wait(handle)
    assert 2 <= len(got) < 8
    out = svc({"prompt": [5, 6, 7], "max_new_tokens": 2})
    assert out["replica"] == "lm_kill/1"
    assert len(out["tokens"]) == 2


def test_balancer_does_not_retry_after_first_streamed_token():
    calls = []

    def flaky(payload):
        calls.append("flaky")
        payload["on_token"](7, -0.5)
        raise ServiceError("died mid-stream")

    def healthy(payload):
        calls.append("healthy")
        return {"tokens": [1]}

    svc = Service("s", replicas=[Replica("a", flaky),
                                 Replica("b", healthy)])
    deploy(svc)
    svc.start()
    got = []
    with pytest.raises(ServiceError, match="not retrying"):
        svc({"on_token": lambda t, lp: got.append(t)})
    assert got == [7]
    assert calls == ["flaky"]
    assert svc.balancer.stats["failovers"] == 1
    assert svc({"on_token": lambda t, lp: None}) == {"tokens": [1]}
    assert calls[-1] == "healthy"


def test_client_disconnect_mid_stream_never_poisons_health(stack):
    cfg, model, params = stack
    svc = make_lm_service("lm_disc", model, params, n_replicas=1,
                          batch_size=2, max_seq=MAX_SEQ, device="cpu")
    svc.start()

    def hangup(tok, lp):
        raise BrokenPipeError("peer reset")

    with pytest.raises(RequestError, match="disconnected"):
        svc({"prompt": [5, 6, 7], "max_new_tokens": 4, "on_token": hangup})
    assert svc.balancer.stats["failovers"] == 0
    rep = svc.replicas[0].handler
    assert rep.scheduler.engine.metrics["cancelled"] == 1
    out = svc({"prompt": [5, 6, 7], "max_new_tokens": 2})
    assert len(out["tokens"]) == 2


def test_streaming_through_service_matches_reply(stack):
    cfg, model, params = stack
    svc = make_lm_service("lm_stream", model, params, n_replicas=1,
                          batch_size=2, max_seq=MAX_SEQ, device="cpu")
    svc.start()
    got = []
    out = svc({"prompt": [5, 6, 7], "max_new_tokens": 5,
               "sampling": {"temperature": 0.9, "top_k": 20, "seed": 4},
               "on_token": lambda t, lp: got.append((t, lp))})
    assert [t for t, _ in got] == out["tokens"]
    assert [lp for _, lp in got] == out["logprobs"]
    assert len(got) == 5


def test_asyncio_stream_front_end_interleaves(stack):
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=2)
    pa, pb = _prompts(cfg, [5, 7], seed=9)
    order = []

    async def consume(rid, prompt):
        toks = []
        async for tok, lp in loop.stream(
                Request(rid=rid, prompt=list(prompt), max_new_tokens=4)):
            toks.append(tok)
            order.append(rid)
        return toks

    async def both():
        return await asyncio.wait_for(
            asyncio.gather(consume(1, pa), consume(2, pb)), WAIT_S)

    ta, tb = asyncio.run(both())
    assert len(ta) == len(tb) == 4
    assert order != sorted(order)


def test_threaded_loop_serves_without_polling_sleeps(stack):
    """The daemon-thread pump is event-woken: submit -> result round-trips
    with bounded waits; the thread stops."""
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=2)
    loop.start()
    try:
        (p,) = _prompts(cfg, [6], seed=10)
        h = loop.submit(Request(rid=1, prompt=p, max_new_tokens=3))
        assert h._done.wait(WAIT_S), "threaded loop never resolved"
        assert len(loop.wait(h)["tokens"]) == 3
    finally:
        _stop(loop)
    assert eng.pool.available == eng.pool.total


def _stop(loop):
    """Stop a threaded loop, bounded: the pump thread must end."""
    thread = loop._thread
    stopper = threading.Thread(target=loop.stop, daemon=True)
    stopper.start()
    stopper.join(WAIT_S)
    assert not stopper.is_alive() and not thread.is_alive()


def test_threaded_loop_admits_while_it_decodes(stack):
    """A request handed to a threaded loop joins the batch while another
    decodes: submission never waits for the pump, which holds its tick
    lock for a whole tick and takes it again right after."""
    cfg, model, params = stack
    eng, sched, loop, vc = _build_loop(model, params, batch_size=2)
    pa, pb = _prompts(cfg, [5, 6], seed=12)
    first = threading.Event()
    ha = loop.submit(Request(rid=1, prompt=pa, max_new_tokens=50),
                     lambda t, lp: first.set())
    loop.start()
    try:
        assert first.wait(WAIT_S)
        hb = loop.submit(Request(rid=2, prompt=pb, max_new_tokens=2))
        assert hb._done.wait(WAIT_S)
        assert not ha.done, "the second request waited for the first"
        assert ha._done.wait(WAIT_S)
        assert len(ha.result()["tokens"]) == 50
        assert len(hb.result()["tokens"]) == 2
    finally:
        _stop(loop)


def test_dispatched_tick_commits_exactly_once(stack):
    cfg, model, params = stack
    eng = ServingEngine(model, params, batch_size=2, max_seq=MAX_SEQ,
                        device="cpu")
    (p,) = _prompts(cfg, [5], seed=11)
    assert eng.add_requests([Request(rid=1, prompt=p,
                                     max_new_tokens=1)]) == 1
    tick = eng.dispatch_step()
    done = tick.commit()
    assert [r.rid for r in done] == [1]
    with pytest.raises(RuntimeError, match="already committed"):
        tick.commit()
