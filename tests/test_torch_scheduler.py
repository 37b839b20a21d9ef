"""The port's Scheduler: every case of ``tests/test_scheduler.py`` on the
port's CPU engine, then ``Scheduler.drain()`` against the reference's.

The parity runs serve the same prompts (numpy, fixed seed) with the
reference's reduced qwen3-4b weights (carried over through numpy) under
each policy — fifo, spf, priority, deadline — on the paged layout (a
per-tick prefill budget, chunk windows) and on stripes. Greedy and
sampled requests mix; priorities span three tiers and some requests
carry deadlines, one of which lapses in the queue. Both sides run on a
``VirtualClock``, so latency and queue-wait stats are exact: the
completion order, every stream (logprobs within 2e-5), ``SchedulerStats``,
``pool_stats()`` and ``metrics`` are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serve.clock import VirtualClock as JaxClock
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import POLICIES, Scheduler, SchedulerStats
from repro_torch.weights import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                               dtype=jnp.float32)
    cfg = get_config("qwen3-4b").reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def engine_factory(stack):
    _, _, model, params = stack

    def make(batch=2, max_seq=64, **kw):
        return ServingEngine(model, params, batch_size=batch,
                             max_seq=max_seq, device="cpu", **kw), model.cfg
    return make


@pytest.fixture(scope="module")
def paged_factory(stack):
    _, _, model, params = stack

    def make(batch=4, max_seq=64, block_size=8, num_blocks=None):
        return ServingEngine(model, params, batch_size=batch,
                             max_seq=max_seq, paged=True,
                             block_size=block_size, num_blocks=num_blocks,
                             device="cpu"), model.cfg
    return make


def _reqs(cfg, lens, max_new=3, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, max_new_tokens=max_new,
                    prompt=rng.integers(2, cfg.vocab_size, L).tolist())
            for i, L in enumerate(lens)]


# ------------------------------------------- tests/test_scheduler.py
def test_drain_completes_all(engine_factory):
    eng, cfg = engine_factory()
    s = Scheduler(eng)
    for r in _reqs(cfg, [8, 12, 8, 10, 6]):
        assert s.submit(r)
    done = s.drain()
    assert len(done) == 5
    assert s.stats.completed == 5
    assert all(len(r.out_tokens) == 3 for r in done)
    assert s.stats.queue_peak >= 3


def test_bounded_queue_rejects(engine_factory):
    eng, cfg = engine_factory()
    s = Scheduler(eng, max_queue=2)
    reqs = _reqs(cfg, [8] * 4)
    assert s.submit(reqs[0]) and s.submit(reqs[1])
    assert not s.submit(reqs[2])
    assert s.stats.rejected == 1
    s.drain()
    assert s.stats.completed == 2


def test_spf_prefers_short_prompts(engine_factory):
    eng, cfg = engine_factory(batch=1)
    s = Scheduler(eng, policy="spf")
    for r in _reqs(cfg, [32, 4, 16], max_new=2):
        s.submit(r)
    order = []
    while s.queue or any(r is not None for r in eng.slot_req):
        for r in s.tick():
            order.append(r.rid)
    assert order[0] == 1
    assert s.stats.completed == 3


def test_spf_beats_fifo_on_head_of_line_blocking(engine_factory):
    eng, cfg = engine_factory(batch=1)
    s = Scheduler(eng, policy="spf")
    for r in _reqs(cfg, [48, 4, 4, 4], max_new=2):
        s.submit(r)
    done = s.drain()
    assert [r.rid for r in done][-1] == 0
    assert s.stats.completed == 4


def test_queue_wait_stats_recorded(engine_factory):
    eng, cfg = engine_factory(batch=2)
    s = Scheduler(eng)
    for r in _reqs(cfg, [8] * 5):
        s.submit(r)
    s.drain()
    assert len(s.stats.queue_wait_s) == 5
    assert all(w >= 0 for w in s.stats.queue_wait_s)
    assert s.stats.mean_queue_wait_s() >= 0
    first_two = sorted(s.stats.queue_wait_s)[:2]
    last_two = sorted(s.stats.queue_wait_s)[-2:]
    assert max(first_two) <= min(last_two)


def test_bounded_queue_rejection_counting(engine_factory):
    eng, cfg = engine_factory(batch=1)
    s = Scheduler(eng, max_queue=3)
    outcomes = [s.submit(r) for r in _reqs(cfg, [8] * 6, max_new=2)]
    assert outcomes == [True] * 3 + [False] * 3
    assert s.stats.rejected == 3
    s.drain()
    assert s.stats.completed == 3


def test_oversized_prompt_rejected_at_submit(engine_factory):
    eng, cfg = engine_factory(batch=2, max_seq=16)
    s = Scheduler(eng)
    ok = _reqs(cfg, [8], max_new=2)[0]
    big = Request(rid=99, prompt=[3] * 50, max_new_tokens=2)
    assert not s.submit(big)
    assert s.stats.rejected == 1
    assert s.submit(ok)
    assert [r.rid for r in s.drain()] == [ok.rid]


def test_priority_tiers_served_first(engine_factory):
    eng, cfg = engine_factory(batch=1)
    s = Scheduler(eng, policy="priority")
    reqs = _reqs(cfg, [8, 8, 8, 8], max_new=2)
    reqs[2].priority = 5
    reqs[3].priority = 5
    for r in reqs:
        s.submit(r)
    done = s.drain()
    assert [r.rid for r in done] == [2, 3, 0, 1]
    assert s.stats.completed_by_priority == {5: 2, 0: 2}


def test_deadline_policy_serves_edf_order(engine_factory):
    eng, cfg = engine_factory(batch=1)
    eng.clock = vc = VirtualClock(start=1000.0)
    s = Scheduler(eng, policy="deadline")
    reqs = _reqs(cfg, [8, 8, 8], max_new=2)
    reqs[0].deadline_s = vc.now() + 500.0
    reqs[1].deadline_s = vc.now() + 100.0
    reqs[2].deadline_s = None
    for r in reqs:
        s.submit(r)
    done = s.drain()
    assert [r.rid for r in done] == [1, 0, 2]
    assert s.stats.slo_hits == 2
    assert s.stats.slo_misses == 0


def test_deadline_sheds_expired_requests(engine_factory):
    eng, cfg = engine_factory(batch=1)
    eng.clock = vc = VirtualClock(start=1000.0)
    s = Scheduler(eng, policy="deadline")
    live, doomed = _reqs(cfg, [8, 8], max_new=2)
    live.deadline_s = vc.now() + 500.0
    s.submit(live)
    s.submit(doomed)
    doomed.deadline_s = vc.now() + 1.0
    vc.advance(2.0)
    done = s.drain()
    assert [r.rid for r in done] == [live.rid]
    assert s.stats.shed == 1
    assert s.shed_requests == [doomed]
    assert s.stats.completed == 1


def test_deadline_rejects_expired_at_submit(engine_factory):
    eng, cfg = engine_factory(batch=1)
    eng.clock = vc = VirtualClock(start=1000.0)
    s = Scheduler(eng, policy="deadline")
    (dead,) = _reqs(cfg, [8], max_new=2)
    dead.deadline_s = vc.now() - 1.0
    assert not s.submit(dead)
    assert s.stats.rejected == 1
    assert not s.queue


def test_fill_is_gated_on_pool_blocks(paged_factory):
    eng, cfg = paged_factory(batch=8, num_blocks=5)
    s = Scheduler(eng)
    for r in _reqs(cfg, [5, 5, 5, 5, 5], max_new=3):
        assert s.submit(r)
    s.tick()
    assert eng.active == 3
    assert len(s.queue) == 2
    done = s.drain()
    assert s.stats.completed == 5
    assert [r.rid for r in done][-2:] == [3, 4]


def test_unservable_prompt_rejected_at_submit_paged(paged_factory):
    eng, cfg = paged_factory(batch=2, max_seq=64, num_blocks=3)
    s = Scheduler(eng)
    (big,) = _reqs(cfg, [40], max_new=2)
    assert not s.submit(big)
    assert s.stats.rejected == 1


def test_memory_pressure_sheds_lowest_priority(paged_factory):
    eng, cfg = paged_factory(batch=8, num_blocks=5)
    s = Scheduler(eng, policy="priority", pressure_shed=0.5)
    reqs = _reqs(cfg, [5] * 6, max_new=3)
    reqs[4].priority = 7
    reqs[5].priority = 3
    for r in reqs:
        assert s.submit(r)
    done = s.tick()
    assert eng.memory_pressure() >= 0.5
    done += s.tick()
    assert s.stats.shed == 2
    assert {r.rid for r in s.shed_requests} == {2, 3}
    done += s.drain()
    assert s.stats.completed == 4
    assert {r.rid for r in done} == {0, 1, 4, 5}


def test_memory_pressure_shed_disabled_by_default(paged_factory):
    eng, cfg = paged_factory(batch=8, num_blocks=5)
    s = Scheduler(eng, policy="priority")
    for r in _reqs(cfg, [5] * 6, max_new=2):
        assert s.submit(r)
    s.drain()
    assert s.stats.shed == 0 and s.stats.completed == 6


def test_drain_readmits_engine_preempted_requests(paged_factory):
    eng, cfg = paged_factory(batch=2, block_size=4, num_blocks=4)
    s = Scheduler(eng)
    reqs = _reqs(cfg, [4, 4], max_new=8)
    for r in reqs:
        assert s.submit(r)
    done = s.drain()
    assert len(done) == 2
    assert eng.metrics["preemptions"] >= 1
    assert all(len(r.out_tokens) == 8 for r in reqs)
    assert eng.waiting == 0 and eng.active == 0


def test_pool_occupancy_visible_to_scheduler(paged_factory):
    eng, cfg = paged_factory(batch=4)
    s = Scheduler(eng)
    assert eng.memory_pressure() == 0.0
    for r in _reqs(cfg, [5, 5], max_new=3):
        s.submit(r)
    s.tick()
    assert 0.0 < eng.memory_pressure() < 1.0
    assert eng.pool_stats()["used"] == 2
    s.drain()
    assert eng.memory_pressure() == 0.0


def test_plan_ahead_caches_admission_costs(engine_factory):
    eng, cfg = engine_factory(batch=1, prefix_sharing=False)
    s = Scheduler(eng)
    for r in _reqs(cfg, [8, 10, 6], max_new=2):
        s.submit(r)
    assert s.plan_ahead() == 3
    assert s.plan_ahead() == 0
    s.drain()
    assert s.stats.plan_hits == 3
    assert s.stats.planned_ahead == 3
    assert s.stats.completed == 3


def test_plan_goes_stale_when_prefix_index_can_move(engine_factory):
    eng, cfg = engine_factory(batch=2)
    assert eng.prefix_sharing
    s = Scheduler(eng)
    (req,) = _reqs(cfg, [8], max_new=2)
    s.submit(req)
    assert s.plan_ahead() == 1
    eng.pool.version += 1
    assert s.plan_ahead() == 1
    s.drain()
    assert s.stats.completed == 1


def test_slo_miss_counted(engine_factory):
    eng, cfg = engine_factory(batch=1)
    eng.clock = vc = VirtualClock(start=1000.0)
    s = Scheduler(eng, policy="fifo")
    (req,) = _reqs(cfg, [8], max_new=2)
    req.deadline_s = vc.now() + 5.0
    s.submit(req)
    vc.advance(10.0)
    s.drain()
    assert s.stats.slo_misses == 1
    assert s.stats.slo_hits == 0


def test_percentile_empty_is_zero():
    assert SchedulerStats().percentile(0.5) == 0.0


def test_percentile_single_sample_any_q():
    st = SchedulerStats(latencies_s=[0.42])
    for q in (0.01, 0.5, 0.99, 1.0):
        assert st.percentile(q) == 0.42


def test_percentile_nearest_rank_even_n():
    st = SchedulerStats(latencies_s=[float(i) for i in range(10, 0, -1)])
    assert st.percentile(0.50) == 5.0
    assert st.percentile(0.90) == 9.0
    assert st.percentile(0.99) == 10.0


def test_percentile_small_sample_not_biased_to_max():
    st = SchedulerStats(latencies_s=[4.0, 1.0, 3.0, 2.0])
    assert st.percentile(0.75) == 3.0
    assert st.percentile(0.76) == 4.0
    assert st.percentile(0.25) == 1.0
    assert st.percentile(1.0) == 4.0


def test_percentile_tiny_q_clamps_to_min():
    st = SchedulerStats(latencies_s=[2.0, 1.0, 3.0])
    assert st.percentile(0.0) == 1.0
    assert st.percentile(1e-9) == 1.0


# ---------------------------------------------- drain against the reference
KNOBS = [dict(), dict(temperature=0.8, top_k=8, seed=3), dict(),
         dict(temperature=1.2, seed=-1), dict(temperature=0.5, top_k=1,
                                              seed=7)]
LAYOUTS = {"paged": dict(paged=True, block_size=8, prefill_chunk=8),
           "stripes": dict(paged=False)}


def _drain(engine_cls, request_cls, sched_cls, clock_cls, samp_cls, model,
           params, policy, layout, **kw):
    vc = clock_cls(start=1000.0)
    eng = engine_cls(model, params, batch_size=3, max_seq=64, clock=vc,
                     **LAYOUTS[layout], **kw)
    budget = 16 if layout == "paged" else None
    s = sched_cls(eng, policy=policy, prefill_budget=budget)
    rng = np.random.default_rng(11)
    lens = [5, 30, 7, 14, 40, 23, 9]
    reqs = []
    for i, n in enumerate(lens):
        r = request_cls(rid=i, prompt=rng.integers(2, 512, n).tolist(),
                        max_new_tokens=4 + i % 3, priority=i % 3,
                        sampling=samp_cls(**KNOBS[i % len(KNOBS)]))
        r.deadline_s = None if i % 3 == 1 else vc() + 50.0 + 10 * i
        r.submitted_s = vc()
        reqs.append(r)
    reqs[5].deadline_s = vc() + 1.0          # lapses in the queue
    for r in reqs:
        assert s.submit(r)
    vc.advance(2.0)
    return s, eng, reqs, s.drain()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("policy", POLICIES)
def test_drain_matches_reference(stack, policy, layout):
    jmodel, jparams, model, params = stack
    js, jeng, jreqs, jdone = _drain(JaxEngine, JaxRequest, JaxScheduler,
                                    JaxClock, JaxSamplingParams, jmodel,
                                    jparams, policy, layout)
    s, eng, reqs, done = _drain(ServingEngine, Request, Scheduler,
                                VirtualClock, SamplingParams, model, params,
                                policy, layout, device="cpu")
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert dataclasses.asdict(s.stats) == dataclasses.asdict(js.stats)
    assert [r.rid for r in s.shed_requests] == \
        [r.rid for r in js.shed_requests]
    assert eng.pool_stats() == jeng.pool_stats()
    assert eng.metrics == jeng.metrics
    if policy == "deadline":
        assert s.stats.shed == 1
    assert eng.active == 0 and eng.waiting == 0
