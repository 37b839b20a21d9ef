"""The port's ServingEngine against the JAX reference engine on the CPU.

The same reduced qwen3-4b weights (the reference's ``init_params``,
carried over through numpy) serve the same prompts — made with numpy
from a fixed seed, on the prompt sets of ``tests/test_engine.py`` and
``tests/test_chunked.py`` — through the reference engine and the port's
``ServingEngine(device="cpu", use_kernel=True)`` (the kernel ops' plain
version on CPU tensors). Token streams are identical, logprobs agree
within 2e-5 (the ``test_chunked.py`` contract), and ``pool_stats()`` and
``metrics`` are equal. Both engines run with ``use_kernel=True``, so the
kernel dispatch counters are compared too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.telemetry import Tracer
from repro_torch.weights import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
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


def _prompts(lens, seed, prefix=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(2, 512, prefix).tolist()
    return [common + rng.integers(2, 512, n).tolist() for n in lens]


def _mixed():
    return dict(engine=dict(batch_size=4, max_seq=64, block_size=8),
                prompts=_prompts([5, 11, 7, 14, 40, 23], seed=1), max_new=6)


def _chunked():
    return dict(engine=dict(batch_size=4, max_seq=64, block_size=16,
                            prefill_chunk=8),
                prompts=_prompts([40, 7, 23, 55], seed=2), max_new=6)


def _shared():
    # four same-prefix requests (in-batch sharing) + a prompt that is a
    # prefix of a resident one, ending mid-block (copy-on-write)
    ps = _prompts([3, 3, 3, 3], seed=3, prefix=20)
    return dict(engine=dict(batch_size=4, max_seq=64, block_size=8),
                prompts=ps + [ps[0][:11]], max_new=5)


def _tight():
    # a 12-block pool cannot hold both at full length: park / preempt
    return dict(engine=dict(batch_size=2, max_seq=64, block_size=4,
                            num_blocks=13, prefill_chunk=8),
                prompts=_prompts([6, 36], seed=4), max_new=[24, 6],
                step_between=True)


def _tight_shared():
    return dict(engine=dict(batch_size=3, max_seq=64, block_size=4,
                            num_blocks=9),
                prompts=_prompts([2, 2, 2], seed=5, prefix=10), max_new=10)


def _stripe():
    # fixed-stripe layout: the 40-token prompt feeds 1 token per tick
    # while the 56-token one chunks under the budget, then chunks while
    # the first decodes as a rider near max_seq, whose pad positions
    # reach past the stripe's end (dropped)
    return dict(engine=dict(batch_size=2, max_seq=64, paged=False,
                            prefill_chunk=8, prefill_budget=8),
                prompts=_prompts([56, 40], seed=6), max_new=6)


SCENARIOS = {"mixed": _mixed, "chunked": _chunked, "shared": _shared,
             "tight": _tight, "tight_shared": _tight_shared,
             "stripe": _stripe}


def _serve(engine_cls, request_cls, model, params, sc, samp_cls=None,
           **kw):
    """Serve a scenario; with ``samp_cls`` (either package's
    SamplingParams) the requests cycle through ``SAMPLED`` knobs."""
    eng = engine_cls(model, params, use_kernel=True, **sc["engine"], **kw)
    news = sc["max_new"] if isinstance(sc["max_new"], list) \
        else [sc["max_new"]] * len(sc["prompts"])
    extra = [{} if samp_cls is None else
             {"sampling": samp_cls(**SAMPLED[i % len(SAMPLED)])}
             for i in range(len(news))]
    reqs = [request_cls(rid=i, prompt=list(p), max_new_tokens=n, **x)
            for i, (p, n, x) in enumerate(zip(sc["prompts"], news, extra))]
    if sc.get("step_between"):
        # the first request decodes a step before the second arrives
        assert eng.add_requests(reqs[:1]) == 1
        eng.step()
        assert eng.add_requests(reqs[1:]) == len(reqs) - 1
        done = eng.run([])
    else:
        done = eng.run(list(reqs))
    assert len(done) == len(reqs)
    return eng, reqs


# sampled knobs cycled over a scenario's requests: temperature with and
# without top-k, a top-k of 1, greedy, and the extreme int32 seeds
SAMPLED = [dict(temperature=0.8, top_k=8, seed=3),
           dict(temperature=1.2, seed=-1),
           dict(),
           dict(temperature=0.5, top_k=1, seed=7),
           dict(temperature=1.0, top_k=50, seed=2**31 - 1)]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax(stack, name):
    jmodel, jparams, model, params = stack
    sc = SCENARIOS[name]()
    jeng, jreqs = _serve(JaxEngine, JaxRequest, jmodel, jparams, sc)
    eng, reqs = _serve(ServingEngine, Request, model, params, sc,
                       device="cpu")
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert eng.pool_stats() == jeng.pool_stats()
    assert eng.metrics == jeng.metrics
    if eng.paged:
        eng.pool.check()
        assert eng.pool.available == eng.pool.total
    m = eng.metrics
    if name == "chunked":
        assert m["chunk_steps"] > 0 and m["kernel_windows"] > 0
    if name == "shared":
        assert m["shared_admissions"] >= 3 and m["cow_copies"] >= 1
    if name.startswith("tight"):
        assert m["parked_slot_steps"] > 0 or m["preemptions"] > 0
    if name == "stripe":
        assert not eng.paged and m["chunk_steps"] > 0
        assert m["kernel_windows"] == m["kernel_positions"] == 0


@pytest.mark.parametrize("name", ["mixed", "chunked", "shared", "tight",
                                  "stripe"])
def test_sampled_engine_matches_jax(stack, name):
    """Sampled rows (temperature, top-k, extreme seeds) beside greedy ones
    emit the reference engine's streams on the paged layout (chunk
    windows, prefix sharing, preemption) and on stripes."""
    jmodel, jparams, model, params = stack
    sc = SCENARIOS[name]()
    jeng, jreqs = _serve(JaxEngine, JaxRequest, jmodel, jparams, sc,
                         samp_cls=JaxSamplingParams)
    eng, reqs = _serve(ServingEngine, Request, model, params, sc,
                       samp_cls=SamplingParams, device="cpu")
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert eng.pool_stats() == jeng.pool_stats()
    assert eng.metrics == jeng.metrics


def test_stripe_matches_paged_streams(stack):
    """The fixed-stripe layout emits exactly the block pool's token
    streams, chunk windows included (a 40-token prompt in chunks of 8)."""
    _, _, model, params = stack
    lens = [5, 40, 9, 17]
    streams = {}
    for paged in (True, False):
        eng = ServingEngine(model, params, batch_size=4, max_seq=64,
                            block_size=8, prefill_chunk=8, paged=paged,
                            device="cpu")
        reqs = _reqs(lens, max_new=6, seed=9)
        assert len(eng.run(list(reqs))) == 4
        assert eng.paged == paged and eng.metrics["chunk_steps"] > 0
        streams[paged] = reqs
    for a, b in zip(streams[True], streams[False]):
        assert a.out_tokens == b.out_tokens, a.rid
        np.testing.assert_allclose(a.out_logprobs, b.out_logprobs,
                                   atol=1e-6, rtol=1e-6)


# ------------------------------------------------- port-only behaviour
def _reqs(lens, max_new=4, seed=7, **kw):
    return [Request(rid=i, prompt=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(_prompts(lens, seed))]


def test_stop_token_and_cancel(stack):
    _, _, model, params = stack
    eng = ServingEngine(model, params, batch_size=2, max_seq=64,
                        block_size=8, device="cpu")
    (probe,) = _reqs([6], max_new=8)
    eng.run([probe])
    stop = probe.out_tokens[2]
    req = Request(rid=1, prompt=list(probe.prompt), max_new_tokens=8,
                  stop_tokens=(stop,))
    other = Request(rid=2, prompt=list(probe.prompt[:4]), max_new_tokens=30)
    assert eng.add_requests([req, other]) == 2
    while req.done_s is None:
        eng.step()
    assert req.out_tokens == probe.out_tokens[:3]
    assert eng.metrics["stop_token_exits"] == 1
    assert eng.cancel(2) and not eng.cancel(2)
    assert eng.active == 0 and eng.metrics["cancelled"] == 1
    assert eng.pool.available == eng.pool.total


def test_dispatch_then_commit_is_step(stack):
    _, _, model, params = stack
    streams = []
    for split in (False, True):
        tracer = Tracer()
        eng = ServingEngine(model, params, batch_size=3, max_seq=64,
                            block_size=8, device="cpu", tracer=tracer)
        reqs = _reqs([9, 30, 4], max_new=5, seed=8)
        eng.add_requests(reqs)
        while eng.active:
            if split:
                tick = eng.dispatch_step()
                tick.commit()
                with pytest.raises(RuntimeError, match="committed"):
                    tick.commit()
            else:
                eng.step()
        streams.append([r.out_tokens for r in reqs])
        names = {e["name"] for e in tracer.chrome_trace()["traceEvents"]}
        assert {"admitted", "first_token", "request"} <= names
    assert streams[0] == streams[1]


def test_later_slices_raise(stack):
    """The frontends still raise; speculation and MoE serve now, with the
    reference's ValueErrors (no draft; an MoE target speculating)."""
    _, _, model, params = stack
    kw = dict(batch_size=1, max_seq=32, device="cpu")
    spec = ServingEngine(model, params, speculation=2, draft_model=model,
                         draft_params=params, **kw)
    assert spec.spec_k == 2 and spec.draft is not None
    with pytest.raises(ValueError, match="draft model"):
        ServingEngine(model, params, speculation=2, **kw)
    eng = ServingEngine(model, params, **kw)
    with pytest.raises(ValueError, match="device"):
        ServingEngine(model, params, batch_size=1, max_seq=32)  # cuda
    mmodel = build_model(get_config("grok-1-314b").reduced(), device="cpu")
    mparams = mmodel.init(0)
    assert ServingEngine(mmodel, mparams, **kw)._solo_prefill
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(mmodel, mparams, speculation=2, draft_model=mmodel,
                      draft_params=mparams, **kw)
    wcfg = get_config("whisper-tiny").reduced()
    with pytest.raises(NotImplementedError, match="frontends"):
        ServingEngine(build_model(wcfg, device="cpu"), params, **kw)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, params, prefill_chunk=-1, **kw)
    with pytest.raises(ValueError, match="max_seq"):
        eng.add_requests([Request(rid=9, prompt=[3] * 40)])
