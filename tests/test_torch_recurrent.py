"""The port's recurrent families (rwkv6, hymba) against the JAX reference
on the CPU: the model on stripe caches, then the serving engine.

Variants: reduced rwkv6-1.6b, reduced hymba-1.5b (MHA, sliding window
64) and hymba with 2 KV heads (G = 2). Both sides run the reference's
``init_params`` weights, carried over through numpy, after the f32
leaves that the reference initialises to constants (``bonus_u`` 0,
``decay_base`` -5, ``dt_bias`` 0, ``D`` 1, a fixed ``A_log``) are
perturbed with seeded numpy noise, so the bonus term, per-channel decay
and per-channel dt / D are exercised. f32 throughout: logits within
1e-4; each layer's cache leaves after prefill within 1e-5 of the leaf's
scale (max |port - ref| <= 1e-5 * max |ref|: the second layer's K/V and
state carry the first layer's sum-order noise, a few ulp of leaves that
reach 4-26 in magnitude); engine streams identical, logprobs within
2e-5, ``metrics`` and ``pool_stats()`` equal.
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
from repro_torch.weights import params_from_numpy

VARIANTS = {"rwkv": ("rwkv6-1.6b", {}),
            "hymba": ("hymba-1.5b", {}),
            "hymba_gqa": ("hymba-1.5b", {"n_kv_heads": 2})}
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed):
    """Seeded noise on the f32 leaves the reference inits to constants."""
    rng = np.random.default_rng(seed)
    b = tree["blocks"]
    if "tmix" in b:
        t = b["tmix"]
        t["bonus_u"] = 0.5 * rng.standard_normal(t["bonus_u"].shape)
        t["decay_base"] = rng.uniform(-3.0, 1.0, t["decay_base"].shape)
    if "ssm" in b:
        s = b["ssm"]
        s["dt_bias"] = 0.5 * rng.standard_normal(s["dt_bias"].shape)
        s["D"] = 1.0 + 0.3 * rng.standard_normal(s["D"].shape)
        s["A_log"] = s["A_log"] + 0.3 * rng.standard_normal(
            s["A_log"].shape)
    return jax.tree.map(lambda a: a.astype(np.float32)
                        if a.dtype == np.float64 else a, tree)


@pytest.fixture(scope="module", params=list(VARIANTS))
def stack(request):
    name, kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    jmodel = jax_build(jcfg)
    tree = _perturb(jax.tree.map(np.asarray,
                                 jmodel.init(jax.random.key(0))), seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, cfg, "cpu")
    return request.param, jmodel, jparams, build_model(cfg, device="cpu"), \
        params


def _close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


def _close_to_scale(port, ref, tol):
    """Per layer: max |port - ref| <= tol * max |ref|."""
    for l, (a, b) in enumerate(zip(port.numpy(), np.asarray(ref))):
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= tol * scale, (l, err, scale)


# ------------------------------------------------------------------ model
def test_prefill_and_decode_match_jax(stack):
    """Prefill (hymba: longer than its 64-token window), the cache leaves
    it returns, then 6 decode steps on stripe caches with per-row
    lengths."""
    _, jmodel, jparams, model, params = stack
    cfg = model.cfg
    B, S, cap = 2, 70, 80
    rng = np.random.default_rng(2)
    toks = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jpref = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tpref = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, LOGIT_TOL)
    assert sorted(tpref) == sorted(jpref)
    for key in jpref:
        assert tpref[key].dtype == getattr(torch, str(jpref[key].dtype))
        _close_to_scale(tpref[key], jpref[key], CACHE_TOL)

    # stripe caches holding the prefill; row 1 continues 5 tokens earlier
    jcache = jmodel.init_cache(B, cap)
    tcache = model.init_cache(B, cap)
    assert {k: v.shape for k, v in jcache.items()} == \
        {k: tuple(v.shape) for k, v in tcache.items()}
    for key in jcache:
        if key in ("k", "v"):
            jcache[key] = jcache[key].at[:, :, :S].set(jpref[key])
            tcache[key][:, :, :S] = tpref[key]
        else:
            jcache[key] = jpref[key]
            tcache[key].copy_(tpref[key])
    lens = np.asarray([S, S - 5], np.int32)
    for step in range(6):
        tok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                        jnp.asarray(lens))
        tl, out = model.decode_step(params, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(lens))
        assert out is tcache                            # updated in place
        _close(tl, jl, LOGIT_TOL)
        lens = lens + 1
    for key in jcache:
        _close(tcache[key], jcache[key], LOGIT_TOL)


# ----------------------------------------------------------------- engine
def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, request_cls, model, params, prompts, samplings=(),
           **kw):
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(rid=i, prompt=list(p), max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r, samp in zip(reqs, samplings):
        r.sampling = samp
    done = eng.run(list(reqs))
    assert len(done) == len(reqs)
    return eng, reqs


def test_engine_matches_jax(stack):
    """Exact-length co-batching (two 9-token prompts), slot reuse, and a
    prompt longer than hymba's window."""
    _, jmodel, jparams, model, params = stack
    prompts = _prompts(model.cfg, [9, 4, 9, 70, 6], seed=3)
    kw = dict(batch_size=3, max_seq=80)
    jeng, jreqs = _serve(JaxEngine, JaxRequest, jmodel, jparams, prompts,
                         **kw)
    eng, reqs = _serve(ServingEngine, Request, model, params, prompts,
                       device="cpu", **kw)
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert not eng.paged and eng.pool is None
    assert eng.pool_stats() == jeng.pool_stats()
    assert eng.metrics == jeng.metrics
    assert eng.metrics["slot_reuses"] > 0
    assert eng.metrics["prefill_batches"] < eng.metrics["prefills"]


def test_sampled_engine_matches_jax(stack):
    """Sampled rows (temperature with and without top-k, a greedy row)
    emit the reference engine's streams on the stripe layout."""
    _, jmodel, jparams, model, params = stack
    prompts = _prompts(model.cfg, [9, 4, 9, 70, 6], seed=5)
    knobs = [dict(temperature=0.8, top_k=8, seed=3), dict(),
             dict(temperature=1.2, seed=-1), dict(temperature=0.6, seed=4),
             dict(temperature=1.0, top_k=2, seed=2**31 - 1)]
    kw = dict(batch_size=3, max_seq=80)
    jeng, jreqs = _serve(JaxEngine, JaxRequest, jmodel, jparams, prompts,
                         [JaxSamplingParams(**k) for k in knobs], **kw)
    eng, reqs = _serve(ServingEngine, Request, model, params, prompts,
                       [SamplingParams(**k) for k in knobs], device="cpu",
                       **kw)
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert eng.metrics == jeng.metrics


def test_mixed_length_matches_solo(stack):
    """Prompts of different lengths decoding in one batch emit what each
    emits served alone (the port's own engine, as in
    tests/test_engine.py for the reference)."""
    _, _, _, model, params = stack
    prompts = _prompts(model.cfg, [4, 9, 6], seed=4)
    _, batched = _serve(ServingEngine, Request, model, params, prompts,
                        batch_size=3, max_seq=64, device="cpu")
    for p, r in zip(prompts, batched):
        _, (solo,) = _serve(ServingEngine, Request, model, params, [p],
                            batch_size=1, max_seq=64, device="cpu")
        assert solo.out_tokens == r.out_tokens, r.rid


def test_recurrent_engine_rejects_paging_and_chunking(stack):
    _, _, _, model, params = stack
    kw = dict(batch_size=2, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        ServingEngine(model, params, paged=True, **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(model, params, prefill_chunk=8, **kw)
    eng = ServingEngine(model, params, **kw)
    assert eng.prefill_chunk == 0 and not eng.prefix_sharing
    assert eng.pool_stats() == {"paged": False, "slots": 2, "active": 0,
                                "occupancy": 0.0}
