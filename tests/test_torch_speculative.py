"""The port's speculative draft-and-verify decode against the JAX
reference on the CPU.

Mirrors ``tests/test_speculative.py`` on the port: the multi-token
verify path against sequential decode (stripe, bf16, paged through the
gather and through the kernel ops), scratch diversion under shared
prefix blocks, greedy speculative streams bit-identical to plain
decode, self-drafts, watermark rollback, per-request opt-out,
validation, the watermark in ``blocks_needed``, the scheduler, sampled
reproducibility, the co-holder property and logprobs. The weights are
the reference's ``init_params``, carried over through numpy; prompts
are made with numpy from fixed seeds and fed to both packages. Verify
logits agree with the reference within 1e-4 (the model contract); the
engines' streams are identical, logprobs within 2e-5, and ``metrics``
and ``pool_stats()`` equal, paged and stripes, greedy and sampled, MHA
and G = 2. The ``DraftRunner``'s proposals equal the reference's and
its proposal distributions agree within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.spec.draft import DraftRunner as JaxDraftRunner
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.spec import DraftRunner
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name="qwen3-4b", seed=0, **kw):
    """(jax model, jax params, port model, port params) on one set of
    weights: the reference's init at ``seed``, carried over."""
    jcfg = dataclasses.replace(jax_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def stack():
    return _pair()


@pytest.fixture(scope="module")
def cold(stack):
    """Draft weights unlike the target's (near-zero acceptance):
    (jax params, port params)."""
    _, _, model, _ = stack
    jparams = stack[0].init(jax.random.key(9))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      model.cfg, "cpu")


def _prompts(lens, seed, prefix=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(2, 512, prefix).tolist()
    return [common + rng.integers(2, 512, n).tolist() for n in lens]


def _reqs(lens, max_new=6, seed=1, request_cls=Request, **kw):
    return [request_cls(rid=i, prompt=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(_prompts(lens, seed))]


def _shared_reqs(n, prefix_len=20, suffix_len=3, max_new=6, seed=5, **kw):
    return [Request(rid=i, prompt=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(_prompts([suffix_len] * n, seed,
                                            prefix=prefix_len))]


def _eng(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _spec(model, params, dparams, k=3, **kw):
    return _eng(model, params, draft_model=model, draft_params=dparams,
                speculation=k, **kw)


# =============================================== verify-path differential
def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(2, 512, (B, S)).astype(
        np.int32)


def _prefill_stripe(model, params, toks, capacity):
    cache = model.init_cache(toks.shape[0], capacity)
    _, pref = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    for key in cache:
        cache[key][:, :, :toks.shape[1]] = pref[key].to(cache[key].dtype)
    return cache


def _seq_logits(model, params, win, cache, lens, **kw):
    """S sequential decode steps: the oracle the verify step must
    reproduce."""
    outs = []
    for j in range(win.shape[1]):
        lg, cache = model.decode_step(params, win[:, j:j + 1], cache,
                                      lens + j, **kw)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1), cache


def _jax_verify_stripe(jmodel, jparams, toks, win, capacity):
    cache = jmodel.init_cache(toks.shape[0], capacity)
    _, pref = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    for key in cache:
        cache[key] = jax.lax.dynamic_update_slice(
            cache[key], pref[key].astype(cache[key].dtype), (0,) * 5)
    lens = jnp.full((toks.shape[0],), toks.shape[1], jnp.int32)
    return jmodel.verify_step(jparams, jnp.asarray(win), cache, lens)


def test_verify_matches_sequential_decode_stripe(stack):
    """One q_len = k + 1 verify equals k + 1 single-token steps, logits
    and resulting cache, every row at its own length; and the
    reference's verify logits."""
    jmodel, jparams, model, params = stack
    B, P, S = 3, 9, 4
    toks, win = _tokens(B, P, 1), _tokens(B, S, 2)
    lens = torch.full((B,), P, dtype=torch.int32)
    twin = torch.from_numpy(win)
    seq, c_seq = _seq_logits(model, params, twin,
                             _prefill_stripe(model, params, toks, 32), lens)
    ver, c_ver = model.verify_step(params, twin,
                                   _prefill_stripe(model, params, toks, 32),
                                   lens)
    torch.testing.assert_close(ver, seq, atol=2e-5, rtol=2e-5)
    assert torch.equal(ver.argmax(-1), seq.argmax(-1))
    for key in c_seq:
        torch.testing.assert_close(c_ver[key], c_seq[key], atol=2e-5,
                                   rtol=2e-5)
    jver, _ = _jax_verify_stripe(jmodel, jparams, toks, win, 32)
    np.testing.assert_allclose(ver.numpy(), np.asarray(jver), **TOL)


def test_verify_matches_sequential_decode_bf16():
    """The same property at bf16 storage precision (the reference's
    2e-2), on the reference's bf16 weights. (The two frameworks round bf16
    at other places, so the cross-framework checks stay in f32.)"""
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                               dtype=jnp.bfloat16)
    cfg16 = dataclasses.replace(get_config("qwen3-4b").reduced(),
                                dtype=torch.bfloat16)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    model = build_model(cfg16, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg16,
                               "cpu")
    B, P, S = 2, 7, 3
    toks, win = _tokens(B, P, 3), _tokens(B, S, 4)
    lens = torch.full((B,), P, dtype=torch.int32)
    twin = torch.from_numpy(win)
    seq, _ = _seq_logits(model, params, twin,
                         _prefill_stripe(model, params, toks, 32), lens)
    ver, _ = model.verify_step(params, twin,
                               _prefill_stripe(model, params, toks, 32),
                               lens)
    torch.testing.assert_close(ver.float(), seq.float(), atol=2e-2,
                               rtol=2e-2)


def _paged_setup(model, params, toks, bs, num_blocks):
    """Prefill into a block pool: (cache, table, lens), row b in blocks
    1 + b * n_blk, ... (as the reference test lays them out)."""
    B, P = toks.shape
    cache = model.init_paged_cache(num_blocks, bs)
    _, pref = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    n_blk = -(-P // bs)
    table = np.zeros((B, num_blocks), np.int32)
    nxt = 1
    for b in range(B):
        for i in range(n_blk):
            table[b, i] = nxt
            lo, hi = i * bs, min((i + 1) * bs, P)
            for key in cache:
                cache[key][:, nxt, :hi - lo] = pref[key][:, b, lo:hi]
            nxt += 1
    return cache, torch.from_numpy(table), torch.full((B,), P,
                                                      dtype=torch.int32)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_verify_matches_sequential_decode_paged(stack, use_kernel):
    """The paged verify (gather path, and the kernel ops: the
    paged-window kernel's plain version on CPU tensors) against
    sequential paged decode, and against the reference's verify."""
    jmodel, jparams, model, params = stack
    B, P, S, bs = 2, 10, 3, 4
    toks, win = _tokens(B, P, 5), _tokens(B, S, 6)
    twin = torch.from_numpy(win)
    cache, table, lens = _paged_setup(model, params, toks, bs, 16)
    seq, _ = _seq_logits(model, params, twin, cache, lens,
                         block_table=table, paged_kernel=use_kernel)
    cache2, table2, _ = _paged_setup(model, params, toks, bs, 16)
    ver, _ = model.verify_step(params, twin, cache2, lens,
                               block_table=table2, paged_kernel=use_kernel)
    torch.testing.assert_close(ver, seq, atol=2e-5, rtol=2e-5)
    assert torch.equal(ver.argmax(-1), seq.argmax(-1))
    jcache = {k: jnp.asarray(v.numpy()) for k, v in
              _paged_setup(model, params, toks, bs, 16)[0].items()}
    jver, _ = jmodel.verify_step(jparams, jnp.asarray(win), jcache,
                                 jnp.asarray(lens.numpy()),
                                 block_table=jnp.asarray(table.numpy()),
                                 paged_kernel=use_kernel)
    np.testing.assert_allclose(ver.numpy(), np.asarray(jver), **TOL)


def test_verify_shared_prefix_blocks_and_scratch_diversion(stack):
    """Two rows whose tables alias the same physical prefix blocks: the
    window reads through the shared blocks, and a rider (n_write 0)
    leaves every owned block bit-identical (its writes go to scratch)."""
    _, _, model, params = stack
    P, S, bs = 8, 3, 4
    tok_row = _tokens(1, P, 7)
    win = torch.from_numpy(_tokens(2, S, 8))
    cache, _, lens = _paged_setup(model, params, tok_row, bs, 16)
    before = {k: v.clone() for k, v in cache.items()}
    table = torch.zeros((2, 16), dtype=torch.int32)
    table[0, :3] = torch.tensor([1, 2, 3])
    table[1, :3] = torch.tensor([1, 2, 4])
    ver, cache2 = model.verify_step(
        params, win, cache, lens.expand(2).contiguous(), block_table=table,
        n_write=torch.tensor([S, 0], dtype=torch.int32))
    for key in cache2:
        assert torch.equal(cache2[key][:, 4], before[key][:, 4])
        assert torch.equal(cache2[key][:, 1:3], before[key][:, 1:3])
    cache3, table3, _ = _paged_setup(model, params, tok_row, bs, 16)
    seq, _ = _seq_logits(model, params, win[:1], cache3, lens,
                         block_table=table3)
    torch.testing.assert_close(ver[0], seq[0], atol=2e-5, rtol=2e-5)


def test_verify_rejects_recurrent_families():
    cfg = get_config("rwkv6-1.6b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    with pytest.raises(ValueError, match="unsupported for family"):
        model.verify_step(params, torch.ones((1, 3), dtype=torch.int32),
                          model.init_cache(1, 16),
                          torch.tensor([4], dtype=torch.int32))


# ========================================== engine greedy bit-identity grid
GRID = [
    dict(paged=True, block_size=8),
    dict(paged=True, block_size=8, use_kernel=True),
    dict(paged=True, block_size=4, num_blocks=12),      # tight pool
    dict(paged=False),
]
GRID_IDS = ["paged", "kernel", "tight-pool", "stripe"]


@pytest.mark.parametrize("cfg_kw", GRID, ids=GRID_IDS)
def test_greedy_spec_streams_bit_identical(stack, cold, cfg_kw):
    """Greedy speculative decode emits the non-speculative streams (mixed
    lengths, every layout), with a self-draft (high acceptance) and a
    different-weights draft (near-zero acceptance)."""
    _, _, model, params = stack
    lens = [5, 11, 7, 14]
    base = _reqs(lens)
    _eng(model, params, batch_size=4, max_seq=64, **cfg_kw).run(list(base))
    for tag, dparams in (("self", params), ("cold", cold[1])):
        spec = _reqs(lens)
        e1 = _spec(model, params, dparams, batch_size=4, max_seq=64,
                   **cfg_kw)
        e1.run(list(spec))
        for a, b in zip(base, spec):
            assert a.out_tokens == b.out_tokens, (tag, a.rid)
            np.testing.assert_allclose(a.out_logprobs, b.out_logprobs,
                                       rtol=1e-5, atol=1e-5)
        assert e1.metrics["verify_steps"] > 0
        if e1.paged:
            assert e1.pool.available == e1.pool.total
            e1.pool.check()
    assert e1.metrics["spec_proposed"] > 0


def test_greedy_spec_shared_prefix_streams(stack):
    """Shared admissions, catch-up riders and copy-on-write compose with
    speculation: the streams are the plain engine's."""
    _, _, model, params = stack
    a, b = _shared_reqs(4), _shared_reqs(4)
    _eng(model, params, batch_size=4, max_seq=64, paged=True,
         block_size=8).run(list(a))
    e1 = _spec(model, params, params, batch_size=4, max_seq=64, paged=True,
               block_size=8)
    e1.run(list(b))
    for x, y in zip(a, b):
        assert x.out_tokens == y.out_tokens, x.rid
    assert e1.metrics["shared_admissions"] >= 1
    assert e1.metrics["spec_accepted"] > 0
    assert e1.pool.available == e1.pool.total
    e1.pool.check()


def test_self_draft_accepts_everything_and_multiplies_tokens(stack):
    _, _, model, params = stack
    eng = _spec(model, params, params, batch_size=2, max_seq=64, paged=True,
                block_size=8)
    reqs = _reqs([6, 9], max_new=8)
    eng.run(list(reqs))
    m = eng.metrics
    assert m["spec_accepted"] == m["spec_proposed"] > 0
    emitted = sum(len(r.out_tokens) for r in reqs)
    assert (emitted - len(reqs)) / m["decode_steps"] > 1.0


def test_spec_rollback_returns_watermark_blocks(stack, cold):
    _, _, model, params = stack
    eng = _spec(model, params, cold[1], batch_size=1, max_seq=64,
                paged=True, block_size=4)
    (req,) = _reqs([7], max_new=10)
    eng.run([req])
    assert eng.metrics["spec_blocks_rolled_back"] > 0
    assert eng.pool.available == eng.pool.total
    eng.pool.check()
    (d,) = _eng(model, params, batch_size=1, max_seq=64, paged=True,
                block_size=4).run([Request(rid=100, prompt=list(req.prompt),
                                           max_new_tokens=10)])
    assert d.out_tokens == req.out_tokens


def test_per_request_speculation_opt_out(stack):
    _, _, model, params = stack
    base = _reqs([6, 8])
    _eng(model, params, batch_size=2, max_seq=64).run(list(base))
    spec = _reqs([6, 8])
    spec[1].speculation = 0
    eng = _spec(model, params, params, batch_size=2, max_seq=64)
    eng.run(list(spec))
    for a, b in zip(base, spec):
        assert a.out_tokens == b.out_tokens, a.rid
    assert eng.metrics["spec_proposed"] > 0


def test_speculation_validation(stack):
    """The reference's ValueErrors: no draft, an MoE target, a recurrent
    target, a recurrent draft."""
    _, _, model, params = stack
    kw = dict(batch_size=1, max_seq=32)
    with pytest.raises(ValueError, match="draft model"):
        _eng(model, params, speculation=2, **kw)
    mo = build_model(get_config("grok-1-314b").reduced(), device="cpu")
    mp = mo.init(0)
    with pytest.raises(ValueError, match="MoE"):
        _spec(mo, mp, mp, k=2, **kw)
    rm = build_model(get_config("rwkv6-1.6b").reduced(), device="cpu")
    rp = rm.init(0)
    with pytest.raises(ValueError, match="pure-attention"):
        _eng(rm, rp, draft_model=model, draft_params=params, speculation=2,
             **kw)
    with pytest.raises(ValueError, match="draft model"):
        _eng(model, params, draft_model=rm, draft_params=rp, speculation=2,
             **kw)


def test_blocks_needed_charges_spec_watermark(stack):
    _, _, model, params = stack
    plain = _eng(model, params, batch_size=2, max_seq=64, paged=True,
                 block_size=4)
    spec = _spec(model, params, params, batch_size=2, max_seq=64,
                 paged=True, block_size=4)
    (r,) = _reqs([8], max_new=8)
    assert plain.blocks_needed(r) == 2
    assert spec.blocks_needed(r) == 3
    r2 = Request(rid=9, prompt=[3] * 8, max_new_tokens=8, speculation=0)
    assert spec.blocks_needed(r2) == 2


def test_scheduler_drains_speculative_engine(stack):
    _, _, model, params = stack
    eng = _spec(model, params, params, k=2, batch_size=2, max_seq=64,
                paged=True, block_size=8)
    sched = Scheduler(eng, policy="fifo")
    for r in _reqs([5, 9, 7], max_new=5):
        assert sched.submit(r)
    assert len(sched.drain()) == 3
    assert eng.metrics["verify_steps"] > 0
    assert eng.pool.available == eng.pool.total


def test_sampled_spec_reproducible_and_exhaustive(stack):
    _, _, model, params = stack
    sp = SamplingParams(temperature=0.8, top_k=12, seed=17)
    outs = []
    for _ in range(2):
        reqs = _reqs([6, 9], max_new=7, sampling=sp)
        _spec(model, params, params, batch_size=2, max_seq=64, paged=True,
              block_size=8).run(list(reqs))
        outs.append([r.out_tokens for r in reqs])
        for r in reqs:
            assert len(r.out_tokens) == len(r.out_logprobs) == 7
            assert all(np.isfinite(r.out_logprobs))
    assert outs[0] == outs[1]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10 ** 6),
       block_size=st.sampled_from([4, 8]),
       spec_k=st.integers(min_value=1, max_value=4))
def test_property_spec_rollback_never_corrupts_coholder(stack, seed,
                                                        block_size, spec_k):
    """Shared-prefix requests under a tight pool with speculation on:
    copy-on-write, parking, preemption, watermark growth and rollback
    interleave; every stream equals its uncontended solo run and the
    pool drains clean."""
    _, _, model, params = stack
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 4))
    reqs = _shared_reqs(n, prefix_len=int(rng.integers(6, 14)),
                        suffix_len=int(rng.integers(1, 4)),
                        max_new=int(rng.integers(4, 10)),
                        seed=int(rng.integers(0, 2 ** 31)))
    eng = _spec(model, params, params, k=spec_k, batch_size=n, max_seq=64,
                paged=True, block_size=block_size,
                num_blocks=int(rng.integers(7, 13)))
    assert len(eng.run(list(reqs))) == len(reqs)
    assert eng.pool.available == eng.pool.total
    eng.pool.check()
    for r in reqs:
        solo = _eng(model, params, batch_size=1, max_seq=64, paged=True,
                    block_size=block_size, prefix_sharing=False)
        (d,) = solo.run([Request(rid=100 + r.rid, prompt=list(r.prompt),
                                 max_new_tokens=r.max_new_tokens)])
        assert d.out_tokens == r.out_tokens, r.rid


# ================================================= logprobs + cached reuse
def test_logprobs_match_manual_log_softmax(stack):
    _, _, model, params = stack
    (req,) = _reqs([6], max_new=3)
    _eng(model, params, batch_size=1, max_seq=64).run([req])
    logits, _ = model.prefill(params, {"tokens": torch.tensor([req.prompt])})
    ref = torch.log_softmax(logits[0, -1].float(), dim=-1)
    assert len(req.out_logprobs) == len(req.out_tokens) == 3
    assert req.out_logprobs[0] == pytest.approx(
        float(ref[req.out_tokens[0]]), rel=1e-5)
    assert int(logits[0, -1].argmax()) == req.out_tokens[0]


def test_sequential_identical_prompts_reuse_cached_blocks(stack):
    _, _, model, params = stack
    eng = _eng(model, params, batch_size=2, max_seq=64, paged=True,
               block_size=8, prefix_sharing=True)
    (first,) = _reqs([20], max_new=4, seed=9)
    eng.run([first])
    assert eng.pool.available == eng.pool.total
    assert eng.pool.cached > 0
    second = Request(rid=10, prompt=list(first.prompt), max_new_tokens=4)
    eng.run([second])
    assert eng.metrics["shared_admissions"] == 1
    assert eng.metrics["prefill_tokens_shared"] >= 16
    assert second.out_tokens == first.out_tokens
    eng.pool.check()
    off = _eng(model, params, batch_size=2, max_seq=64, paged=True,
               block_size=8, prefix_sharing=False)
    (a,) = _reqs([20], max_new=4, seed=9)
    off.run([a])
    b = Request(rid=11, prompt=list(a.prompt), max_new_tokens=4)
    off.run([b])
    assert off.metrics["shared_admissions"] == 0
    assert b.out_tokens == a.out_tokens


def test_revived_blocks_not_double_counted_in_batch_planning(stack):
    _, _, model, params = stack
    eng = _eng(model, params, batch_size=4, max_seq=64, paged=True,
               block_size=8, num_blocks=8, prefix_sharing=True)
    (first,) = _reqs([20], max_new=2, seed=13)
    eng.run([first])
    assert eng.pool.cached == 3
    again = Request(rid=20, prompt=list(first.prompt), max_new_tokens=2)
    (other,) = _reqs([12], max_new=2, seed=14)
    other.rid = 21
    assert eng.add_requests([again, other]) == 2
    assert len(eng.run([])) == 2
    assert eng.metrics["shared_admissions"] == 1
    eng.pool.check()


def test_sampled_opt_out_stream_independent_of_neighbors(stack):
    """A sampled rider draws from the token stream at the plain step's
    counter, whether or not its neighbour speculates."""
    _, _, model, params = stack
    sp = SamplingParams(temperature=0.8, top_k=10, seed=31)
    (plain,) = _reqs([6], max_new=6, seed=2, sampling=sp)
    _eng(model, params, batch_size=2, max_seq=64, paged=True,
         block_size=8).run([plain])
    (rider,) = _reqs([6], max_new=6, seed=2, sampling=sp)
    rider.speculation = 0
    (neighbor,) = _reqs([9], max_new=6, seed=3)
    neighbor.rid = 50
    eng = _spec(model, params, params, batch_size=2, max_seq=64, paged=True,
                block_size=8)
    eng.run([rider, neighbor])
    assert eng.metrics["spec_proposed"] > 0
    assert rider.out_tokens == plain.out_tokens


# ===================================== the port's engine vs the reference's
SAMPLED = [dict(temperature=0.8, top_k=8, seed=3), dict(),
           dict(temperature=1.2, seed=-1), dict(),
           dict(temperature=0.5, top_k=1, seed=7), dict()]
# speculation per request: engine default, opted out, opted down to 1
SPEC = [None, 0, None, 1, None, None]


def _serve_spec(engine_cls, request_cls, samp_cls, model, params, dparams,
                engine_kw, sampled, **kw):
    """Six requests (mixed lengths, two sharing a 20-token prefix, a
    40-token prompt that chunks by 8) through a k = 3 speculating engine
    with a cold draft: chunk ticks, riders, opt-out / opt-down rows,
    rollback and slot reuse all run."""
    prompts = _prompts([5, 11, 40, 7], seed=21) + \
        _prompts([3, 6], seed=22, prefix=20)
    eng = engine_cls(model, params, batch_size=4, max_seq=64,
                     draft_model=model, draft_params=dparams, speculation=3,
                     prefill_chunk=8, **engine_kw, **kw)
    reqs = []
    for i, p in enumerate(prompts):
        extra = {"sampling": samp_cls(**SAMPLED[i])} if sampled else {}
        reqs.append(request_cls(rid=i, prompt=p, max_new_tokens=7 + i % 3,
                                speculation=SPEC[i], **extra))
    assert len(eng.run(list(reqs))) == len(reqs)
    return eng, reqs


@pytest.fixture(scope="module", params=["mha", "gqa"])
def spec_pair(request):
    kw = {} if request.param == "mha" else {"n_kv_heads": 2}
    jmodel, jparams, model, params = _pair(**kw)
    jdraft = jmodel.init(jax.random.key(9))
    dparams = params_from_numpy(jax.tree.map(np.asarray, jdraft), model.cfg,
                                "cpu")
    return jmodel, jparams, jdraft, model, params, dparams


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", [
    dict(paged=True, block_size=8, use_kernel=True),
    dict(paged=False)], ids=["paged", "stripes"])
def test_speculating_engine_matches_jax(spec_pair, layout, sampled):
    jmodel, jparams, jdraft, model, params, dparams = spec_pair
    jeng, jreqs = _serve_spec(JaxEngine, JaxRequest, JaxSamplingParams,
                              jmodel, jparams, jdraft, layout, sampled)
    eng, reqs = _serve_spec(ServingEngine, Request, SamplingParams, model,
                            params, dparams, layout, sampled, device="cpu")
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert eng.metrics == jeng.metrics
    assert eng.pool_stats() == jeng.pool_stats()
    m = eng.metrics
    assert m["verify_steps"] > 0 and m["chunk_steps"] > 0
    assert m["spec_proposed"] > m["spec_accepted"]
    if eng.paged:
        assert m["spec_blocks_rolled_back"] > 0
        assert eng.pool.available == eng.pool.total


def test_draft_runner_matches_jax(stack, cold):
    """The runner alone: admission, a catch-up window and k = 4 draws for
    3 of 4 slots (one sampled), against the reference's runner on the
    same weights. Proposals are equal (the idle slot proposes 0); the
    proposal distributions agree within 1e-5 (f32 softmax of logits
    that agree within 1e-4, scaled by 1 / temperature)."""
    jmodel, _, model, _ = stack
    jd, pd = cold
    prompts = _prompts([9, 4, 17, 6], seed=31)
    jr = JaxDraftRunner(jmodel, jd, batch_size=4, max_seq=64)
    pr = DraftRunner(model, pd, batch_size=4, max_seq=64)
    members = [(s, p[:-3]) for s, p in enumerate(prompts)]
    jr.admit(members)
    pr.admit(members)
    tails = [p[-3:] for p in prompts]
    tails[2] = None
    rows = [0, 1, 3]
    temps = np.asarray([0.0, 0.9, 0.0, 0.0], np.float32)
    top_ks = np.asarray([0, 20, 0, 0], np.int32)
    seeds = np.asarray([1, 2, 3, 4], np.int32)
    ctrs = np.asarray([0, 3, 0, 5], np.int32)
    jp, jprobs = jr.propose(tails, rows, 4, *map(jnp.asarray,
                                                 (temps, top_ks, seeds,
                                                  ctrs)))
    tp, tprobs = pr.propose(tails, rows, 4, temps, top_ks, seeds, ctrs)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for i in rows:
        np.testing.assert_allclose(tprobs[i].numpy(),
                                   np.asarray(jprobs)[i], atol=1e-5,
                                   rtol=1e-5)
    assert pr.steps_run == jr.steps_run == 5 and pr.ingest_steps == 1
    np.testing.assert_array_equal(pr.len, jr.len)
