"""The port's MoE FFN and MoE serving against the JAX reference on the CPU.

The same inputs, made with numpy from fixed seeds, and the same expert
weights (the reference's ``init_moe`` / ``init_params``, carried over
through numpy) go through both packages in f32: ``route`` agrees within
1e-6 (weights, aux) with identical expert ids, ``dispatch_tables`` gives
the reference's tables exactly (capacity drops included),
``moe_ffn_local`` agrees within 1e-5; the six ``tests/test_moe.py``
properties hold on the port. Reduced ``grok-1-314b`` and
``kimi-k2-1t-a32b`` engines (solo prefills, no prefix sharing, no
chunking, no speculation) emit the reference engine's streams with
logprobs within 2e-5 and equal ``metrics`` / ``pool_stats()``, paged and
on stripes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import get_config as jax_config
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro_torch.configs.base import get_config
from repro_torch.models import layers, moe
from repro_torch.models.model import build_model, init_params
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.sharding.rules import ParallelPlan
from repro_torch.weights import params_from_numpy

MOE = ["grok-1-314b", "kimi-k2-1t-a32b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(T=64, cf=8.0, name="grok-1-314b", seed=0):
    """(jax cfg, port cfg, jax params, port params, x numpy (T, d)): the
    reference's ``init_moe`` weights and a numpy input."""
    jcfg = dataclasses.replace(jax_config(name).reduced(),
                               capacity_factor=cf)
    cfg = dataclasses.replace(get_config(name).reduced(), capacity_factor=cf)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def dense_reference(x, p, cfg):
    """No-capacity reference: every token through its top-k experts."""
    w, ids, _ = moe.route(x, p["router"], cfg)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        pe = {k_: v[e] for k_, v in p.items() if k_ != "router"}
        ye = layers.mlp(x, pe, cfg.act)
        gate = torch.where(ids == e, w, 0.0).sum(-1)
        out = out + ye * gate[:, None]
    return out


# ---------------------------------------------------------- the pieces
@pytest.mark.parametrize("name", MOE)
def test_route_matches_jax(name):
    jcfg, cfg, jp, p, x = setup(name=name, cf=1.0)
    jw, jids, jaux = jax_moe.route(jnp.asarray(x), jp["router"], jcfg)
    w, ids, aux = moe.route(torch.from_numpy(x), p["router"], cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6, rel=1e-6)


def test_route_breaks_ties_like_jax():
    """Equal probabilities (a zero router): the lower expert ids win, in
    ascending order, as ``jax.lax.top_k`` orders them."""
    jcfg, cfg, jp, p, x = setup()
    _, jids, _ = jax_moe.route(jnp.asarray(x), jp["router"] * 0.0, jcfg)
    _, ids, _ = moe.route(torch.from_numpy(x), p["router"] * 0.0, cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids.numpy() == np.arange(cfg.top_k)).all()


@pytest.mark.parametrize("cf", [0.25, 1.0, 8.0])
@pytest.mark.parametrize("name", MOE)
def test_dispatch_tables_match_jax_exactly(name, cf):
    """Token and gate tables equal, capacity drops included (cf 0.25
    drops most pairs), for the whole expert range and a sub-range."""
    jcfg, cfg, jp, p, x = setup(T=48, cf=cf, name=name)
    jw, jids, _ = jax_moe.route(jnp.asarray(x), jp["router"], jcfg)
    ids = torch.from_numpy(np.array(jids)).long()
    w = torch.from_numpy(np.array(jw))
    C = moe.capacity(48, cfg)
    assert C == jax_moe.capacity(48, jcfg)
    kept = {}
    for e0, E_loc in ((0, cfg.n_experts), (1, 2)):
        jt, jg = jax_moe.dispatch_tables(jids, jw, e0, E_loc, C)
        tok, gw = moe.dispatch_tables(ids, w, e0, E_loc, C)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(jg))
        kept[E_loc] = int((tok < 48).sum())
    # pairs placed over all experts: every one at cf 8, not at cf 0.25
    if cf != 1.0:
        assert (kept[cfg.n_experts] < 48 * cfg.top_k) == (cf == 0.25)


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_local_matches_jax(name, cf):
    jcfg, cfg, jp, p, x = setup(T=40, cf=cf, name=name)
    jout, jaux = jax_moe.moe_ffn_local(jnp.asarray(x), jp, jcfg)
    out, aux = moe.moe_ffn_local(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6, rel=1e-6)
    jh, _ = jax_moe.moe_ffn_local(jnp.asarray(x), jp, jcfg, e0=1, E_loc=2)
    h, _ = moe.moe_ffn_local(torch.from_numpy(x), p, cfg, e0=1, E_loc=2)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)


def test_combine_sums_in_expert_order():
    """Every token's output is its kept slots' outputs added in ascending
    expert order, bit for bit, and a token with every choice dropped
    gets 0."""
    _, cfg, _, p, x = setup(T=32, cf=0.25)
    xt = torch.from_numpy(x)
    w, ids, _ = moe.route(xt, p["router"], cfg)
    C = moe.capacity(32, cfg)
    tok, gw = moe.dispatch_tables(ids, w, 0, cfg.n_experts, C)
    y = torch.randn((cfg.n_experts, C, cfg.d_model))
    out = moe.combine(y, tok, ids, 32, 0, cfg.n_experts)
    for t in range(32):
        parts = [y[e, c] for e in range(cfg.n_experts) for c in range(C)
                 if tok[e, c] == t]
        want = torch.zeros(cfg.d_model)
        if parts:
            want = parts[0]
            for q in parts[1:]:
                want = want + q
        assert torch.equal(out[t], want), t


def test_moe_ffn_raises_for_a_plan():
    """A plan without a mesh is the one-device path, bit for bit; a
    mesh whose model axis neither divides the experts nor their d_ff
    makes no plan (the reference's assertion)."""
    _, cfg, _, p, x = setup(T=4)
    xt = torch.from_numpy(x)[None]
    want, aux = moe.moe_ffn(xt, p, cfg)
    got, got_aux = moe.moe_ffn(xt, p, cfg, plan=ParallelPlan.make(None, cfg))
    assert torch.equal(got, want) and torch.equal(got_aux, aux)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        with pytest.raises(AssertionError, match="unshardable"):
            ParallelPlan.make(mesh, dataclasses.replace(cfg, moe_d_ff=24))
    finally:
        dist.destroy_process_group()


# ------------------------------------ tests/test_moe.py on the port
def test_high_capacity_matches_dense_reference():
    jcfg, cfg, jp, p, x = setup(cf=8.0)
    out, _ = moe.moe_ffn_local(torch.from_numpy(x), p, cfg)
    ref = dense_reference(torch.from_numpy(x), p, cfg)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    jout, _ = jax_moe.moe_ffn_local(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_expert_partition_sums_to_full():
    _, cfg, _, p, x = setup(cf=8.0)
    xt = torch.from_numpy(x)
    full, _ = moe.moe_ffn_local(xt, p, cfg)
    half = cfg.n_experts // 2
    p1, _ = moe.moe_ffn_local(xt, p, cfg, e0=0, E_loc=half)
    p2, _ = moe.moe_ffn_local(xt, p, cfg, e0=half, E_loc=half)
    torch.testing.assert_close(p1 + p2, full, atol=2e-4, rtol=2e-4)


def test_capacity_drops_tokens_but_stays_finite():
    jcfg, cfg, jp, p, x = setup(T=128, cf=0.25)
    xt = torch.from_numpy(x)
    out, _ = moe.moe_ffn_local(xt, p, cfg)
    assert torch.isfinite(out).all()
    assert not torch.allclose(out, dense_reference(xt, p, cfg), atol=1e-3)
    jout, _ = jax_moe.moe_ffn_local(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_aux_loss_penalizes_imbalance():
    _, cfg, _, p, x = setup()
    xt = torch.from_numpy(x)
    _, _, aux_bal = moe.route(xt, p["router"] * 0.0, cfg)
    router0 = torch.zeros_like(p["router"])
    router0[:, 0] = 1.0
    _, ids, aux_col = moe.route(torch.ones_like(xt), router0, cfg)
    assert int(ids[:, 0].max()) == 0
    assert float(aux_col) > 2.0 * float(aux_bal)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=4))
def test_dispatch_tables_are_valid(seed):
    jcfg, cfg, jp, p, x = setup(T=32, cf=1.0)
    w, ids, _ = moe.route(torch.from_numpy(x + seed), p["router"], cfg)
    C = moe.capacity(32, cfg)
    tok, gw = moe.dispatch_tables(ids, w, 0, cfg.n_experts, C)
    jw, jids, _ = jax_moe.route(jnp.asarray(x + seed), jp["router"], jcfg)
    jt, _ = jax_moe.dispatch_tables(jids, jw, 0, cfg.n_experts, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    tok, gw = tok.numpy(), gw.numpy()
    assert tok.shape == (cfg.n_experts, C)
    assert ((tok >= 0) & (tok <= 32)).all()
    assert (gw >= 0).all() and (gw <= 1.0 + 1e-6).all()
    for e in range(cfg.n_experts):
        real = tok[e][tok[e] < 32]
        assert len(set(real.tolist())) == len(real)


def test_capacity_rounding():
    jcfg, cfg, _, _, _ = setup()
    for n in (1, 7, 300, 1024):
        assert moe.capacity(n, cfg) == jax_moe.capacity(n, jcfg)
    c = moe.capacity(1024, cfg)
    assert c % 8 == 0
    assert c >= 1024 * cfg.top_k * cfg.capacity_factor / cfg.n_experts


# -------------------------------------------------------- weights
def _specs(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _specs(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("name", MOE)
def test_param_shapes_and_dtypes_match_the_reference(name):
    """moe/{router (f32), w_in, w_gate, w_out} with the expert axis after
    L: through the weight bridge at reduced width (bf16), and from the
    port's own init at full width on the meta device (nothing
    allocated)."""
    jcfg = dataclasses.replace(jax_config(name).reduced(),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_config(name).reduced(),
                              dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(3)))
    specs = _specs(params_from_numpy(tree, cfg, "cpu"))
    assert specs == _specs(tree)
    assert specs["blocks/moe/router"][1] == "float32"
    assert specs["blocks/moe/w_in"] == ((2, 4, 256, 256), "bfloat16")
    full = jax.eval_shape(jax_build(jax_config(name)).init,
                          jax.random.key(0))
    fspecs = _specs(init_params(get_config(name), device="meta"))
    assert fspecs == _specs(full)
    c = get_config(name)
    assert fspecs["blocks/moe/w_out"][0] == (c.n_layers, c.n_experts,
                                             c.moe_d_ff, c.d_model)


# -------------------------------------------------------- serving
def _pair(name):
    jcfg = jax_config(name).reduced()
    cfg = get_config(name).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module", params=MOE)
def stack(request):
    return _pair(request.param)


def _prompts(lens, seed, prefix=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(2, 512, prefix).tolist()
    return [common + rng.integers(2, 512, n).tolist() for n in lens]


SAMPLED = [dict(temperature=0.8, top_k=8, seed=3), dict(),
           dict(temperature=1.2, seed=-1), dict(),
           dict(temperature=0.5, top_k=1, seed=7), dict(), dict()]


def _serve(engine_cls, request_cls, samp_cls, model, params, layout,
           sampled, **kw):
    """Seven requests, more than the 4 slots (slots are reused), two
    sharing a 20-token prefix, a 40-token prompt (no chunking for MoE)."""
    prompts = _prompts([5, 11, 40, 7, 23], seed=41) + \
        _prompts([3, 6], seed=42, prefix=20)
    eng = engine_cls(model, params, batch_size=4, max_seq=64, **layout,
                     **kw)
    reqs = []
    for i, pr in enumerate(prompts):
        extra = {"sampling": samp_cls(**SAMPLED[i])} if sampled else {}
        reqs.append(request_cls(rid=i, prompt=pr, max_new_tokens=5 + i % 3,
                                **extra))
    assert len(eng.run(list(reqs))) == len(reqs)
    return eng, reqs


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", [
    dict(paged=True, block_size=8, use_kernel=True),
    dict(paged=False)], ids=["paged", "stripes"])
def test_moe_engine_matches_jax(stack, layout, sampled):
    jmodel, jparams, model, params = stack
    jeng, jreqs = _serve(JaxEngine, JaxRequest, JaxSamplingParams, jmodel,
                         jparams, layout, sampled)
    eng, reqs = _serve(ServingEngine, Request, SamplingParams, model, params,
                       layout, sampled, device="cpu")
    for a, b in zip(jreqs, reqs):
        assert a.out_tokens == b.out_tokens, (a.rid, a.out_tokens,
                                              b.out_tokens)
        np.testing.assert_allclose(b.out_logprobs, a.out_logprobs,
                                   atol=2e-5, rtol=2e-5)
    assert eng.metrics == jeng.metrics
    assert eng.pool_stats() == jeng.pool_stats()
    m = eng.metrics
    # solo prefills, no sharing, no chunking
    assert m["prefill_batches"] == m["prefills"] == len(reqs)
    assert m["shared_admissions"] == m["chunk_steps"] == 0
    assert m["slot_reuses"] > 0
    if eng.paged:
        assert eng.pool.available == eng.pool.total
        eng.pool.check()


def test_moe_first_tokens_are_solo_prefills(stack):
    """Admitted together, each request's first token and logprob equal
    its own solo admission's."""
    _, _, model, params = stack
    prompts = _prompts([5, 9, 12], seed=43)
    eng = ServingEngine(model, params, batch_size=3, max_seq=64,
                        device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=1)
            for i, p in enumerate(prompts)]
    assert eng.add_requests(reqs) == 3
    assert eng.metrics["prefill_batches"] == 3
    for r in reqs:
        solo = ServingEngine(model, params, batch_size=1, max_seq=64,
                             device="cpu")
        (d,) = solo.run([Request(rid=9, prompt=list(r.prompt),
                                 max_new_tokens=1)])
        assert d.out_tokens == r.out_tokens
        assert d.out_logprobs == r.out_logprobs


def test_moe_engine_rules(stack):
    """MoE engines never share prefixes, never chunk (an explicit chunk
    raises) and never speculate (the reference's ValueError)."""
    _, _, model, params = stack
    kw = dict(batch_size=2, max_seq=32, device="cpu")
    eng = ServingEngine(model, params, prefix_sharing=True, **kw)
    assert eng.paged and not eng.prefix_sharing and eng.prefill_chunk == 0
    assert not eng._paddable and eng._solo_prefill
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(model, params, prefill_chunk=8, **kw)
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(model, params, draft_model=model, draft_params=params,
                      speculation=2, **kw)
