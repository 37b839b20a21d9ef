"""The port's dense decoder against the JAX reference on the CPU.

Both sides run the same weights (the reference's ``init_params``, carried
over through numpy by ``params_from_numpy``) on the same numpy inputs,
in f32, for reduced qwen3-4b (MHA: 4 q heads, 4 KV heads), a GQA
variant (2 KV heads, G = 2) and the other dense configs, reduced:
deepseek-7b, minitron-8b (relu2, no gate) and nemotron-4-340b (relu2).
Logits agree within atol = rtol = 1e-4.
The paged calls run the port both through the gather path and through
the kernel ops (their plain version on CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model, init_params
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
# stack id -> (config, overrides of its reduced variant)
VARIANTS = {"mha": ("qwen3-4b", {}), "gqa": ("qwen3-4b", {"n_kv_heads": 2}),
            **{name: (name, {}) for name in ("deepseek-7b", "minitron-8b",
                                             "nemotron-4-340b")}}
DENSE = ["qwen3-4b", "deepseek-7b", "minitron-8b", "nemotron-4-340b"]
FRONTENDS = ["whisper-tiny", "qwen2-vl-2b"]
BS, MAX_BLOCKS, B = 8, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(VARIANTS))
def stack(request):
    name, kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params, {}


def _once(memo, key, fn):
    """The reference's result for ``key``, computed once per variant (the
    port runs each case twice: gather path and kernel ops)."""
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _paged_state(cfg, lens, S, seed):
    """A random resident pool (L, nb, bs, Hkv, hd) and disjoint tables
    covering lens[b] + S tokens per row; tails point at scratch."""
    rng = np.random.default_rng(seed)
    nb = B * MAX_BLOCKS + 1
    shape = (cfg.n_layers, nb, BS, cfg.n_kv_heads, cfg.hd)
    pool = {k: rng.standard_normal(shape, np.float32) for k in ("k", "v")}
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((B, MAX_BLOCKS), np.int32)
    for b, n in enumerate(lens):
        for i in range(-(-(n + S) // BS)):
            table[b, i] = free.pop()
    return pool, table, np.asarray(lens, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _tpool(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(kw or TOL))


def test_prefill_matches_jax(stack):
    jmodel, jparams, model, params, _ = stack
    rng = np.random.default_rng(1)
    toks = rng.integers(2, model.cfg.vocab_size, (B, 16)).astype(np.int32)
    last = np.asarray([15, 9, 4], np.int32)
    jl, jkv = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                             last_idx=jnp.asarray(last))
    tl, tkv = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                            last_idx=torch.from_numpy(last))
    assert tl.shape == (B, 1, model.cfg.vocab_size)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tkv[key], jkv[key])
    # no last_idx: the final position
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_step_matches_jax(stack, use_kernel):
    jmodel, jparams, model, params, memo = stack
    pool, table, lens = _paged_state(model.cfg, [5, 17, 0], 1, seed=2)
    tok = np.asarray([[7], [100], [3]], np.int32)
    jl, jpool = _once(memo, "decode", lambda: jmodel.decode_step(
        jparams, jnp.asarray(tok), {k: jnp.asarray(v) for k, v in
                                    pool.items()},
        jnp.asarray(lens), block_table=jnp.asarray(table)))
    tpool = _tpool(pool)
    tl, out = model.decode_step(params, *_torch(tok), tpool,
                                *_torch(lens), block_table=_torch(table)[0],
                                paged_kernel=use_kernel)
    assert out["k"] is tpool["k"]                       # updated in place
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tpool[key], jpool[key])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_verify_step_matches_jax(stack, use_kernel):
    """Multi-token window with the n_write diversion: full, partial and
    parked rows. Logits agree on every position a row owns."""
    jmodel, jparams, model, params, memo = stack
    S = 4
    pool, table, lens = _paged_state(model.cfg, [3, 12, 20], S, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(2, model.cfg.vocab_size, (B, S)).astype(np.int32)
    n_write = np.asarray([S, 2, 0], np.int32)
    jl, jpool = _once(memo, "verify", lambda: jmodel.verify_step(
        jparams, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in
                                     pool.items()},
        jnp.asarray(lens), block_table=jnp.asarray(table),
        n_write=jnp.asarray(n_write)))
    tpool = _tpool(pool)
    t_toks, t_lens, t_table, t_nw = _torch(toks, lens, table, n_write)
    tl, _ = model.verify_step(params, t_toks, tpool, t_lens,
                              block_table=t_table, paged_kernel=use_kernel,
                              n_write=t_nw)
    assert tl.shape == (B, S, model.cfg.vocab_size)
    for b in range(B):
        c = int(n_write[b])
        _close(tl[b, :c], np.asarray(jl)[b, :c])
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], np.asarray(jpool[key])[:, 1:])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_chunked_prefill_matches_jax(stack, use_kernel):
    """Chunk window with per-row fed counts: only each row's last fed
    position is projected against the vocabulary."""
    jmodel, jparams, model, params, memo = stack
    W = 8
    pool, table, lens = _paged_state(model.cfg, [0, 9, 16], W, seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(2, model.cfg.vocab_size, (B, W)).astype(np.int32)
    n_write = np.asarray([W, 5, 1], np.int32)
    last = n_write - 1
    jl, jpool = _once(memo, "chunk", lambda: jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks)},
        cache={k: jnp.asarray(v) for k, v in pool.items()},
        cache_len=jnp.asarray(lens), block_table=jnp.asarray(table),
        n_write=jnp.asarray(n_write), last_idx=jnp.asarray(last)))
    tpool = _tpool(pool)
    t_toks, t_lens, t_table, t_nw, t_last = _torch(toks, lens, table,
                                                   n_write, last)
    tl, _ = model.prefill(params, {"tokens": t_toks}, cache=tpool,
                          cache_len=t_lens, block_table=t_table,
                          paged_kernel=use_kernel, n_write=t_nw,
                          last_idx=t_last)
    assert tl.shape == (B, 1, model.cfg.vocab_size)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], np.asarray(jpool[key])[:, 1:])


@pytest.mark.parametrize("W", [8, 1])
def test_stripe_window_past_the_end_matches_jax(stack, W):
    """Stripe caches (no block table): a chunk window (W = 8) or decode
    step (W = 1) whose positions run past the stripe's end. JAX drops
    those writes; the port masks them. Row 1 spills over the end, row 2
    is full; logits and the whole cache agree, and no position outside a
    row's written range changes."""
    jmodel, jparams, model, params, _ = stack
    cfg, T = model.cfg, 16
    rng = np.random.default_rng(10 + W)
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.hd)
    cache = {k: rng.standard_normal(shape, np.float32) for k in ("k", "v")}
    lens = np.asarray([4, 11 if W > 1 else T - 1, T], np.int32)
    toks = rng.integers(2, cfg.vocab_size, (B, W)).astype(np.int32)
    last = np.asarray([W - 1, W // 2, 0], np.int32)
    tcache = _tpool(cache)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    if W > 1:
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache=jc, cache_len=jnp.asarray(lens),
                                last_idx=jnp.asarray(last))
        tl, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              cache=tcache, cache_len=torch.from_numpy(lens),
                              last_idx=torch.from_numpy(last))
    else:
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(toks), jc,
                                    jnp.asarray(lens))
        tl, _ = model.decode_step(params, torch.from_numpy(toks), tcache,
                                  torch.from_numpy(lens))
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jc[key])
        for b, n in enumerate(lens):
            kept = np.r_[0:n, min(n + W, T):T]
            np.testing.assert_array_equal(tcache[key][:, b, kept].numpy(),
                                          cache[key][:, b, kept])


# ------------------------------------------------------------- weights
def test_params_from_numpy_is_leafwise_and_strict():
    jcfg = jax_config("qwen3-4b").reduced()
    cfg = get_config("qwen3-4b").reduced()
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(1)))
    p = params_from_numpy(tree, cfg, "cpu")
    np.testing.assert_array_equal(p["blocks"]["attn"]["w_kv"].numpy(),
                                  tree["blocks"]["attn"]["w_kv"])
    ref = init_params(cfg, device="meta")
    assert jax.tree.map(lambda a: a.shape, tree) == \
        jax.tree.map(lambda t: tuple(t.shape), ref,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unmapped"):
        params_from_numpy(extra, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(missing, cfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad, cfg, "cpu")


def _specs(tree):
    """{path: (shape, dtype name)} of a numpy / jax / torch tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _specs(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("name", DENSE + FRONTENDS + ["rwkv6-1.6b",
                                                      "hymba-1.5b"])
def test_param_dtypes_and_shapes_match_the_reference(name):
    """Every leaf keeps the reference's shape and dtype: bf16 leaves
    follow cfg.dtype, the f32 ones (decay_base, bonus_u, A_log, D,
    dt_bias) stay f32 — through the weight bridge at reduced width, and
    from the port's own init at full width (on the meta device); the
    frontends' encoder and cross-attention leaves included."""
    jcfg = dataclasses.replace(jax_config(name).reduced(),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_config(name).reduced(),
                              dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(3)))
    assert _specs(params_from_numpy(tree, cfg, "cpu")) == _specs(tree)
    full = jax.eval_shape(jax_build(jax_config(name)).init,
                          jax.random.key(0))
    assert _specs(init_params(get_config(name), device="meta")) == \
        _specs(full)
    assert "float32" in {d for _, d in _specs(full).values()} \
        or name in DENSE + FRONTENDS


def test_params_from_numpy_keeps_bf16_bits():
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(2)))
    p = params_from_numpy(tree, cfg, "cpu")
    w = p["blocks"]["ffn"]["w_gate"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  tree["blocks"]["ffn"]["w_gate"]
                                  .view(np.int16))


def test_init_params_seeded_on_cpu():
    cfg = get_config("qwen3-4b").reduced()
    a, b, c = (init_params(cfg, s, device="cpu") for s in (0, 0, 1))
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert a["blocks"]["attn"]["w_q"].shape == (cfg.n_layers, cfg.d_model,
                                                cfg.n_heads * cfg.hd)
    assert a["embed"].shape[0] == 512 and a["embed"].dtype == torch.float32


# ---------------------------------------------------- layers, attention
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_layers_match_jax(act):
    from repro.models import layers as jax_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 3, 32), np.float32)
    g = rng.standard_normal(32, np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
           jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    _close(layers.act_fn(act)(torch.from_numpy(x)),
           jax_layers.act_fn(act)(jnp.asarray(x)))


@pytest.mark.parametrize("S,win", [(100, 0), (2048, 0), (2048, 300)])
def test_causal_attention_matches_jax(S, win):
    """Prefill attention incl. the Q_CHUNK loop (S a multiple of 1024)."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    rng = np.random.default_rng(S + win)
    q = rng.standard_normal((1, S, 4, 32), np.float32)
    k = rng.standard_normal((1, S, 2, 32), np.float32)
    v = rng.standard_normal((1, S, 2, 32), np.float32)
    out = attention.causal_attention(*_torch(q, k, v), sliding_window=win)
    ref = jax_attention.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), sliding_window=win)
    _close(out, ref)
