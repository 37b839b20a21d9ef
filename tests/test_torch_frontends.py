"""The port's modality frontends against the JAX reference on the CPU.

Reduced whisper-tiny (2 encoder + 2 decoder layers, d 256, 4 / 4 heads
of 32, ``n_frames`` 16: an audio encoder, cross-attention in every
decoder layer, learned sinusoidal positions) and reduced qwen2-vl-2b (2
layers, 4 / 2 heads of 32, ``n_patches`` 16 on a 4 x 4 grid: a patch
prefix with M-RoPE ids). Both sides run the reference's ``init_params``
weights, carried over through numpy by ``params_from_numpy``, on the
same numpy inputs, in f32. Layers agree within 1e-6, the encoder and
the cross K / V within 1e-5, logits and every cache leaf within 1e-4.

The reference's ``_run_stack`` pops ``xk`` / ``xv`` off the cache dict
it is given, so it always gets a copy of the dict here; the port reads
them in place.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs.base import get_config
from repro_torch.models import attention, layers
from repro_torch.models import model as port_model
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
FRONTENDS = ["whisper-tiny", "qwen2-vl-2b"]
B, S_TEXT, CAP = 3, 8, 32
LAST = np.asarray([7, 3, 5], np.int32)         # right-padded rows
BS, MAX_BLOCKS = 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=FRONTENDS)
def frontend(request):
    name = request.param
    jmodel = jax_model.build_model(jax_config(name).reduced())
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config(name).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


def _batch(cfg, seed, s_text=S_TEXT):
    """Tokens plus the frontend's frames or patch embeds (numpy)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab_size,
                                    (B, s_text)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model),
                                              np.float32)
    else:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), np.float32)
    return batch


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(kw or TOL))


def _prefilled(jmodel, jparams, model, params, seed, last_idx=None):
    """Prefill both sides and move the result into ``init_cache(B, CAP)``
    stripes: (reference cache, port cache, tokens cached per row)."""
    cfg = model.cfg
    batch = _batch(cfg, seed)
    kw = {} if last_idx is None else {"last_idx": last_idx}
    _, jkv = jmodel.prefill(jparams, _j(batch),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    _, tkv = model.prefill(params, _t(batch),
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    S = jkv["k"].shape[2]
    jc = dict(jmodel.init_cache(B, CAP))
    tc = model.init_cache(B, CAP)
    assert set(tc) == set(jc)
    for key in ("k", "v"):
        jc[key] = jc[key].at[:, :, :S].set(jkv[key])
        tc[key][:, :, :S] = tkv[key]
    for key in ("xk", "xv"):
        if key in jc:
            jc[key] = jkv[key]
            tc[key].copy_(tkv[key])
    prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    lens = np.full((B,), S, np.int32) if last_idx is None \
        else (last_idx + 1 + prefix).astype(np.int32)
    return jc, tc, lens


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("d", [64, 256, 384])
@pytest.mark.parametrize("n_pos", [20, 1500])
def test_sinusoidal_pos_matches_jax(d, n_pos):
    """XLA's f32 exp rounds some of the frequencies one ulp off the
    correctly rounded value that torch's exp gives, so an angle (position
    x frequency) can round to the neighbouring f32, one ulp of the angle
    away: the two agree within n_pos x 2^-23 — 2.4e-6 at the reduced
    decoder's positions (< 20), 1.8e-4 at whisper's 1500 frames."""
    pos = np.arange(n_pos, dtype=np.int32).reshape(2, -1)
    _close(layers.sinusoidal_pos(torch.from_numpy(pos), d),
           jax_layers.sinusoidal_pos(jnp.asarray(pos), d),
           atol=n_pos * 2.0 ** -23, rtol=0)
    # the reference's frequencies divide by half - 1, not half
    out = layers.sinusoidal_pos(torch.tensor([1]), d)[0]
    assert out[d // 2 - 1].item() == pytest.approx(math.sin(1e-4), rel=1e-5)
    assert layers.sinusoidal_pos(torch.tensor([3]), d,
                                 torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd), np.float32)
    pos = rng.integers(0, 600, (2, 3, 9)).astype(np.int32)
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6),
           jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           atol=1e-6, rtol=0)
    # a section follows its own id only: moving the width id moves the
    # last ``sections[2]`` rotary pairs and nothing else
    moved = pos.copy()
    moved[:, 2] += 7
    a, b = (layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p), 1e6)
            for p in (pos, moved))
    half = hd // 2
    changed = (a != b).any(0).any(0).any(0)
    kept = half - sections[2]
    assert not changed[:kept].any() and changed[kept:half].all()
    assert layers.apply_mrope(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(pos), 1e6).dtype \
        == torch.bfloat16


def test_mrope_with_equal_ids_is_rope():
    """All three ids equal: M-RoPE rotates as plain RoPE does (so a decode
    token, which gets ``cache_len`` on every section, is plain-roped)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 32), np.float32))
    pos = torch.from_numpy(rng.integers(0, 900, (2, 5)).astype(np.int32))
    torch.testing.assert_close(
        layers.apply_mrope(x, pos[:, None].expand(2, 3, 5), 1e6),
        layers.apply_rope(x, pos, 1e6), atol=0, rtol=0)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 384), np.float32) * 3 + 1
    g, beta = (rng.standard_normal(384).astype(np.float32) for _ in "gb")
    _close(layers.layernorm(*map(torch.from_numpy, (x, g, beta))),
           jax_layers.layernorm(*map(jnp.asarray, (x, g, beta))),
           atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("P,S", [(16, 5), (256, 7), (1, 3), (12, 4), (0, 2)])
def test_mrope_positions_equal_jax(P, S):
    got = port_model._mrope_positions(2, P, S, "cpu")
    want = np.asarray(jax_model._mrope_positions(2, P, S))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ encoder
def test_run_encoder_and_cross_kv_match_jax():
    jmodel = jax_model.build_model(jax_config("whisper-tiny").reduced())
    jparams = jmodel.init(jax.random.key(1))
    cfg = get_config("whisper-tiny").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    frames = np.random.default_rng(5).standard_normal(
        (B, cfg.n_frames, cfg.d_model), np.float32)
    jenc = jax_model._run_encoder(jparams, jmodel.cfg, jnp.asarray(frames))
    enc = port_model._run_encoder(params, cfg, torch.from_numpy(frames))
    _close(enc, jenc, atol=1e-5, rtol=1e-5)
    for l in range(cfg.n_layers):
        jp = jax.tree.map(lambda t: t[l], jparams["blocks"]["xattn"])
        tp = {k: v[l] for k, v in params["blocks"]["xattn"].items()}
        jkv = jax_attention.encode_cross_kv(jenc, jp, jmodel.cfg)
        tkv = attention.encode_cross_kv(torch.from_numpy(np.array(jenc)),
                                        tp, cfg)
        for key in ("k", "v"):
            assert tkv[key].shape == (B, cfg.n_frames, cfg.n_kv_heads,
                                      cfg.hd)
            _close(tkv[key], jkv[key], atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("padded", [False, True], ids=["last", "last_idx"])
def test_prefill_matches_jax(frontend, padded):
    jmodel, jparams, model, params = frontend
    cfg = model.cfg
    batch = _batch(cfg, 1)
    kw = {"last_idx": LAST} if padded else {}
    jl, jkv = jmodel.prefill(jparams, _j(batch),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tkv = model.prefill(params, _t(batch),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tl.shape == (B, 1, cfg.vocab_size)
    _close(tl, jl)
    assert set(tkv) == set(jkv)
    for key in jkv:
        assert tkv[key].shape == jkv[key].shape, key
        _close(tkv[key], jkv[key])
    if cfg.frontend == "vision":
        assert tkv["k"].shape[2] == cfg.n_patches + S_TEXT
    else:
        assert tkv["xk"].shape == (cfg.n_layers, B, cfg.n_frames,
                                   cfg.n_kv_heads, cfg.hd)


# ------------------------------------------------------------- decode
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_stripe_decode_steps_match_jax(frontend, per_row):
    """Three chained decode steps on stripes after a prefill, the lengths
    one scalar (unpadded rows) or one per row (right-padded rows, each
    at its own position). For qwen2-vl the first step sits at P + S_text
    on all three M-RoPE sections, as the reference numbers it."""
    jmodel, jparams, model, params = frontend
    jc, tc, lens = _prefilled(jmodel, jparams, model, params, 2,
                              LAST if per_row else None)
    toks = np.random.default_rng(7).integers(
        2, model.cfg.vocab_size, (3, B, 1)).astype(np.int32)
    for step in range(3):
        n = lens + step
        jn = jnp.asarray(n) if per_row else jnp.asarray(int(n[0]))
        tn = torch.from_numpy(n) if per_row else torch.tensor(int(n[0]))
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(toks[step]),
                                    dict(jc), jn)
        tl, out = model.decode_step(params, torch.from_numpy(toks[step]),
                                    tc, tn)
        assert out is tc
        _close(tl, jl)
    for key in jc:
        _close(tc[key], jc[key])


def test_mrope_decode_position_jumps_past_the_prefix(monkeypatch):
    """The reference's quirk, kept: prefill numbers the text from the grid
    side g (text token j at g + j), decode from ``cache_len`` (P + j). So
    after P = 16 patches (g 4) and 8 text tokens, the last prefilled text
    id is 11 and the first decoded one is 24 on all three sections."""
    cfg = get_config("qwen2-vl-2b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    seen = []
    real = layers.apply_mrope
    monkeypatch.setattr(layers, "apply_mrope",
                        lambda x, pos, theta: seen.append(pos.clone())
                        or real(x, pos, theta))
    batch = _t(_batch(cfg, 3))
    _, kv = model.prefill(params, batch)
    assert seen[0][0, :, -1].tolist() == [11, 11, 11]
    cache = model.init_cache(B, CAP)
    S = kv["k"].shape[2]
    cache["k"][:, :, :S], cache["v"][:, :, :S] = kv["k"], kv["v"]
    seen.clear()
    model.decode_step(params, batch["tokens"][:, :1], cache,
                      torch.tensor(S))
    assert S == 24 and seen[0].tolist() == [[[24]] * 3] * B


# ------------------------------------------------------------ windows
@pytest.mark.parametrize("mode", ["verify", "chunk"])
def test_stripe_windows_match_jax(frontend, mode):
    """A 4-token verify window and a chunked-prefill window (per-row last
    positions projected) on stripes after a right-padded prefill."""
    jmodel, jparams, model, params = frontend
    jc, tc, lens = _prefilled(jmodel, jparams, model, params, 4, LAST)
    W = 4
    toks = np.random.default_rng(8).integers(
        2, model.cfg.vocab_size, (B, W)).astype(np.int32)
    if mode == "verify":
        jl, jc = jmodel.verify_step(jparams, jnp.asarray(toks), dict(jc),
                                    jnp.asarray(lens))
        tl, _ = model.verify_step(params, torch.from_numpy(toks), tc,
                                  torch.from_numpy(lens))
        assert tl.shape == (B, W, model.cfg.vocab_size)
    else:
        last = np.asarray([3, 1, 2], np.int32)
        jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache=dict(jc), cache_len=jnp.asarray(lens),
                                last_idx=jnp.asarray(last))
        tl, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              cache=tc, cache_len=torch.from_numpy(lens),
                              last_idx=torch.from_numpy(last))
        assert tl.shape == (B, 1, model.cfg.vocab_size)
    _close(tl, jl)
    for key in jc:
        _close(tc[key], jc[key])


def test_window_equals_sequential_decode_steps(frontend):
    """The port's own differential property at the frontends: a verify
    window's logits equal its tokens decoded one step at a time."""
    _, _, model, params = frontend
    cfg = model.cfg
    batch = _t(_batch(cfg, 9))
    _, kv = model.prefill(params, batch)
    S = kv["k"].shape[2]

    def fresh():
        c = model.init_cache(B, CAP)
        c["k"][:, :, :S], c["v"][:, :, :S] = kv["k"], kv["v"]
        for key in ("xk", "xv"):
            if key in c:
                c[key].copy_(kv[key])
        return c

    toks = torch.from_numpy(np.random.default_rng(10).integers(
        2, cfg.vocab_size, (B, 4)).astype(np.int32))
    lens = torch.full((B,), S, dtype=torch.int32)
    wl, wc = model.verify_step(params, toks, fresh(), lens)
    c = fresh()
    for j in range(4):
        sl, _ = model.decode_step(params, toks[:, j:j + 1], c, lens + j)
        torch.testing.assert_close(sl[:, 0], wl[:, j], **TOL)
    for key in c:
        torch.testing.assert_close(c[key], wc[key], **TOL)


def _paged_from_prefill(kv, lens, cfg, seed):
    """A pool (L, nb, BS, Hkv, hd) holding each row's first ``lens[b]``
    prefilled positions through a shuffled block table; table tails and
    unused blocks point at / hold noise in scratch block 0."""
    rng = np.random.default_rng(seed)
    nb = B * MAX_BLOCKS + 1
    shape = (cfg.n_layers, nb, BS, cfg.n_kv_heads, cfg.hd)
    pool = {k: rng.standard_normal(shape, np.float32) for k in ("k", "v")}
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((B, MAX_BLOCKS), np.int32)
    for b in range(B):
        for i in range(MAX_BLOCKS):
            table[b, i] = free.pop()
        for j in range(int(lens[b])):
            for key in ("k", "v"):
                pool[key][:, table[b, j // BS], j % BS] = \
                    np.asarray(kv[key])[:, b, j]
    return pool, table


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel_ops"])
@pytest.mark.parametrize("mode", ["decode", "verify", "chunk"])
def test_qwen2_vl_paged_matches_jax(use_kernel, mode):
    """qwen2-vl on the paged pool after a right-padded prefill with the
    vision prefix: a decode step, a verify window (one row's writes
    diverted past n_write) and a chunked-prefill window, through the
    gather path and through the kernel ops (their plain version on CPU
    tensors); M-RoPE ids follow ``cache_len``."""
    jcfg = jax_config("qwen2-vl-2b").reduced()
    cfg = get_config("qwen2-vl-2b").reduced()
    jmodel = jax_model.build_model(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    model = build_model(cfg, device="cpu")
    _, kv = jmodel.prefill(jparams, _j(_batch(cfg, 11)),
                           last_idx=jnp.asarray(LAST))
    lens = (LAST + 1 + cfg.n_patches).astype(np.int32)
    pool, table = _paged_from_prefill(kv, lens, cfg, 12)
    W = {"decode": 1, "verify": 4, "chunk": 6}[mode]
    toks = np.random.default_rng(13).integers(
        2, cfg.vocab_size, (B, W)).astype(np.int32)
    tpool = _t(pool)
    common = dict(block_table=jnp.asarray(table))
    tcommon = dict(block_table=torch.from_numpy(table),
                   paged_kernel=use_kernel)
    if mode == "decode":
        jl, jpool = jmodel.decode_step(jparams, jnp.asarray(toks),
                                       _j(pool), jnp.asarray(lens), **common)
        tl, _ = model.decode_step(params, torch.from_numpy(toks), tpool,
                                  torch.from_numpy(lens), **tcommon)
        rows = [(b, 1) for b in range(B)]
    elif mode == "verify":
        nw = np.asarray([W, 2, W], np.int32)
        jl, jpool = jmodel.verify_step(jparams, jnp.asarray(toks), _j(pool),
                                       jnp.asarray(lens),
                                       n_write=jnp.asarray(nw), **common)
        tl, _ = model.verify_step(params, torch.from_numpy(toks), tpool,
                                  torch.from_numpy(lens),
                                  n_write=torch.from_numpy(nw), **tcommon)
        rows = [(b, int(nw[b])) for b in range(B)]
    else:
        nw = np.asarray([W, 3, 1], np.int32)
        jl, jpool = jmodel.prefill(
            jparams, {"tokens": jnp.asarray(toks)}, cache=_j(pool),
            cache_len=jnp.asarray(lens), n_write=jnp.asarray(nw),
            last_idx=jnp.asarray(nw - 1), **common)
        tl, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              cache=tpool, cache_len=torch.from_numpy(lens),
                              n_write=torch.from_numpy(nw),
                              last_idx=torch.from_numpy(nw - 1), **tcommon)
        rows = [(b, 1) for b in range(B)]
    for b, c in rows:
        _close(tl[b, :c], np.asarray(jl)[b, :c])
    for key in ("k", "v"):
        _close(tpool[key][:, 1:], np.asarray(jpool[key])[:, 1:])


# ------------------------------------------------------------ weights
def test_params_from_numpy_carries_frontend_leaves(frontend):
    """The encoder subtree and every decoder layer's ``lnx`` / ``xattn``
    come across leaf for leaf, bit for bit, under the reference's
    names; the port's own init draws the same tree."""
    jmodel, jparams, model, params = frontend
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jparams)}

    def port_flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(port_flat(v, path) if isinstance(v, dict)
                       else {path: v})
        return out

    got = port_flat(params)
    assert set(got) == set(flat)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), flat[path])
    frontend_paths = {p for p in got if p.startswith("encoder/")
                      or "/xattn/" in p or p.endswith("/lnx")}
    assert bool(frontend_paths) == (model.cfg.frontend == "audio")
    own = port_flat(model.init(0))
    assert {p: tuple(t.shape) for p, t in own.items()} == \
        {p: tuple(t.shape) for p, t in got.items()}


def test_engine_refuses_frontends_with_the_reason():
    for name in FRONTENDS:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device="cpu")
        with pytest.raises(ValueError, match="tokens only"):
            ServingEngine(model, model.init(0), batch_size=1, max_seq=32,
                          device="cpu")
    paged = build_model(get_config("whisper-tiny").reduced(), device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        paged.init_paged_cache(4, 8)
