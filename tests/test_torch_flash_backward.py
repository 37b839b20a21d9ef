"""The plain version of the flash-attention backward kernel on the CPU.

``flash_attention_bwd_ref`` (the explicit formulas the CUDA backward
computes: P from the saved log-sum-exp, D = rowsum(dO * O), dS = P *
(dP - D)) is held to torch autograd of ``flash_attention_ref`` and to
``jax.vjp`` of the reference's oracle
(``repro.kernels.flash_attention.ref.flash_attention_ref``) on the same
numpy inputs, f32, within 1e-5 of each gradient's largest magnitude:
causal, sliding-window and non-causal, G 1 / 2 / 4, S = T and S < T,
hd 64 and 112. The JAX oracle gives NaN on a row that sees no key, so
those comparisons keep T >= S; the zero-gradient contract on keyless
rows (S > T, causal) is tested on its own. The forward's log-sum-exp is
``torch.logsumexp`` of the masked scores. The CUDA kernel itself is held
to this plain version on the card (``chip_smoke.py`` phase 13a,
``tests/test_torch_cuda.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import backward
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

TOL = 1e-5                      # of each gradient's largest |g|
# (B, Hq, Hkv, S, T, hd, causal, sliding_window)
CASES = {
    "causal-g1": (2, 2, 2, 24, 24, 64, True, 0),
    "causal-g2-s<t": (1, 4, 2, 13, 37, 64, True, 0),
    "causal-g4-hd112": (1, 8, 2, 20, 20, 112, True, 0),
    "window-g2": (2, 4, 2, 30, 30, 64, True, 8),
    "window-g4-s<t-hd112": (1, 4, 1, 9, 26, 112, True, 5),
    "noncausal-g1": (2, 3, 3, 17, 17, 64, False, 0),
    "noncausal-g4-s<t": (1, 8, 2, 5, 40, 64, False, 0),
    "noncausal-window-g2": (1, 4, 2, 12, 21, 64, False, 6),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Hq, Hkv, S, T, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32),
            rng.standard_normal((B, Hq, S, hd), np.float32))


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1e-12), err


def _plain(q, k, v, do, causal, window):
    """flash_attention_bwd_ref from the plain forward's out and lse."""
    out, lse = flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=window, return_lse=True)
    return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   sliding_window=window)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_ref_matches_torch_autograd(name):
    B, Hq, Hkv, S, T, hd, causal, window = CASES[name]
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(B, Hq, Hkv, S, T, hd, seed=1))
    got = _plain(q, k, v, do, causal, window)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal, sliding_window=window)
    want = torch.autograd.grad(out, (qg, kg, vg), do)
    for g, w in zip(got, want):
        _close(g, w.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_ref_matches_jax_vjp(name):
    B, Hq, Hkv, S, T, hd, causal, window = CASES[name]
    arrays = _inputs(B, Hq, Hkv, S, T, hd, seed=2)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    got = _plain(q, k, v, do, causal, window)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal,
                                             sliding_window=window),
                     *(jnp.asarray(a) for a in arrays[:3]))
    want = vjp(jnp.asarray(arrays[3]))
    for g, w in zip(got, want):
        _close(g, w)


def test_forward_lse_is_the_masked_logsumexp():
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(1, 4, 2, 11, 19, 64, seed=3))
    out, lse = flash_attention_ref(q, k, v, sliding_window=7,
                                   return_lse=True)
    s = torch.einsum("bhsd,bhtd->bhst", q,
                     k.repeat_interleave(2, dim=1)) / math.sqrt(64)
    i = torch.arange(11)[:, None] + 8
    j = torch.arange(19)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - 7)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(out, flash_attention_ref(
        q, k, v, sliding_window=7), atol=0, rtol=0)


@pytest.mark.parametrize("window", [0, 3])
def test_keyless_rows_get_zero_gradient(window):
    """S > T, causal: rows 0 .. S - T - 1 see no key (lse -inf; the kernel
    writes 0 there). They get dq = 0 and add nothing to dk / dv: the
    other rows' gradient equals that of the live rows alone."""
    B, Hq, Hkv, S, T, hd = 1, 4, 2, 12, 7, 64
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(B, Hq, Hkv, S, T, hd, seed=4))
    out, lse = flash_attention_ref(q, k, v, sliding_window=window,
                                   return_lse=True)
    dead = S - T
    assert torch.isinf(lse[:, :, :dead]).all()
    assert torch.isfinite(lse[:, :, dead:]).all()
    out = torch.nan_to_num(out, nan=0.0)          # the kernel's zeros
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do,
                                         sliding_window=window)
    assert (dq[:, :, :dead] == 0).all()
    live = _plain(q[:, :, dead:], k, v, do[:, :, dead:], True, window)
    for g, w in zip((dq[:, :, dead:], dk, dv), live):
        _close(g, w.numpy())


def test_refuse_grad_raises_only_when_autograd_records():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward.*serve only"):
        refuse_grad("wkv_scan", torch.zeros(3), x)
    with torch.no_grad():
        refuse_grad("wkv_scan", x)
    refuse_grad("wkv_scan", x.detach(), torch.zeros(3))


# ------------------------------------------- the dK / dV launch's plan
# (B, Hq, Hkv, S, T, causal, window): causal at the qwen3-4b train shape
# and at nemotron-4-340b's attention (96 / 8 heads at 4096 tokens),
# non-causal at whisper's encoder and cross-attention, a sliding window,
# S < T, S > T (keyless rows), ragged S / T one under and one over the
# tiles, G 6
PLAN_CASES = {
    "train": (2, 32, 8, 1024, 1024, True, 0),
    "nemotron": (1, 96, 8, 4096, 4096, True, 0),
    "whisper-enc": (2, 6, 6, 1500, 1500, False, 0),
    "whisper-xattn": (2, 6, 6, 448, 1500, False, 0),
    "window": (1, 32, 8, 512, 512, True, 128),
    "s<t": (2, 32, 8, 64, 300, True, 0),
    "s>t": (1, 8, 2, 40, 20, True, 0),
    "ragged-window": (1, 25, 5, 37, 101, True, 24),
    "tile-edges": (1, 4, 2, 63, 65, True, 0),
    "tile-edges-over": (1, 4, 2, 97, 129, True, 0),
    "g6": (1, 12, 2, 320, 320, True, 0),
    "noncausal-window": (1, 4, 2, 33, 95, False, 7),
}
# the routes' plan constants: bf16 at HDP 128 (two CTAs an SM) and at
# HDP 192 / 256 (one, two warpgroups; 64-query items at 192), f32 at HDP
# 128 (64-key tiles) and at HDP 256 (32-key tiles)
ROUTES = {
    "bf16-hd128": backward.route(torch.bfloat16, 128),
    "bf16-hd192": backward.route(torch.bfloat16, 192),
    "bf16-hd256": backward.route(torch.bfloat16, 256),
    "f32-hd128": backward.route(torch.float32, 128),
    "f32-hd256": backward.route(torch.float32, 256),
}


def _visible_tiles(S, T, causal, window, key_tile, query_tile):
    """(key tile, query tile) pairs with a visible (query, key) pair, from
    each query's visible keys j (j <= i + T - S when causal, j > i + T - S
    - window with a window)."""
    seen = set()
    for i in range(S):
        pos = i + T - S
        lo = max(0, pos - window + 1) if window else 0
        hi = min(T - 1, pos) if causal else T - 1
        seen.update((kt, i // query_tile)
                    for kt in range(lo // key_tile, hi // key_tile + 1)
                    if lo <= hi)
    return seen


@pytest.mark.parametrize("dtype,hd,wgmma", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 112, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 192, True),
    (torch.bfloat16, 256, True), (torch.float32, 32, False),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.float32, 192, False), (torch.float32, 256, False)])
def test_wgmma_route_truth_table(dtype, hd, wgmma):
    """bf16 at every hd up to 256 takes the warpgroup-MMA kernels, f32
    never; the route's plan constants follow the kernels' geometry."""
    assert backward.wgmma_route(dtype, hd) is wgmma
    rt = backward.route(dtype, hd)
    assert rt.hdp == -(-hd // 64) * 64 and rt.hdp >= hd
    wide = rt.hdp > 128
    assert rt.key_tile == (32 if wide and not wgmma else 64)
    assert rt.query_tile == (64 if wgmma and rt.hdp == 192 else 32)
    assert rt.ctas_per_sm == (2 if rt.hdp <= (128 if wgmma else 64) else 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgmma_route_refuses_head_dims_past_256(dtype):
    with pytest.raises(ValueError, match="head dim"):
        backward.wgmma_route(dtype, 264)


@pytest.mark.parametrize("rt", list(ROUTES))
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_bwd_plan_covers_every_visible_pair_once(name, rt):
    B, Hq, Hkv, S, T, causal, window = PLAN_CASES[name]
    G = Hq // Hkv
    route = ROUTES[rt]
    p = backward.plan(B, Hq, Hkv, S, T, causal, window, rt=route)
    assert (p.key_tile, p.query_tile) == (route.key_tile, route.query_tile)
    got = list(backward.owned(p, S, T, G, causal, window))
    assert len(got) == len(set(got))
    want = {(kt, g, qt)
            for kt, qt in _visible_tiles(S, T, causal, window,
                                         route.key_tile, route.query_tile)
            for g in range(G)}
    assert set(got) == want
    # every key tile has a run (one that sees nothing writes zeros)
    assert {r[0] for r in p.entries} == set(range(-(-T // route.key_tile)))


@pytest.mark.parametrize("rt", list(ROUTES))
@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_bwd_plan_runs_are_balanced_and_largest_first(name, rt):
    """Runs hold at most ``chunk`` items, a tile's runs differ by at most
    one item, they launch longest first, and a split tile's runs have
    consecutive slots from its first slot."""
    B, Hq, Hkv, S, T, causal, window = PLAN_CASES[name]
    p = backward.plan(B, Hq, Hkv, S, T, causal, window, rt=ROUTES[rt])
    sizes = [i1 - i0 for _, i0, i1, *_ in p.entries]
    assert max(sizes) <= p.chunk and sizes == sorted(sizes, reverse=True)
    slots = set()
    for kt in {r[0] for r in p.entries}:
        runs = sorted((r for r in p.entries if r[0] == kt),
                      key=lambda r: r[4])
        n = runs[0][3]
        assert [r[4] for r in runs] == list(range(n))
        assert all(r[3] == n for r in runs)
        assert runs[0][1] == 0 and all(a[2] == b[1]
                                       for a, b in zip(runs, runs[1:]))
        lens = [r[2] - r[1] for r in runs]
        assert max(lens) - min(lens) <= 1
        if n > 1:
            mine = {r[5] + r[4] for r in runs}
            assert len({r[5] for r in runs}) == 1 and not mine & slots
            slots |= mine
    assert slots == set(range(p.n_slots))


def test_bwd_plan_splits_the_causal_train_shape():
    """At the qwen3-4b train shape the key tiles that see every query no
    longer set the launch's length: the longest run is at most a quarter
    of key tile 0's items (4 heads x 32 query tiles), and the runs number
    at least the CTAs 132 SMs hold at once."""
    rt = backward.BF16_128
    p = backward.plan(2, 32, 8, 1024, 1024, True, 0, sms=132)
    assert max(r[2] - r[1] for r in p.entries) <= 128 // 4
    assert len(p.entries) * 2 * 8 >= rt.ctas_per_sm * 132
    # whisper's encoder: every tile alike, split so the card fills
    p = backward.plan(2, 6, 6, 1500, 1500, False, 0, sms=132)
    assert len(p.entries) * 12 >= backward.WAVES * rt.ctas_per_sm * 132


@pytest.mark.parametrize("rt", list(ROUTES))
@pytest.mark.parametrize("name", ["train", "nemotron"])
def test_bwd_plan_splits_causal_key_tile_0(name, rt):
    """On every route, at the causal train shapes, key tile 0 (which every
    query sees) is split into runs of at most ``chunk`` items, fewer than
    it has: the tile that sees the most queries no longer sets the
    launch's length, and the runs fill every CTA slot of the card."""
    B, Hq, Hkv, S, T, causal, window = PLAN_CASES[name]
    route = ROUTES[rt]
    p = backward.plan(B, Hq, Hkv, S, T, causal, window, sms=132, rt=route)
    tile0 = [r for r in p.entries if r[0] == 0]
    items0 = sum(r[2] - r[1] for r in tile0)
    assert len(tile0) > 1 and tile0[0][3] == len(tile0)
    assert max(r[2] - r[1] for r in p.entries) <= p.chunk < items0
    assert len(p.entries) * B * Hkv >= route.ctas_per_sm * 132


def test_stream_scratch_is_cached_per_stream_and_grows():
    """The per-stream scratch the bf16 backward and the decode kernel take
    their partials and counters from: one allocation per (owner, device,
    stream), re-made larger (counters zeroed) when a call needs more."""
    from repro_torch.kernels import stream_scratch
    specs = ((10, torch.float32, False), (4, torch.int32, True))
    part, cnt = stream_scratch("test", "cpu", 1, specs)
    assert (part.numel(), cnt.numel()) == (10, 4) and not cnt.any()
    cnt[1] = 7
    assert stream_scratch("test", "cpu", 1, specs)[1] is cnt
    assert stream_scratch("test", "cpu", 2, specs)[1] is not cnt
    part2, cnt2 = stream_scratch("test", "cpu", 1, (
        (5, torch.float32, False), (9, torch.int32, True)))
    assert (part2.numel(), cnt2.numel()) == (10, 9) and not cnt2.any()
