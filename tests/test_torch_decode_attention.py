"""The port's decode attention and its sharded merge against the JAX
reference on the CPU.

The port's ops take the plain PyTorch version on CPU tensors; the JAX
side runs its Pallas kernel in interpret mode (as ``tests/test_kernels.py``
does) and its oracle ``decode_attention_ref``. Inputs are made with numpy
from a fixed seed and handed to both. Tolerances: f32 3e-5, bf16 3e-2,
out and lse (the reference's kernel-vs-oracle contract). A row with no
valid position follows the reference *kernel* (out 0, lse log(1e-30)),
not its oracle (NaN, -inf).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ops import (
    sharded_decode_attention as jax_sharded)
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro.kernels.decode_attention.ref import merge_partials as jax_merge
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, sharded_decode_attention)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      merge_partials)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 3e-5, "bf16": 3e-2}
EMPTY_LSE = math.log(1e-30)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, Hq, Hkv, T, hd, *, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32))


def _both(arrays, dt):
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.float32(ref),
                               atol=tol, rtol=tol)


# the reference's grid (tests/test_kernels.py) plus G = 5 (hymba's group)
GRID = [
    (2, 8, 2, 512, 64, 300, 0, "f32"),
    (1, 4, 1, 1024, 128, 1000, 256, "bf16"),
    (2, 4, 4, 512, 64, 512, 0, "f32"),
    (1, 8, 8, 256, 112, 100, 0, "f32"),
    (2, 10, 2, 256, 64, 77, 0, "f32"),
    (2, 10, 2, 256, 64, 200, 50, "bf16"),
]


@pytest.mark.parametrize("B,Hq,Hkv,T,hd,nv,win,dt", GRID)
def test_plain_decode_matches_jax(B, Hq, Hkv, T, hd, nv, win, dt):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, Hq, Hkv, T, hd, seed=T + nv), dt)
    out, lse = decode_attention(q, k, v, nv, sliding_window=win)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == (B, Hq)
    for ro, rl in (jax_decode(jq, jk, jv, nv, sliding_window=win),
                   jax_ref(jq, jk, jv, nv, sliding_window=win)):
        _close(out, ro, TOL[dt])
        _close(lse, rl, TOL[dt])


@pytest.mark.parametrize("win", [0, 40])
def test_per_row_n_valid_equals_one_call_per_row(win):
    """One length per row (as the model passes them) against the
    reference op called row by row with a scalar length."""
    nv = [1, 77, 256, 130, 64]
    (jq, jk, jv), (q, k, v) = _both(_qkv(5, 10, 2, 256, 64, seed=win), "f32")
    out, lse = decode_attention(q, k, v, torch.tensor(nv, dtype=torch.int32),
                                sliding_window=win)
    for b, n in enumerate(nv):
        ro, rl = jax_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], n,
                            sliding_window=win)
        _close(out[b:b + 1], ro, TOL["f32"])
        _close(lse[b:b + 1], rl, TOL["f32"])
    # a 0-d tensor applies to every row, as an int does
    o1, l1 = decode_attention(q, k, v, torch.tensor(77), sliding_window=win)
    o2, l2 = decode_attention(q, k, v, 77, sliding_window=win)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_empty_row_follows_the_reference_kernel():
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 256, 64, seed=9), "f32")
    out, lse = decode_attention(q, k, v, 0)
    ko, kl = jax_decode(jq, jk, jv, 0)
    assert torch.equal(out, torch.zeros_like(out))
    torch.testing.assert_close(lse, torch.full_like(lse, EMPTY_LSE))
    _close(out, ko, 0)
    _close(lse, kl, 1e-6)


@pytest.mark.parametrize("n_shards,nv", [(2, 400), (4, 300), (4, 512)])
def test_sharded_decode_matches_jax(n_shards, nv):
    """Sequence shards merged by LSE equal the unsharded op and the
    reference's sharded op; with n_valid 300 over 4 x 128 the last shard
    is empty and everything stays finite."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 512, 128, seed=nv), "f32")
    out = sharded_decode_attention(q, k.chunk(n_shards, 2),
                                   v.chunk(n_shards, 2), nv)
    assert torch.isfinite(out).all()
    whole, _ = decode_attention(q, k, v, nv)
    torch.testing.assert_close(out, whole, atol=3e-5, rtol=3e-5)
    ref = jax_sharded(jq, jnp.split(jk, n_shards, 2),
                      jnp.split(jv, n_shards, 2), nv)
    _close(out, ref, TOL["f32"])


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(2)
    outs = [rng.standard_normal((2, 4, 32), np.float32) for _ in range(3)]
    lses = [rng.standard_normal((2, 4), np.float32) * 3 for _ in range(3)]
    lses[1][0] = EMPTY_LSE                    # an empty shard's partial
    outs[1][0] = 0.0
    port = merge_partials([torch.from_numpy(a) for a in outs],
                          [torch.from_numpy(a) for a in lses])
    ref = jax_merge([jnp.asarray(a) for a in outs],
                    [jnp.asarray(a) for a in lses])
    _close(port, ref, 1e-6)


def test_cpu_route_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 4, 2, 40, 32, seed=1))
    n = torch.tensor([0, 13, 40], dtype=torch.int32)
    before = kernel.decode_attention.launches
    out, lse = decode_attention(q, k, v, n, sliding_window=8)
    assert kernel.decode_attention.launches == before
    ro, rl = decode_attention_ref(q, k, v, n, sliding_window=8)
    assert torch.equal(out, ro) and torch.equal(lse, rl)


# ------------------------------------------- the CUDA kernel's host plan
def test_plan_reads_no_lengths_and_sizes_the_served_shapes():
    """The plan takes shapes only. Over the serves' 1024-position
    stripes it cuts 16 splits of one 64-position tile: at qwen3-4b's
    decode (G 4, hd 128, bf16) one CTA of 4 heads a KV head and 37 KB of
    shared memory, at hymba-1.5b's (G 5, hd 64) one of 5 and 20 KB; at the
    serves' lengths 85 (hymba) and 160 (qwen3-4b) CTAs hold work."""
    assert list(inspect.signature(kernel.plan).parameters) == \
        ["B", "Hq", "Hkv", "T", "hd", "itemsize"]
    q = kernel.plan(8, 32, 8, 1024, 128, 2)
    assert q == kernel.Plan(64, 16, 4, 1, 6 * 4 * 128 + 2 * 2 * 64 * 136)
    h = kernel.plan(8, 25, 5, 1024, 64, 2)
    assert h == kernel.Plan(64, 16, 5, 1, 6 * 5 * 64 + 2 * 2 * 64 * 72)
    hymba = [316, 90, 80, 80, 21, 33, 49, 136]
    qwen = [316, 90, 80, 21, 33, 49, 136, 266]
    assert 5 * sum(len(kernel.visible_splits(h, n, 1024)) for n in hymba) \
        == 85
    assert 8 * sum(len(kernel.visible_splits(q, n, 1024)) for n in qwen) \
        == 160


@pytest.mark.parametrize("hd,itemsize", [(32, 4), (64, 2), (112, 4),
                                         (128, 2), (256, 2), (256, 4)])
def test_plan_splits_cover_the_stripe_once(hd, itemsize):
    """For every stripe length the splits are whole-tile ranges that
    cover [0, T) exactly once, in order, at most MAX_SPLITS of them, one
    tile each up to 2048 positions; the G query heads go to the fewest
    CTAs of at most MAX_WARPS heads, as evenly as they split; the shared
    memory fits at every group size."""
    for T in (*range(0, 300), 1023, 1024, 1025, 2048, 2049, 3000, 32768):
        for G in (1, 4, 5, 8, 9, 12, 17, 32):
            p = kernel.plan(2, 2 * G, 2, T, hd, itemsize)
            ranges = kernel.split_ranges(p, T)
            assert len(ranges) == p.n_splits <= kernel.MAX_SPLITS
            assert [j for r in ranges for j in r] == list(range(T))
            assert p.split_len % kernel.TILE == 0
            assert all(r.start == s * p.split_len
                       for s, r in enumerate(ranges))
            assert p.split_len == kernel.TILE or T > 2048
            assert p.smem == kernel.smem_bytes(p.heads, hd, itemsize)
            assert p.smem <= kernel.SMEM_LIMIT
            assert p.heads <= kernel.MAX_WARPS
            assert p.groups == -(-G // kernel.MAX_WARPS)
            assert p.heads * (p.groups - 1) < G <= p.heads * p.groups
            assert p.heads * p.groups - G < p.groups


@pytest.mark.parametrize("window", [0, 5, 40, 100])
def test_visible_splits_are_the_splits_a_row_reads(window):
    """The splits whose CTAs work for a row are exactly those that hold a
    position the row sees: together they cover its range, each meets
    it; a row that sees nothing has none."""
    for T in (64, 200, 3000):
        p = kernel.plan(1, 8, 2, T, 64, 2)
        ranges = kernel.split_ranges(p, T)
        for n in (*range(0, 260, 3), T - 1, T, T + 1, T + 70):
            lo = max(0, n - window) if window else 0
            seen = set(range(lo, min(n, T)))
            vis = kernel.visible_splits(p, n, T, window)
            assert {j for s in vis for j in ranges[s]} >= seen
            assert all(seen & set(ranges[s]) for s in vis)
            assert bool(vis) == bool(seen)


def _split_and_merge(q, k, v, lens, window, p):
    """The CUDA kernel's algorithm in plain f32 math: per visible split,
    each query head's softmax over the positions of the split it sees
    (out normalised, lse); a row seen by one split takes that split's
    result, a row seen by several merges them with ``merge_partials``
    (splits it does not see are never written: lse -inf here), a row
    that sees nothing gets out 0 and lse log(1e-30)."""
    B, Hq, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kk = k.float().repeat_interleave(G, dim=1)        # (B, Hq, T, hd)
    vv = v.float().repeat_interleave(G, dim=1)
    outs, lses = [], []
    for s, rng in enumerate(kernel.split_ranges(p, T)):
        o = torch.zeros((B, Hq, hd))
        lse = torch.full((B, Hq), float("-inf"))
        for b, n in enumerate(lens):
            if s not in kernel.visible_splits(p, n, T, window):
                continue
            lo = max(0, n - window) if window else 0
            pos = [j for j in rng if lo <= j < n]
            sc = torch.einsum("hd,hpd->hp", q[b].float(), kk[b][:, pos]) \
                / math.sqrt(hd)
            lse[b] = torch.logsumexp(sc, -1)
            o[b] = torch.einsum("hp,hpd->hd", torch.softmax(sc, -1),
                                vv[b][:, pos])
        outs.append(o)
        lses.append(lse)
    out = torch.zeros((B, Hq, hd))
    lse = torch.full((B, Hq), EMPTY_LSE)
    for b, n in enumerate(lens):
        vis = list(kernel.visible_splits(p, n, T, window))
        if len(vis) == 1:
            out[b], lse[b] = outs[vis[0]][b], lses[vis[0]][b]
        elif vis:
            out[b] = merge_partials([outs[s][b:b + 1] for s in vis],
                                    [lses[s][b:b + 1] for s in vis])[0]
            lse[b] = torch.logsumexp(torch.stack([lses[s][b] for s in vis]),
                                     0)
    return out, lse


# B x Hq x Hkv x T x hd x window x lengths x split length (None: the
# kernel's own plan): rows at split edges, an empty row, rows past T, a
# window ending inside a split, splits of several tiles
SPLIT_CASES = [
    (8, 8, 2, 256, 32, 0, [0, 1, 63, 64, 65, 127, 255, 256], None),
    (4, 10, 2, 200, 64, 40, [0, 50, 130, 201], None),
    (3, 4, 4, 256, 32, 0, [256, 17, 0], 96),
    (3, 8, 1, 512, 64, 100, [511, 260, 99], 192),
]


@pytest.mark.parametrize("B,Hq,Hkv,T,hd,win,lens,split", SPLIT_CASES)
def test_split_and_merge_matches_the_plain_versions(B, Hq, Hkv, T, hd, win,
                                                    lens, split):
    arrays = _qkv(B, Hq, Hkv, T, hd, seed=sum(lens) + T)
    (jq, jk, jv), (q, k, v) = _both(arrays, "f32")
    p = kernel.plan(B, Hq, Hkv, T, hd, 4)
    if split is not None:
        p = p._replace(split_len=split, n_splits=-(-T // split))
    assert len({len(kernel.visible_splits(p, n, T, win)) for n in lens}) > 1
    out, lse = _split_and_merge(q, k, v, lens, win, p)
    ro, rl = decode_attention_ref(q, k, v, torch.tensor(lens),
                                  sliding_window=win)
    _close(out, ro.numpy(), TOL["f32"])
    _close(lse, rl.numpy(), TOL["f32"])
    for b, n in enumerate(lens):
        jo, jl = jax_decode(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], n,
                            sliding_window=win)
        _close(out[b:b + 1], jo, TOL["f32"])
        _close(lse[b:b + 1], jl, TOL["f32"])
