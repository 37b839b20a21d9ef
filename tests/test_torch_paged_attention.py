"""The port's paged-window attention against the JAX reference on the CPU.

The port's ops take the plain PyTorch version on CPU tensors; the JAX
side runs its Pallas kernel in interpret mode (as ``tests/test_kernels.py``
does) and its independent gather oracle. Inputs are made with numpy
from a fixed seed and handed to both. Tolerances: f32 3e-5, bf16 3e-2
(the reference's kernel-vs-gather contract, ``tests/test_kernels.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import (
    paged_decode_attention as jax_decode, paged_window_attention as jax_window)
from repro.kernels.paged_attention.ref import gathered_window_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.decode_attention.ref import merge_partials
from repro_torch.kernels.paged_attention import kernel as pw_kernel
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_window_attention)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_ref, paged_window_attention_ref)
from repro_torch.models import attention

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 3e-5, "bf16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are tiny: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the reference's WINDOW_GRID (tests/test_kernels.py:297-308): q_len x
# active-slot count x heads x head_dim x block_size x window x dtype
WINDOW_GRID = [
    (1, 2, 8, 2, 64, 16, 4, 0, "f32"),    # degenerate decode shape
    (2, 3, 4, 4, 32, 8, 6, 0, "f32"),     # MHA, small blocks
    (2, 2, 8, 2, 64, 16, 4, 0, "f32"),    # GQA
    (4, 2, 8, 2, 64, 16, 4, 0, "f32"),
    (4, 3, 4, 1, 64, 8, 6, 0, "f32"),     # MQA
    (8, 2, 4, 2, 64, 16, 4, 0, "f32"),
    (8, 2, 4, 4, 32, 8, 8, 0, "f32"),
    (4, 2, 8, 2, 64, 16, 5, 24, "f32"),   # sliding window
    (4, 2, 8, 2, 64, 16, 4, 0, "bf16"),
    (8, 2, 4, 2, 32, 8, 8, 12, "bf16"),   # window + bf16
]


def _window_case(B, S, Hq, Hkv, hd, bs, max_blocks, *, seed=0):
    """numpy inputs: each row holds a ragged base length (incl. 0) and
    owns blocks covering base + S tokens; table tails stay at scratch."""
    rng = np.random.default_rng(seed + B * 1000 + S * 100 + hd)
    nb = B * max_blocks + 2
    q = rng.standard_normal((B, S, Hq, hd), np.float32)
    pk = rng.standard_normal((nb, bs, Hkv, hd), np.float32)
    pv = rng.standard_normal((nb, bs, Hkv, hd), np.float32)
    free = list(rng.permutation(np.arange(1, nb)))
    base = np.zeros(B, np.int32)
    table = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        base[b] = int(rng.integers(0, max_blocks * bs - S + 1))
        for i in range(-(-int(base[b] + S) // bs)):
            table[b, i] = free.pop()
    return q, pk, pv, table, base


def _both(arrays, dt):
    """(jax arrays, torch tensors) of the same numpy inputs; floating
    inputs cast to ``dt`` on both sides (the same round-to-nearest)."""
    jdt, tdt = DTYPES[dt]
    j, t = [], []
    for a in arrays:
        if a.dtype == np.float32:
            j.append(jnp.asarray(a, jdt))
            t.append(torch.from_numpy(a.copy()).to(tdt))
        else:
            j.append(jnp.asarray(a))
            t.append(torch.from_numpy(a.copy()))
    return j, t


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.float32(ref),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("S,B,Hq,Hkv,hd,bs,mb,win,dt", WINDOW_GRID)
def test_plain_window_matches_jax(S, B, Hq, Hkv, hd, bs, mb, win, dt):
    (jq, jk, jv, jt, jb), (q, pk, pv, table, base) = _both(
        _window_case(B, S, Hq, Hkv, hd, bs, mb), dt)
    out, lse = paged_window_attention(q, pk, pv, table, base,
                                      sliding_window=win)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    ko, kl = jax_window(jq, jk, jv, jt, jb, sliding_window=win)
    go, gl = gathered_window_ref(jq, jk, jv, jt, jb, sliding_window=win)
    for ref_o, ref_l in ((ko, kl), (go, gl)):
        _close(out, ref_o, TOL[dt])
        _close(lse, ref_l, TOL[dt])
    # force_ref is the same plain version on the CPU
    fo, fl = paged_window_attention(q, pk, pv, table, base,
                                    sliding_window=win, force_ref=True)
    assert torch.equal(fo, out) and torch.equal(fl, lse)


@pytest.mark.parametrize("B,Hq,Hkv,hd,bs,mb,win", [
    (2, 8, 2, 64, 16, 4, 0), (3, 4, 4, 32, 8, 6, 0), (4, 4, 1, 64, 16, 5, 24)])
def test_decode_wrapper_matches_jax(B, Hq, Hkv, hd, bs, mb, win):
    q, pk, pv, table, base = _window_case(B, 1, Hq, Hkv, hd, bs, mb, seed=5)
    lens = base + 1
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(
        (q[:, 0], pk, pv, table, lens), "f32")
    out, lse = paged_decode_attention(tq, tk, tv, tt, tl, sliding_window=win)
    ro, rl = paged_decode_attention_ref(tq, tk, tv, tt, tl,
                                        sliding_window=win)
    assert torch.equal(out, ro) and torch.equal(lse, rl)
    ko, kl = jax_decode(jq, jk, jv, jt, jl, sliding_window=win)
    _close(out, ko, 3e-5)
    _close(lse, kl, 3e-5)


def test_plain_window_ignores_scratch_garbage():
    """Unowned table tails point at scratch block 0: poisoning it changes
    no output bit of the plain version."""
    q, pk, pv, table, base = [torch.from_numpy(a) for a in
                              _window_case(3, 4, 8, 2, 64, 16, 4)]
    out, lse = paged_window_attention(q, pk, pv, table, base)
    pk[0], pv[0] = 1e9, -1e9
    out2, lse2 = paged_window_attention(q, pk, pv, table, base)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_verify_attention_matches_jax(use_kernel):
    """The serving entry point with the in-place write and the n_write
    scratch diversion: every owned pool block equals the reference's
    bitwise, and every position the engine can commit agrees."""
    B, S, Hq, Hkv, hd, bs, mb = 3, 4, 8, 2, 64, 8, 6
    q, pk, pv, table, base = _window_case(B, S, Hq, Hkv, hd, bs, mb, seed=3)
    rng = np.random.default_rng(11)
    k_new = rng.standard_normal((B, S, Hkv, hd), np.float32)
    v_new = rng.standard_normal((B, S, Hkv, hd), np.float32)
    n_write = np.asarray([S, 2, 0], np.int32)  # full / partial / parked
    args = (q, pk, pv, k_new, v_new, table, base, n_write)
    j, t = _both(args, "f32")
    jo, jpk, jpv = jax_attention.paged_verify_attention(*j, use_kernel=False)
    to, tpk, tpv = attention.paged_verify_attention(*t, use_kernel=use_kernel)
    assert tpk is t[1] and tpv is t[2]                  # written in place
    np.testing.assert_array_equal(tpk.numpy()[1:], np.asarray(jpk)[1:])
    np.testing.assert_array_equal(tpv.numpy()[1:], np.asarray(jpv)[1:])
    jo = np.asarray(jo).reshape(B, S, Hq, hd)
    to = to.numpy().reshape(B, S, Hq, hd)
    for b in range(B):
        c = int(n_write[b])
        np.testing.assert_allclose(to[b, :c], jo[b, :c], atol=3e-5,
                                   rtol=3e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_attention_matches_jax(use_kernel):
    B, Hq, Hkv, hd, bs, mb = 3, 8, 2, 64, 8, 4
    q, pk, pv, table, base = _window_case(B, 1, Hq, Hkv, hd, bs, mb, seed=7)
    rng = np.random.default_rng(7)
    k_new = rng.standard_normal((B, 1, Hkv, hd), np.float32)
    v_new = rng.standard_normal((B, 1, Hkv, hd), np.float32)
    j, t = _both((q, pk, pv, k_new, v_new, table, base), "f32")
    jo, jpk, jpv = jax_attention.paged_decode_attention(*j, use_kernel=False)
    to, tpk, tpv = attention.paged_decode_attention(*t, use_kernel=use_kernel)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    _close(to, jo, 3e-5)


# ------------------------------------------- the CUDA kernel's host plan
# block sizes of the card-only grid (tests/test_torch_cuda.py)
CARD_BLOCK_SIZES = (4, 8, 16, 64)


@pytest.mark.parametrize("bs", CARD_BLOCK_SIZES)
@pytest.mark.parametrize("S", [1, 4, 64])
def test_plan_splits_cover_the_table_once(bs, S):
    """For every table width 1..64 the splits are whole-block ranges that
    cover [0, max_blocks * bs) exactly once, in order; a split is whole
    staged tiles; a decode split holds 64 positions (one block at bs >=
    64); the shared memory fits."""
    for hd, itemsize in ((32, 4), (128, 2), (128, 4), (256, 2), (256, 4)):
        one_block = pw_kernel.smem_bytes(hd, itemsize, bs, 1 if S == 1 else 2,
                                         min(4 * S, pw_kernel.ROW_TILE))
        mma = itemsize == 2 and S >= 16
        if one_block > pw_kernel.SMEM_LIMIT and not mma:
            with pytest.raises(ValueError, match="shared memory"):
                pw_kernel.plan(S, 32, 8, hd, bs, 1, itemsize)
            continue
        for mb in range(1, 65):
            p = pw_kernel.plan(S, 32, 8, hd, bs, mb, itemsize)
            assert p.mma == mma
            ranges = pw_kernel.split_ranges(p, bs, mb)
            assert len(ranges) == p.n_splits
            assert [j for r in ranges for j in r] == list(range(mb * bs))
            assert all(r.start % bs == 0 and len(r) for r in ranges)
            assert p.split_blocks % p.tile_blocks == 0
            assert p.smem <= pw_kernel.SMEM_LIMIT
            rows = pw_kernel.MMA_ROWS if mma else pw_kernel.ROW_TILE
            assert p.row_tiles == -(-S * 4 // rows)
            if S == 1 and p.tile_blocks == max(1, 64 // bs):
                assert p.split_blocks * bs == max(bs, 64)


def test_plan_reads_no_lengths_and_sizes_the_qwen3_decode():
    """The plan is a function of shapes: at qwen3-4b's decode (bs 16, a
    1024-token table) 16 splits of 4 blocks; its bf16 chunk windows (S =
    64) one split over 4 tensor-core tiles of 64 packed rows (16 tiles of
    16 on CUDA cores in f32)."""
    p = pw_kernel.plan(1, 32, 8, 128, 16, 64, 2)
    assert (p.tile_blocks, p.split_blocks, p.n_splits, p.row_tiles) == \
        (4, 4, 16, 1)
    lens = [316, 90, 80, 21, 33, 49, 136, 266]
    working = sum(len(pw_kernel.visible_splits(p, 16, 64, n - 1, 0))
                  for n in lens)
    assert working * 8 == 160                         # CTAs with work
    c = pw_kernel.plan(64, 32, 8, 128, 16, 64, 2)
    assert c.mma and (c.n_splits, c.row_tiles) == (1, 4)
    assert pw_kernel.plan(64, 32, 8, 128, 16, 64, 4).row_tiles == 16
    with pytest.raises(ValueError, match="shared memory"):
        pw_kernel.plan(1, 8, 2, 256, 256, 4, 4)


@pytest.mark.parametrize("bs", CARD_BLOCK_SIZES)
@pytest.mark.parametrize("window", [0, 5, 40])
def test_visible_splits_are_the_splits_a_row_reads(bs, window):
    """The merge reads exactly the splits that hold a position the row
    sees: together they cover its range, and each one meets it."""
    mb = 12
    for S in (1, 4):
        p = pw_kernel.plan(S, 8, 2, 64, bs, mb, 2)
        p = p._replace(split_blocks=max(1, 16 // bs),
                       n_splits=-(-mb // max(1, 16 // bs)))
        ranges = pw_kernel.split_ranges(p, bs, mb)
        for base in range(0, mb * bs - S + 1, 3):
            for w in range(S):
                n = base + w + 1
                seen = set(range(max(n - window, 0) if window else 0, n))
                vis = pw_kernel.visible_splits(p, bs, mb, base, w, window)
                assert seen == {j for s in vis for j in ranges[s]} & seen
                assert all(seen & set(ranges[s]) for s in vis)


def _case_at(B, S, Hq, Hkv, hd, bs, mb, bases, *, seed):
    """numpy inputs at the given base lengths: each row owns distinct
    blocks covering base + S tokens; table tails stay at scratch 0."""
    rng = np.random.default_rng(seed)
    nb = B * mb + 2
    q = rng.standard_normal((B, S, Hq, hd), np.float32)
    pk = rng.standard_normal((nb, bs, Hkv, hd), np.float32)
    pv = rng.standard_normal((nb, bs, Hkv, hd), np.float32)
    free = list(rng.permutation(np.arange(1, nb)))
    table = np.zeros((B, mb), np.int32)
    for b, base in enumerate(bases):
        for i in range(-(-(base + S) // bs)):
            table[b, i] = free.pop()
    return q, pk, pv, table, np.asarray(bases, np.int32)


def _split_and_merge(q, pk, pv, table, base, window, p, bs):
    """The CUDA kernel's algorithm in plain f32 math: per split, each row's
    softmax over the positions of the split it sees (out normalised,
    lse); a split a row does not see is never written (lse -inf here);
    the partials merged with ``merge_partials``."""
    B, S, Hq, hd = q.shape
    Hkv, mb = pk.shape[2], table.shape[1]
    G = Hq // Hkv
    gk = pk[table.long()].reshape(B, mb * bs, Hkv, hd).float()
    gv = pv[table.long()].reshape(B, mb * bs, Hkv, hd).float()
    heads = torch.arange(Hq) // G
    outs, lses = [], []
    for s, rng in enumerate(pw_kernel.split_ranges(p, bs, mb)):
        o = torch.zeros((B, S, Hq, hd))
        lse = torch.full((B, S, Hq), float("-inf"))
        for b in range(B):
            for w in range(S):
                if s not in pw_kernel.visible_splits(p, bs, mb, int(base[b]),
                                                     w, window):
                    continue
                n = int(base[b]) + w + 1
                lo = max(n - window, 0) if window else 0
                pos = [j for j in rng if lo <= j < n]
                kk, vv = gk[b, pos][:, heads], gv[b, pos][:, heads]
                sc = torch.einsum("hd,phd->hp", q[b, w].float(), kk) \
                    / math.sqrt(hd)
                lse[b, w] = torch.logsumexp(sc, -1)
                o[b, w] = torch.einsum("hp,phd->hd", torch.softmax(sc, -1),
                                       vv)
        outs.append(o.reshape(B * S, Hq, hd))
        lses.append(lse.reshape(B * S, Hq))
    out = merge_partials(outs, lses).reshape(B, S, Hq, hd)
    return out, torch.logsumexp(torch.stack(lses), 0).reshape(B, S, Hq)


# B x S x Hq x Hkv x hd x bs x max_blocks x window x base lengths x split
# blocks (None: the kernel's own plan): rows whose later splits see
# nothing, base 0, split edges, sliding windows, finer splits at S > 1
SPLIT_CASES = [
    (4, 1, 8, 2, 64, 16, 8, 0, [0, 15, 63, 127], None),
    (4, 1, 8, 2, 32, 8, 24, 0, [0, 64, 65, 191], None),
    (3, 1, 4, 1, 64, 16, 12, 40, [10, 100, 191], None),
    (2, 1, 8, 2, 64, 64, 4, 0, [0, 200], None),
    (2, 4, 8, 2, 32, 8, 12, 0, [0, 50], 2),
    (3, 4, 4, 2, 32, 4, 24, 12, [0, 30, 91], 3),
    (2, 3, 8, 4, 64, 16, 6, 0, [1, 62], None),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,bs,mb,win,bases,sb", SPLIT_CASES)
def test_split_and_merge_matches_the_plain_versions(B, S, Hq, Hkv, hd, bs,
                                                    mb, win, bases, sb):
    arrays = _case_at(B, S, Hq, Hkv, hd, bs, mb, bases, seed=sum(bases) + S)
    (jq, jk, jv, jt, jb), (q, pk, pv, table, base) = _both(arrays, "f32")
    p = pw_kernel.plan(S, Hq, Hkv, hd, bs, mb, 4)
    if sb is not None:
        p = p._replace(split_blocks=sb, n_splits=-(-mb // sb))
    out, lse = _split_and_merge(q, pk, pv, table, base, win, p, bs)
    ro, rl = paged_window_attention_ref(q, pk, pv, table, base,
                                        sliding_window=win)
    go, gl = gathered_window_ref(jq, jk, jv, jt, jb, sliding_window=win)
    for ref_o, ref_l in ((ro.numpy(), rl.numpy()), (go, gl)):
        _close(out, ref_o, TOL["f32"])
        _close(lse, ref_l, TOL["f32"])
