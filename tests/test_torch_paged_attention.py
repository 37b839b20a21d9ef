"""The port's paged-window attention against the JAX reference on the CPU.

The port's ops take the plain PyTorch version on CPU tensors; the JAX
side runs its Pallas kernel in interpret mode (as ``tests/test_kernels.py``
does) and its independent gather oracle. Inputs are made with numpy
from a fixed seed and handed to both. Tolerances: f32 3e-5, bf16 3e-2
(the reference's kernel-vs-gather contract, ``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import (
    paged_decode_attention as jax_decode, paged_window_attention as jax_window)
from repro.kernels.paged_attention.ref import gathered_window_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_window_attention)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_ref)
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
