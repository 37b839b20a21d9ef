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
