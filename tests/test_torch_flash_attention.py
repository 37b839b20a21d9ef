"""The port's flash attention against the JAX reference on the CPU.

The port's ops take the plain PyTorch version on CPU tensors; the JAX
side runs its Pallas kernel in interpret mode (as ``tests/test_kernels.py``
does) on tile-aligned shapes, and its oracle ``flash_attention_ref`` on
ragged ones (the reference kernel asserts S % bq == 0 and T % bk == 0).
Inputs are made with numpy from a fixed seed and handed to both.
Tolerances: f32 3e-5, bf16 3e-2 (the reference's kernel-vs-oracle
contract, ``tests/test_kernels.py``). Against the model's own CPU
attention: 1e-5 in f32 (the same function, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention_bshd as jax_bshd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ops import (attention_bshd,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 3e-5, "bf16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tensors here are small: intra-op threads cost more than
    they save and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, Hq, Hkv, S, T, hd, *, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32),
            rng.standard_normal((B, Hkv, T, hd), np.float32))


def _both(arrays, dt):
    """(jax arrays, torch tensors) of the same numpy inputs, cast to
    ``dt`` on both sides (the same round-to-nearest)."""
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.float32(ref),
                               atol=tol, rtol=tol)


# B x Hq x Hkv x S x T x hd x window x dtype: G in {1, 2, 5}, q offset
# T - S > 0, hd 112, a sliding window, bf16
ALIGNED = [
    (2, 4, 4, 128, 128, 64, 0, "f32"),
    (1, 4, 2, 128, 256, 64, 0, "f32"),
    (1, 10, 2, 128, 128, 64, 0, "f32"),
    (1, 4, 2, 128, 128, 112, 0, "f32"),
    (2, 4, 2, 128, 256, 64, 48, "f32"),
    (1, 10, 2, 128, 128, 64, 0, "bf16"),
    (1, 4, 2, 128, 256, 112, 32, "bf16"),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,T,hd,win,dt", ALIGNED)
def test_plain_flash_matches_jax_kernel(B, Hq, Hkv, S, T, hd, win, dt):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, Hq, Hkv, S, T, hd, seed=S + T + hd),
                                    dt)
    out = flash_attention(q, k, v, sliding_window=win)
    assert out.dtype == q.dtype and out.shape == q.shape
    for ref in (jax_flash(jq, jk, jv, sliding_window=win),
                jax_ref(jq, jk, jv, sliding_window=win)):
        _close(out, ref, TOL[dt])
    forced = flash_attention(q, k, v, sliding_window=win, force_ref=True)
    assert torch.equal(forced, out)


# ragged S and T, one non-causal case
RAGGED = [
    (1, 10, 2, 37, 37, 64, 0, True),
    (2, 4, 2, 37, 100, 112, 0, True),
    (1, 4, 4, 5, 300, 64, 64, True),
    (1, 6, 3, 19, 70, 64, 0, False),
    (1, 6, 3, 19, 70, 32, 16, False),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,T,hd,win,causal", RAGGED)
def test_plain_flash_ragged_matches_jax_ref(B, Hq, Hkv, S, T, hd, win,
                                            causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, Hq, Hkv, S, T, hd, seed=S * T),
                                    "f32")
    out = flash_attention(q, k, v, causal=causal, sliding_window=win)
    _close(out, jax_ref(jq, jk, jv, causal=causal, sliding_window=win),
           TOL["f32"])


@pytest.mark.parametrize("win", [0, 40])
def test_attention_bshd_matches_jax(win):
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in
               _qkv(2, 10, 2, 128, 128, 64, seed=win + 1))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "f32")
    out = attention_bshd(tq, tk, tv, sliding_window=win)
    assert out.shape == tq.shape
    _close(out, jax_bshd(jq, jk, jv, sliding_window=win), TOL["f32"])


@pytest.mark.parametrize("S,T,Hq,Hkv,win", [
    (40, 40, 4, 4, 0), (40, 40, 10, 2, 0), (24, 40, 8, 2, 0),
    (40, 40, 10, 2, 16)])
def test_plain_flash_equals_model_causal_attention(S, T, Hq, Hkv, win):
    """The card route of ``causal_attention`` (flash on (B,S,H,hd) views)
    computes the function of its CPU route."""
    rng = np.random.default_rng(S + Hq + win)
    q = torch.from_numpy(rng.standard_normal((2, S, Hq, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, T, 2 * Hkv, 32),
                                             np.float32))
    k, v = k[:, :, :Hkv], k[:, :, Hkv:]        # slices, as the model's kv
    model = attention.causal_attention(q, k, v, sliding_window=win)
    flash = attention_bshd(q, k, v, sliding_window=win)
    torch.testing.assert_close(flash.reshape(model.shape), model, atol=1e-5,
                               rtol=1e-5)


def test_cpu_route_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 9, 20, 32, seed=4))
    before = kernel.flash_attention.launches
    out = flash_attention(q, k, v, sliding_window=5)
    assert kernel.flash_attention.launches == before
    assert torch.equal(out, flash_attention_ref(q, k, v, sliding_window=5))


def test_rows_aligned_selects_the_vector_path():
    """The kernels read 16-byte rows only where every row of q, k and v
    starts 16-byte aligned and fills whole loads."""
    x = torch.zeros((2, 4, 8, 64), dtype=torch.bfloat16)
    assert kernel.rows_aligned(x, x.transpose(1, 2), x[:, :2])
    assert not kernel.rows_aligned(x[..., 1:33])          # odd offset
    assert not kernel.rows_aligned(x[..., :20])           # 40-byte rows
    f = torch.zeros((2, 4, 8, 20))
    assert kernel.rows_aligned(f) and not kernel.rows_aligned(f[..., :18])
