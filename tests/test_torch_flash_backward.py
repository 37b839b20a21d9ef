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
    with pytest.raises(RuntimeError, match="no backward.*item 3b"):
        refuse_grad("wkv_scan", torch.zeros(3), x)
    with torch.no_grad():
        refuse_grad("wkv_scan", x)
    refuse_grad("wkv_scan", x.detach(), torch.zeros(3))
