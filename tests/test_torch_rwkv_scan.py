"""The port's plain WKV6 scan against the JAX reference on the CPU.

The same numpy inputs (seeded; non-zero bonus u, per-channel decays w in
(0.45, 0.95) or, in one case, in the model's own range, a non-zero
initial state) go through the port's
``kernels.rwkv_scan.ops.wkv`` (its plain version on CPU tensors) and
through the reference's op in interpret mode and its oracle ``wkv_ref``.
f32 throughout: atol = rtol = 1e-5 (sum order differs between the two
frameworks, nothing else). The CUDA kernel's launch plan, a function of
shapes only, is checked here too: it covers every state entry once.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ops import wkv as jax_wkv
from repro.kernels.rwkv_scan.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.rwkv_scan import kernel
from repro_torch.kernels.rwkv_scan.ops import wkv
from repro_torch.kernels.rwkv_scan.ref import wkv_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def model_decays(rng, shape):
    """Decays as the model makes them, w = exp(-exp(z)), each entry from
    one of three ranges at random: z in (4.7, 6), where w underflows to 0
    in f32; z in (-9.2, -5), w from 0.9933 (the ``decay_base = -5`` init)
    to 0.9999; and w in (0.45, 0.95)."""
    z = np.select([rng.random(shape) < 1 / 3, rng.random(shape) < 0.5],
                  [rng.uniform(4.7, 6.0, shape), rng.uniform(-9.2, -5.0,
                                                             shape)],
                  np.log(-np.log(rng.uniform(0.45, 0.95, shape))))
    return np.exp(-np.exp(z))


def _inputs(B, T, H, hd, seed, decays="mid"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd), np.float32)
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, hd)))))
    if decays == "model":
        w = model_decays(rng, (B, T, H, hd))
    u = 0.5 * rng.standard_normal((H, hd))
    s0 = rng.standard_normal((B, H, hd, hd))
    return [r, k, v, w.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32)]


def _port(args, **kw):
    return wkv(*[torch.from_numpy(a) for a in args], **kw)


@pytest.mark.parametrize("B,T,H,hd", [
    (2, 1, 2, 32),      # one decode step
    (2, 64, 2, 32),
    (1, 128, 2, 64),    # full-width head dim
    (3, 1, 4, 64),
])
def test_plain_wkv_matches_jax(B, T, H, hd):
    args = _inputs(B, T, H, hd, seed=T + hd)
    out, sT = _port(args)
    assert out.dtype == sT.dtype == torch.float32
    assert out.shape == (B, T, H, hd) and sT.shape == (B, H, hd, hd)
    jargs = [jnp.asarray(a) for a in args]
    for jo, js in (jax_wkv(*jargs, bt=64), jax_wkv_ref(*jargs)):
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(sT.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("T", [1, 64])
def test_plain_wkv_on_model_range_decays_matches_jax(T):
    """Decays that underflow to 0 and decays within 1e-4 of 1, beside
    mid-range ones: the plain version against the JAX op and oracle."""
    args = _inputs(2, T, 2, 64, seed=70 + T, decays="model")
    w = args[3]
    assert (w == 0).any() and (w > 0.9998).any() and (w > 0.99).mean() > 0.2
    out, sT = _port(args)
    jargs = [jnp.asarray(a) for a in args]
    for jo, js in (jax_wkv(*jargs, bt=64), jax_wkv_ref(*jargs)):
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(sT.numpy(), np.asarray(js), **TOL)


def test_plain_wkv_state_carry_equals_whole():
    """Two halves with the state threaded through equal the whole."""
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _inputs(1, 128, 2, 32, seed=5))
    o_full, s_full = wkv(r, k, v, w, u, s0)
    h = 64
    o1, s1 = wkv(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    o2, s2 = wkv(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, **TOL)
    torch.testing.assert_close(s2, s_full, **TOL)


def test_cpu_route_is_the_plain_version():
    """CPU tensors take the plain loop, never the kernel; the input
    state is left as it was."""
    args = [torch.from_numpy(a) for a in _inputs(1, 3, 2, 32, seed=1)]
    s0 = args[-1].clone()
    before = kernel.wkv_scan.launches
    out, sT = wkv(*args)
    ro, rs = wkv_ref(*args)
    assert kernel.wkv_scan.launches == before
    assert torch.equal(out, ro) and torch.equal(sT, rs)
    assert torch.equal(args[-1], s0)


# ------------------------------------------------------- the kernel's plan
PLAN_SHAPES = [(1, 3, 64), (2, 2, 48), (1, 1, 128), (2, 3, 30), (1, 2, 1),
               (3, 1, 32), (1, 1, 100), (1, 1, 33)]


@pytest.mark.parametrize("B,H,hd", PLAN_SHAPES)
def test_plan_covers_every_state_entry_once(B, H, hd):
    """Every (b, h, i, j) of the state is carried by exactly one thread of
    one CTA of the grid, at decode and at a long prefill."""
    want = sorted((b, h, i, j) for b in range(B) for h in range(H)
                  for i in range(hd) for j in range(hd))
    for T in (1, 300):
        p = kernel.plan(B, T, H, hd)
        gx, gy, gz = p.grid
        assert (gy, gz) == (H, B)
        got = sorted(e for x in range(gx) for y in range(gy)
                     for z in range(gz) for t in range(p.threads)
                     for e in kernel.owned(p, hd, (x, y, z), t))
        assert got == want


@pytest.mark.parametrize("hd", list(range(1, kernel.MAX_HEAD_DIM + 1)))
def test_plan_fits_the_card_and_pads_the_head_dim(hd):
    """Lanes x rows is hd padded to 32, 64 or 128 as the kernel pads it;
    a CTA stays within 1024 threads and 227 KB of shared memory; the
    chunk is one step (one stage) at T 1, else 16 (a ring of two)."""
    for T in (1, 2, 16, 17, 1000):
        p = kernel.plan(8, T, 32, hd)
        assert p.lanes * p.rows == kernel.padded_head_dim(hd) >= hd
        assert kernel.padded_head_dim(hd) in (32, 64, 128)
        assert p.lanes <= 32 and p.threads % p.lanes == 0
        assert p.columns * p.lanes == kernel.PAIR * p.threads
        assert p.threads <= 1024 and p.smem <= 227 * 1024
        assert (p.chunk, p.stages) == ((1, 1) if T == 1 else (16, 2))
        assert p.grid == (-(-hd // p.columns), 32, 8)


def test_plan_depends_on_shapes_only():
    """The plan takes the four sizes and nothing else, and equal sizes
    give equal plans; the plan depends on T only through T == 1."""
    assert list(inspect.signature(kernel.plan).parameters) == \
        ["B", "T", "H", "hd"]
    assert kernel.plan(8, 1, 32, 64) == kernel.plan(8, 1, 32, 64)
    assert kernel.plan(1, 2, 32, 64) == kernel.plan(1, 300, 32, 64)
    assert kernel.plan(1, 1, 32, 64) != kernel.plan(1, 2, 32, 64)
    for bad in (0, kernel.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="head dim"):
            kernel.plan(1, 1, 1, bad)
