"""The port's plain WKV6 scan against the JAX reference on the CPU.

The same numpy inputs (seeded; non-zero bonus u, per-channel decays w in
(0.45, 0.95), a non-zero initial state) go through the port's
``kernels.rwkv_scan.ops.wkv`` (its plain version on CPU tensors) and
through the reference's op in interpret mode and its oracle ``wkv_ref``.
f32 throughout: atol = rtol = 1e-5 (sum order differs between the two
frameworks, nothing else).
"""
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


def _inputs(B, T, H, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd), np.float32)
               for _ in range(3))
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, hd)))))
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
