"""The port's plain selective scan against the JAX reference on the CPU.

The same numpy inputs (seeded; varied dt, A and D, a non-zero initial
state) go through the port's ``kernels.ssm_scan.ops.selective_scan``
(its plain version on CPU tensors) and through the reference's op in
interpret mode and its oracle ``ssm_scan_ref``. f32 throughout:
atol = rtol = 1e-5 (sum order differs between the two frameworks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as jax_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref
from repro_torch.kernels.ssm_scan import kernel
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, T, di, N, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, T, di))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)) - 1.0))
    Bm = rng.standard_normal((B, T, N))
    Cm = rng.standard_normal((B, T, N))
    A = -np.exp(rng.standard_normal((di, N)) * 0.5)
    D = 1.0 + 0.3 * rng.standard_normal(di)
    s0 = rng.standard_normal((B, di, N))
    return [a.astype(np.float32) for a in (u, dt, Bm, Cm, A, D, s0)]


def _port(args, **kw):
    return selective_scan(*[torch.from_numpy(a) for a in args], **kw)


@pytest.mark.parametrize("B,T,di,N", [
    (2, 1, 512, 16),    # one decode step at the reduced hymba width
    (2, 64, 64, 16),
    (1, 128, 512, 16),
    (1, 64, 32, 8),
])
def test_plain_scan_matches_jax(B, T, di, N):
    args = _inputs(B, T, di, N, seed=T + di)
    y, sT = _port(args)
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == (B, T, di) and sT.shape == (B, di, N)
    jargs = [jnp.asarray(a) for a in args]
    for jy, js in (jax_scan(*jargs), jax_scan_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(sT.numpy(), np.asarray(js), **TOL)


def test_plain_scan_state_carry_equals_whole():
    """Two halves with the state threaded through equal the whole."""
    u, dt, Bm, Cm, A, D, s0 = (torch.from_numpy(a)
                               for a in _inputs(1, 128, 64, 16, seed=3))
    yf, sf = selective_scan(u, dt, Bm, Cm, A, D, s0)
    h = 64
    y1, s1 = selective_scan(u[:, :h], dt[:, :h], Bm[:, :h], Cm[:, :h], A, D,
                            s0)
    y2, s2 = selective_scan(u[:, h:], dt[:, h:], Bm[:, h:], Cm[:, h:], A, D,
                            s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yf, **TOL)
    torch.testing.assert_close(s2, sf, **TOL)


def test_cpu_route_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 3, 40, 16, seed=2)]
    s0 = args[-1].clone()
    before = kernel.ssm_scan.launches
    y, sT = selective_scan(*args)
    ry, rs = ssm_scan_ref(*args)
    assert kernel.ssm_scan.launches == before
    assert torch.equal(y, ry) and torch.equal(sT, rs)
    assert torch.equal(args[-1], s0)
