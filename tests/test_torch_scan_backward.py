"""The plain versions of the WKV6 and selective-scan backward kernels on
the CPU, and the scan ops' autograd route there.

``wkv_bwd_ref`` and ``ssm_scan_bwd_ref`` (the explicit reverse-time
formulas the CUDA backwards compute, states recomputed by a forward
pass) are held to ``jax.vjp`` of the reference's oracles
(``repro.kernels.rwkv_scan.ref.wkv_ref``,
``repro.kernels.ssm_scan.ref.ssm_scan_ref``) and to torch autograd of
the port's own plain forwards, on the same numpy inputs with non-zero
cotangents on both outputs (the scan's output and its final state) and
a random initial state, f32, each gradient within 3e-5 of its largest
magnitude (the port's f32 contract: sum order differs, nothing else).
Cases: T 1, T 17 (across the kernels' 16-step chunk edge) and T 40; WKV
at hd 8 and 32 with H 3, decays in (0.45, 0.95) and in the model's own
range, exact zeros included; the selective scan at N 1 and 16 with
d_inner 40 (a ragged channel tail on the card) and A in hymba's range
[-16, -1] with steps whose exp(dt A) underflows to 0. B 0 and T 0 give
zero gradients and dstate = dstate_out. The ops on CPU tensors that
require grad take the plain loop, which autograd differentiates, and
launch nothing. The plain versions of the checkpoints the training
forwards write for the backward kernels (every 8 steps) hold the
reference's states after those prefixes, and the backward kernels'
launch geometry (clusters of CTAs that add cross-CTA sums on chip)
covers every shape they take. The kernels themselves are checked on the card
(``chip_smoke.py`` phase 13a, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.ref import wkv_ref as jax_wkv_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro_torch.kernels.rwkv_scan import backward as wkv_backward
from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv_scan.ops import wkv
from repro_torch.kernels.rwkv_scan.ref import (wkv_bwd_ref,
                                               wkv_checkpoints_ref, wkv_ref)
from repro_torch.kernels.ssm_scan import backward as ssm_backward
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                              ssm_scan_checkpoints_ref,
                                              ssm_scan_ref)

TOL = 3e-5                      # of each gradient's largest |g|
# (B, T, H, hd, decays)
WKV_CASES = {
    "t1-hd8": (2, 1, 3, 8, "mid"),
    "t17-hd32-model": (2, 17, 3, 32, "model"),
    "t17-hd8": (1, 17, 3, 8, "mid"),
    "t40-hd8-model": (2, 40, 3, 8, "model"),
    "t40-hd32": (1, 40, 3, 32, "mid"),
}
# (B, T, di, N)
SSM_CASES = {
    "t1-n1": (2, 1, 40, 1),
    "t1-n16": (2, 1, 40, 16),
    "t17-n16": (2, 17, 40, 16),
    "t17-n1": (1, 17, 40, 1),
    "t40-n16": (2, 40, 40, 16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_decays(rng, shape):
    """w = exp(-exp(z)) as the model makes it, from three ranges: z in
    (4.7, 6) (w underflows to 0 in f32), z in (-9.2, -5) (0.9933 to
    0.9999) and w in (0.45, 0.95); then one entry in 7 set to exactly
    0."""
    pick = rng.integers(0, 3, shape)
    z = np.where(pick == 0, rng.uniform(4.7, 6.0, shape),
                 rng.uniform(-9.2, -5.0, shape))
    w = np.where(pick == 2, rng.uniform(0.45, 0.95, shape),
                 np.exp(-np.exp(z)))
    return np.where(rng.random(shape) < 1 / 7, 0.0, w)


def _wkv_inputs(B, T, H, hd, decays, seed):
    """r, k, v, w, u, state, dout, dstate_out as f32 numpy arrays: k and
    the state scaled by 1/sqrt(hd)."""
    rng = np.random.default_rng(seed)
    r, k, v, dout = (rng.standard_normal((B, T, H, hd)) for _ in range(4))
    w = (model_decays(rng, (B, T, H, hd)) if decays == "model"
         else rng.uniform(0.45, 0.95, (B, T, H, hd)))
    u = 0.5 * rng.standard_normal((H, hd))
    s0, ds = (rng.standard_normal((B, H, hd, hd)) for _ in range(2))
    return [x.astype(np.float32) for x in
            (r, k / np.sqrt(hd), v, w, u, s0 / np.sqrt(hd), dout, ds)]


def _ssm_inputs(B, T, di, N, seed):
    """u, dt, Bm, Cm, A, D, state, dy, dstate_out as f32 numpy arrays:
    A in [-16, -1] (hymba's), its last column -16, dt = softplus(z - 1)
    with one step in 8 at 8 (there exp(dt A) underflows to 0), C scaled
    by 1/sqrt(N)."""
    rng = np.random.default_rng(seed)
    u, dy = (rng.standard_normal((B, T, di)) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)) - 1.0))
    dt = np.where(rng.random((B, T, di)) < 1 / 8, 8.0, dt)
    Bm, Cm = (rng.standard_normal((B, T, N)) for _ in range(2))
    A = -rng.uniform(1.0, 16.0, (di, N))
    A[:, -1] = -16.0
    D = 1.0 + 0.3 * rng.standard_normal(di)
    s0, ds = (rng.standard_normal((B, di, N)) for _ in range(2))
    return [x.astype(np.float32) for x in
            (u, dt, Bm, Cm / np.sqrt(N), A, D, s0, dy, ds)]


def _assert_grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= TOL * scale, f"d{name} off by {err} (largest {scale})"


def _torch(xs):
    return [torch.from_numpy(x) for x in xs]


def _autograd(fn, xs, cot):
    """torch autograd of fn at xs for the cotangents cot."""
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = fn(*leaves)
    return torch.autograd.grad(outs, leaves, cot)


WKV_NAMES = ("r", "k", "v", "w", "u", "state")
SSM_NAMES = ("u", "dt", "Bm", "Cm", "A", "D", "state")


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_bwd_ref_matches_jax_vjp(case):
    *shape, decays = WKV_CASES[case]
    xs = _wkv_inputs(*shape, decays, seed=len(case))
    _, vjp = jax.vjp(jax_wkv_ref, *map(jnp.asarray, xs[:6]))
    want = vjp((jnp.asarray(xs[6]), jnp.asarray(xs[7])))
    got = wkv_bwd_ref(*_torch(xs))
    _assert_grads_close(got, want, WKV_NAMES)
    if decays == "model":
        assert (xs[3] == 0).any()


@pytest.mark.parametrize("case", list(WKV_CASES))
def test_wkv_bwd_ref_matches_autograd_of_plain(case):
    *shape, decays = WKV_CASES[case]
    xs = _torch(_wkv_inputs(*shape, decays, seed=len(case) + 1))
    want = _autograd(wkv_ref, xs[:6], xs[6:])
    _assert_grads_close(wkv_bwd_ref(*xs), want, WKV_NAMES)


@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_bwd_ref_matches_jax_vjp(case):
    xs = _ssm_inputs(*SSM_CASES[case], seed=len(case))
    _, vjp = jax.vjp(jax_ssm_ref, *map(jnp.asarray, xs[:7]))
    want = vjp((jnp.asarray(xs[7]), jnp.asarray(xs[8])))
    got = ssm_scan_bwd_ref(*_torch(xs))
    _assert_grads_close(got, want, SSM_NAMES)
    a = np.exp(xs[1][..., None] * xs[4])
    assert (a == 0).any()


@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_bwd_ref_matches_autograd_of_plain(case):
    xs = _torch(_ssm_inputs(*SSM_CASES[case], seed=len(case) + 1))
    want = _autograd(ssm_scan_ref, xs[:7], xs[7:])
    _assert_grads_close(ssm_scan_bwd_ref(*xs), want, SSM_NAMES)


@pytest.mark.parametrize("op,B,T", [("wkv", 0, 5), ("wkv", 2, 0),
                                    ("ssm", 0, 5), ("ssm", 2, 0)])
def test_bwd_refs_on_empty_inputs(op, B, T):
    """No step, or no row: every gradient 0, dstate = dstate_out."""
    if op == "wkv":
        xs = _torch(_wkv_inputs(B, T, 3, 8, "mid", seed=3))
        got = wkv_bwd_ref(*xs)
    else:
        xs = _torch(_ssm_inputs(B, T, 40, 16, seed=3))
        got = ssm_scan_bwd_ref(*xs)
    n = len(got) - 1
    for g, x in zip(got[:n], xs[:n]):
        assert g.shape == x.shape and not g.any()
    assert torch.equal(got[-1], xs[-1])


@pytest.mark.parametrize("op", ["wkv", "ssm"])
def test_ops_on_cpu_take_the_plain_route(op):
    """On CPU tensors that require grad the op is the plain loop, which
    autograd differentiates: the same gradients, bit for bit, as
    autograd of the plain version, and no kernel launch."""
    if op == "wkv":
        xs = _torch(_wkv_inputs(2, 17, 3, 8, "model", seed=5))
        fns, n_in, plain = (wkv, wkv_ref), 6, wkv_ref
        counters = (wkv_kernel.wkv_scan, wkv_backward.wkv_bwd)
    else:
        xs = _torch(_ssm_inputs(2, 17, 40, 16, seed=5))
        fns, n_in, plain = (selective_scan, ssm_scan_ref), 7, ssm_scan_ref
        counters = (ssm_kernel.ssm_scan, ssm_backward.ssm_scan_bwd)
    before = [f.launches for f in counters]
    got = _autograd(fns[0], xs[:n_in], xs[n_in:])
    want = _autograd(plain, xs[:n_in], xs[n_in:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [f.launches for f in counters] == before


# ---------------------------------------- the training forward's checkpoints
@pytest.mark.parametrize("T", [1, 7, 8, 9, 17, 40])
def test_wkv_checkpoints_ref_matches_jax_prefix_states(T):
    """``wkv_checkpoints_ref`` (the plain version of what the training
    forward writes for the backward kernel) holds, transposed, the
    reference's final state after each 8-step prefix short of the last
    step, with exact-zero decays at every chunk start: within 3e-5 of the
    largest state entry; none up to one chunk."""
    xs = _wkv_inputs(2, T, 3, 8, "model", seed=T)
    xs[3][:, ::8] = 0.0
    got = wkv_checkpoints_ref(*_torch(xs[:4]), _torch(xs[5:6])[0])
    n = wkv_kernel.checkpoint_count(T)
    assert got.shape == (2, 3, n, 8, 8)
    for c in range(n):
        t = 8 * (c + 1)
        _, want = jax_wkv_ref(*(jnp.asarray(x[:, :t]) for x in xs[:4]),
                              jnp.asarray(xs[4]), jnp.asarray(xs[5]))
        want = np.swapaxes(np.asarray(want), -1, -2)
        scale = float(np.abs(want).max())
        assert float(np.abs(got[:, :, c].numpy() - want).max()) \
            <= TOL * scale


@pytest.mark.parametrize("T", [1, 7, 8, 9, 17, 40])
def test_ssm_checkpoints_ref_matches_jax_prefix_states(T):
    """``ssm_scan_checkpoints_ref`` holds the reference's final state after
    each 8-step prefix short of the last step, with dt 8 (exp(dt A) = 0)
    at every chunk start: within 3e-5 of the largest state entry; none up
    to one chunk."""
    xs = _ssm_inputs(2, T, 40, 16, seed=T)
    xs[1][:, ::8] = 8.0
    u, dt, Bm, Cm, A, D, s0 = _torch(xs[:7])
    got = ssm_scan_checkpoints_ref(u, dt, Bm, A, s0)
    n = ssm_kernel.checkpoint_count(T)
    assert got.shape == (2, n, 40, 16)
    for c in range(n):
        t = 8 * (c + 1)
        _, want = jax_ssm_ref(*(jnp.asarray(x[:, :t]) for x in xs[:4]),
                              *(jnp.asarray(x) for x in xs[4:7]))
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got[:, c].numpy() - want).max()) <= TOL * scale


@pytest.mark.parametrize("T", [0, 1, 8, 9, 15, 16, 17, 32, 33, 1024])
def test_checkpoint_counts(T):
    """The training forwards write one state per 8-step backward chunk
    after the first, ceil(T / 8) - 1 (none at T up to 8)."""
    for kernel in (wkv_kernel, ssm_kernel):
        assert kernel.checkpoint_count(T) == max(-(-T // 8) - 1, 0)


@pytest.mark.parametrize("hd", [1, 8, 16, 17, 32, 40, 63, 64, 65, 100, 128])
def test_wkv_backward_geometry_covers_the_head(hd):
    """The WKV backward's CTAs cover every row of a head once, as one
    cluster of at most 8 (1 / 2 / 2 / 8 at hd 32 / 40 / 64 / 128): two rows
    and 4 columns a lane, 32 rows a CTA up to hd 64, 16 above; a head dim
    past 128 is refused."""
    g = wkv_backward.geometry(hd)
    rows, cols = (32, 4) if hd <= 64 else (16, 4)
    hdp = next(p for p in (32, 64, 128) if hd <= p)
    assert g.rows == rows and g.threads * 2 * cols == g.rows * hdp
    assert g.cluster == -(-hd // g.rows)
    assert (g.cluster - 1) * g.rows < hd <= g.cluster * g.rows
    assert g.cluster <= wkv_backward.MAX_CLUSTER
    assert {32: 1, 40: 2, 64: 2, 128: 8}.get(hd, g.cluster) == g.cluster
    with pytest.raises(ValueError):
        wkv_backward.geometry(129)


@pytest.mark.parametrize("N", [1, 2, 3, 5, 16, 17, 33, 64])
@pytest.mark.parametrize("di", [1, 40, 130, 520, 3200, 3204])
def test_ssm_backward_geometry_covers_the_channels(di, N):
    """The selective-scan backward lays a channel's N entries over the
    forward's lanes (two a lane, one at N 1), 128 threads a CTA, and
    clusters of at most 8 consecutive channel blocks: the grid covers
    every channel, pads less than one cluster, and a cluster holds 8
    blocks unless the row has fewer."""
    g = ssm_backward.geometry(di, N)
    per, lanes = (1 if N == 1 else 2), 1
    while lanes * per < N:
        lanes *= 2
    assert g.lanes == lanes
    assert g.lanes * g.channels == ssm_backward.THREADS
    blocks = -(-di // g.channels)
    assert g.cluster == min(blocks, ssm_backward.MAX_CLUSTER)
    assert g.clusters * g.cluster >= blocks > (g.clusters - 1) * g.cluster
    with pytest.raises(ValueError):
        ssm_backward.geometry(di, 65)
