"""Card-only tests of the port's CUDA kernels (marker ``cuda``; they skip
where no CUDA device is present). Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
inputs, with TF32 off. Paged-window, flash and decode attention: f32
atol = rtol = 1e-4 (the sum order differs), bf16 3e-2 (the reference
grid's bf16 tolerance). WKV and selective scans (f32 only): 1e-5 for one
step, 1e-4 over long scans, where the carried state accumulates
rounding; the WKV cases with decays in the model's range (down to 0 and
up to 0.9999) scale k by 1/sqrt(hd), so a state that forgets little
stays of order 1.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, sharded_decode_attention)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import (attention_bshd,
                                                     flash_attention)
from repro_torch.kernels.paged_attention import kernel as pw_kernel
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_window_attention)
from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv_scan.ops import wkv
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(B, S, Hq, Hkv, hd, bs, max_blocks, dtype, *, seed=0):
    """Random q / pool at ragged base lengths (incl. 0 and block
    boundaries); each row owns distinct blocks covering base + S tokens,
    table tails point at scratch block 0."""
    g = torch.Generator().manual_seed(seed)
    nb = B * max_blocks + 1
    q = torch.randn((B, S, Hq, hd), generator=g)
    pk = torch.randn((nb, bs, Hkv, hd), generator=g)
    pv = torch.randn((nb, bs, Hkv, hd), generator=g)
    T = max_blocks * bs
    edges = [0, bs - 1, bs, 2 * bs + 3, T - S]
    free = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    base = torch.zeros(B, dtype=torch.int32)
    table = torch.zeros((B, max_blocks), dtype=torch.int32)
    for b in range(B):
        base[b] = edges[b] if b < len(edges) else \
            int(torch.randint(0, T - S + 1, (), generator=g))
        for i in range(-(-(int(base[b]) + S) // bs)):
            table[b, i] = free.pop()
    return [t.to("cuda", dtype) for t in (q, pk, pv)] + \
        [table.cuda(), base.cuda()]


# S x heads x head_dim x block_size x window x dtype
GRID = [
    (1, 32, 8, 128, 16, 0, torch.float32),    # qwen3-4b decode
    (4, 32, 8, 128, 16, 0, torch.float32),
    (64, 32, 8, 128, 16, 0, torch.float32),   # one chunk window
    (1, 32, 8, 128, 16, 0, torch.bfloat16),
    (64, 32, 8, 128, 16, 0, torch.bfloat16),
    (4, 32, 8, 128, 16, 24, torch.bfloat16),  # sliding window
    (3, 4, 4, 32, 8, 0, torch.float32),       # MHA, small blocks
    (2, 8, 1, 64, 4, 12, torch.float32),      # MQA + window
    (5, 8, 2, 256, 16, 0, torch.bfloat16),    # wide heads
    (2, 4, 2, 64, 64, 0, torch.float32),      # blocks wider than a warp
]


@pytest.mark.parametrize("S,Hq,Hkv,hd,bs,win,dt", GRID)
def test_kernel_matches_plain_version(cuda, S, Hq, Hkv, hd, bs, win, dt):
    max_blocks = -(-512 // bs)
    args = _case(8, S, Hq, Hkv, hd, bs, max_blocks, dt, seed=S * 7 + hd)
    before = pw_kernel.paged_window_attention.launches
    out, lse = paged_window_attention(*args, sliding_window=win)
    assert pw_kernel.paged_window_attention.launches == before + 1
    ro, rl = paged_window_attention(*args, sliding_window=win,
                                    force_ref=True)
    torch.cuda.synchronize()
    assert out.dtype == dt and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])


def _case_at(bases, S, Hq, Hkv, hd, bs, max_blocks, dtype, *, seed):
    """As ``_case``, at the given base lengths."""
    g = torch.Generator().manual_seed(seed)
    B = len(bases)
    nb = B * max_blocks + 1
    q = torch.randn((B, S, Hq, hd), generator=g)
    pk = torch.randn((nb, bs, Hkv, hd), generator=g)
    pv = torch.randn((nb, bs, Hkv, hd), generator=g)
    free = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    table = torch.zeros((B, max_blocks), dtype=torch.int32)
    for b, base in enumerate(bases):
        for i in range(-(-(base + S) // bs)):
            table[b, i] = free.pop()
    return [t.to("cuda", dtype) for t in (q, pk, pv)] + \
        [table.cuda(), torch.tensor(bases, dtype=torch.int32, device="cuda")]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 4, 64])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_kernel_at_split_edges(cuda, bs, S, dt):
    """Rows whose last window query sees 1, 63, 64, 65, 128 and all T
    positions (the edges of 64-position splits), one launch per call,
    and poisoning scratch block 0 changes no output bit."""
    max_blocks = 512 // bs
    T = max_blocks * bs
    bases = [max(0, n - S) for n in (1, 63, 64, 65, 128, T)]
    args = _case_at(bases, S, 32, 8, 128, bs, max_blocks, dt,
                    seed=bs + S)
    before = pw_kernel.paged_window_attention.launches
    out, lse = paged_window_attention(*args)
    assert pw_kernel.paged_window_attention.launches == before + 1
    ro, rl = paged_window_attention(*args, force_ref=True)
    q, pk, pv, table, base = args
    pk[0], pv[0] = 1e9, -1e9
    out2, lse2 = paged_window_attention(q, pk, pv, table, base)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_decode_wrapper_is_window_at_s1(cuda):
    q, pk, pv, table, base = _case(8, 1, 32, 8, 128, 16, 32, torch.float32)
    od, ld = paged_decode_attention(q[:, 0], pk, pv, table, base + 1)
    ow, lw = paged_window_attention(q, pk, pv, table, base)
    torch.cuda.synchronize()
    assert torch.equal(od, ow[:, 0]) and torch.equal(ld, lw[:, 0])


def test_kernel_ignores_scratch_poison(cuda):
    q, pk, pv, table, base = _case(8, 4, 32, 8, 128, 16, 32, torch.float32)
    out, lse = paged_window_attention(q, pk, pv, table, base)
    pk[0], pv[0] = 1e9, -1e9
    out2, lse2 = paged_window_attention(q, pk, pv, table, base)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_kernel_rejects_what_it_cannot_run(cuda):
    q, pk, pv, table, base = _case(2, 2, 8, 2, 64, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        pw_kernel.paged_window_attention(q.transpose(0, 1), pk, pv, table,
                                         base)
    with pytest.raises(ValueError, match="dtype"):
        pw_kernel.paged_window_attention(q, pk.bfloat16(), pv.bfloat16(),
                                         table, base)
    with pytest.raises(ValueError, match="int32"):
        pw_kernel.paged_window_attention(q, pk, pv, table.long(), base)
    with pytest.raises(ValueError, match="head dim"):
        pw_kernel.paged_window_attention(q[..., :44].contiguous(),
                                         pk[..., :44].contiguous(),
                                         pv[..., :44].contiguous(), table,
                                         base)


# head dims of the configs off the power-of-two grid (kimi-k2 112,
# nemotron-4-340b 192), on the CUDA-core route (f32; bf16 below S 16) and
# the tensor-core route (bf16, S 64), at the grid's ragged bases
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 5, 64])
@pytest.mark.parametrize("bs", [8, 16, 64])
@pytest.mark.parametrize("hd", [112, 192, 48])
def test_kernel_at_config_head_dims(cuda, hd, bs, S, dt):
    max_blocks = -(-512 // bs)
    Hq = 64 if hd == 112 else 96
    args = _case(8, S, Hq, 8, hd, bs, max_blocks, dt, seed=hd + S + bs)
    args[1][0], args[2][0] = 1e9, -1e9          # scratch block 0
    before = pw_kernel.paged_window_attention.launches
    out, lse = paged_window_attention(*args)
    assert pw_kernel.paged_window_attention.launches == before + 1
    ro, rl = paged_window_attention(*args, force_ref=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_kernel_at_the_verify_shape(cuda, dt):
    """A speculative verify window at qwen3-4b's width: B 8, S = k + 1 =
    5, Hq 32, Hkv 8 (R = 20 packed rows: two CUDA-core row tiles)."""
    args = _case(8, 5, 32, 8, 128, 16, 64, dt, seed=55)
    out, lse = paged_window_attention(*args)
    ro, rl = paged_window_attention(*args, force_ref=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])


def test_engine_kernel_vs_gather_on_card(cuda):
    """Reduced GQA qwen3-4b on the card: the kernel engine emits the
    gather engine's greedy streams, launching once per layer per step."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              n_kv_heads=2)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 23, 90)]
    streams = {}
    for use_kernel in (True, False):
        before = pw_kernel.paged_window_attention.launches
        eng = ServingEngine(model, params, batch_size=4, max_seq=128,
                            block_size=16, prefill_chunk=16,
                            use_kernel=use_kernel)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == 4
        launched = pw_kernel.paged_window_attention.launches - before
        expect = cfg.n_layers * eng.metrics["decode_steps"]
        assert launched == (expect if use_kernel else 0)
        assert eng.metrics["chunk_steps"] > 0
        streams[use_kernel] = reqs
    for a, b in zip(streams[True], streams[False]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ scan kernels
def _scan_tol(T):
    return 1e-5 if T == 1 else 1e-4


def _model_decays(shape, g):
    """w = exp(-exp(z)) as the model makes it, each entry from one of
    three ranges: z in (4.7, 6) (w underflows to 0 in f32), z in (-9.2,
    -5) (w from 0.9933, the ``decay_base = -5`` init, to 0.9999), and w
    in (0.45, 0.95)."""
    pick = torch.randint(0, 3, shape, generator=g)
    z = torch.where(pick == 0, 4.7 + 1.3 * torch.rand(shape, generator=g),
                    -9.2 + 4.2 * torch.rand(shape, generator=g))
    mid = 0.45 + 0.5 * torch.rand(shape, generator=g)
    return torch.where(pick == 2, mid, torch.exp(-torch.exp(z)))


def _wkv_case(B, T, H, hd, seed, decays="mid"):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, hd), generator=g) for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(torch.randn((B, T, H, hd), generator=g))
    if decays == "model":
        w = _model_decays((B, T, H, hd), g)
        k = k / math.sqrt(hd)   # a near-1 decay sums ~T steps of k v
    u = 0.5 * torch.randn((H, hd), generator=g)
    s0 = torch.randn((B, H, hd, hd), generator=g)
    return [t.cuda() for t in (r, k, v, w, u, s0)]


def _ssm_case(B, T, di, N, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((B, T, di), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, T, di), generator=g)
                                      - 1.0)
    Bm, Cm = (torch.randn((B, T, N), generator=g) for _ in range(2))
    A = -torch.exp(0.5 * torch.randn((di, N), generator=g))
    D = 1.0 + 0.3 * torch.randn(di, generator=g)
    s0 = torch.randn((B, di, N), generator=g)
    return [t.cuda() for t in (u, dt, Bm, Cm, A, D, s0)]


@pytest.mark.parametrize("B,T,H,hd", [
    (8, 1, 32, 64),       # rwkv6-1.6b decode
    (1, 300, 32, 64),     # one full-width prefill
    (2, 17, 4, 32),       # reduced, ragged T
    (2, 5, 3, 48),        # head dim below its 64-thread template
    (1, 9, 2, 128),
])
def test_wkv_kernel_matches_plain_version(cuda, B, T, H, hd):
    args = _wkv_case(B, T, H, hd, seed=T + hd)
    before = wkv_kernel.wkv_scan.launches
    out, sT = wkv(*args)
    assert wkv_kernel.wkv_scan.launches == before + 1
    ro, rs = wkv(*args, force_ref=True)
    torch.cuda.synchronize()
    tol = _scan_tol(T)
    torch.testing.assert_close(out, ro, atol=tol, rtol=tol)
    torch.testing.assert_close(sT, rs, atol=tol, rtol=tol)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("hd", [32, 48, 64, 128])
@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 31, 32, 33, 300, 1000])
def test_wkv_kernel_at_chunk_edges(cuda, T, hd, B):
    """T 1 (the one-step instantiation), T on both sides of the 16-step
    chunk edges of the two-chunk ring (15-17, 31-33), long scans that
    wrap the ring many times, every padded head dim (32, 64, 128, and 48
    padded to 64), decays in the model's range (0, 0.9933-0.9999,
    0.45-0.95)."""
    args = _wkv_case(B, T, 3, hd, seed=T + hd + B, decays="model")
    before = wkv_kernel.wkv_scan.launches
    out, sT = wkv(*args)
    assert wkv_kernel.wkv_scan.launches == before + 1
    ro, rs = wkv(*args, force_ref=True)
    torch.cuda.synchronize()
    tol = _scan_tol(T)
    torch.testing.assert_close(out, ro, atol=tol, rtol=tol)
    torch.testing.assert_close(sT, rs, atol=tol, rtol=tol)


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, device=t.device, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("hd,T", [(30, 40), (50, 7), (64, 33)])
def test_wkv_kernel_element_staging(cuda, hd, T):
    """The 4-byte staging path: a head dim that is no multiple of 4, and
    hd 64 with r and the state starting off a 16-byte boundary."""
    r, k, v, w, u, s0 = _wkv_case(2, T, 2, hd, seed=hd, decays="model")
    if hd % 4 == 0:
        r, s0 = _misaligned(r), _misaligned(s0)
        assert r.data_ptr() % 16 and s0.data_ptr() % 16
    out, sT = wkv(r, k, v, w, u, s0)
    ro, rs = wkv(r, k, v, w, u, s0, force_ref=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ro, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sT, rs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hd,T", [(64, 1), (64, 40), (30, 40), (128, 17)])
def test_wkv_state_out_aliases_state(cuda, hd, T):
    """The C entry point (serving: no checkpoints) with the final state
    written over the initial one in place (``state_out`` is ``state``):
    one launch, the plain version's result."""
    *args, s0 = _wkv_case(2, T, 3, hd, seed=hd + T, decays="model")
    ro, rs = wkv(*args, s0, force_ref=True)
    state = s0.clone()
    out = torch.empty_like(args[0])
    B, T, H, hd = out.shape
    p = wkv_kernel.plan(B, T, H, hd)
    vec = wkv_kernel.rows_aligned(*args[:4], state, out)
    stream = torch.cuda.current_stream().cuda_stream
    err = wkv_kernel._launcher()(*(t.data_ptr() for t in args),
                                 state.data_ptr(), out.data_ptr(),
                                 state.data_ptr(), None, B, T, H, hd,
                                 p.lanes, p.chunk, int(vec), stream)
    assert err == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ro, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, rs, atol=1e-4, rtol=1e-4)


def test_wkv_kernel_back_to_back_shapes(cuda):
    """Calls at other shapes (other plans: lanes, chunk, stages, grid)
    queued back to back with no synchronisation between them, each
    against the plain version afterwards."""
    shapes = [(8, 1, 32, 64), (1, 300, 32, 64), (2, 64, 32, 64),
              (8, 1, 4, 128), (1, 17, 5, 32), (3, 16, 2, 48),
              (8, 1, 32, 64)]
    cases = [_wkv_case(*s, seed=i, decays="model")
             for i, s in enumerate(shapes)]
    before = wkv_kernel.wkv_scan.launches
    results = [wkv(*a) for a in cases]
    assert wkv_kernel.wkv_scan.launches == before + len(shapes)
    for shape, a, (out, sT) in zip(shapes, cases, results):
        ro, rs = wkv(*a, force_ref=True)
        tol = _scan_tol(shape[1])
        torch.testing.assert_close(out, ro, atol=tol, rtol=tol)
        torch.testing.assert_close(sT, rs, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,di,N", [
    (8, 1, 3200, 16),     # hymba-1.5b decode
    (1, 300, 3200, 16),   # one full-width prefill
    (2, 33, 512, 16),     # reduced
    (2, 7, 200, 5),       # ragged channel tile, small state
    (1, 40, 130, 64),
])
def test_ssm_kernel_matches_plain_version(cuda, B, T, di, N):
    args = _ssm_case(B, T, di, N, seed=T + di)
    before = ssm_kernel.ssm_scan.launches
    y, sT = selective_scan(*args)
    assert ssm_kernel.ssm_scan.launches == before + 1
    ry, rs = selective_scan(*args, force_ref=True)
    torch.cuda.synchronize()
    tol = _scan_tol(T)
    torch.testing.assert_close(y, ry, atol=tol, rtol=tol)
    torch.testing.assert_close(sT, rs, atol=tol, rtol=tol)


@pytest.mark.parametrize("di", [3200, 333])
@pytest.mark.parametrize("T", [1, 2, 31, 300, 1000])
@pytest.mark.parametrize("N", [1, 5, 16, 17, 33, 64])
def test_ssm_kernel_over_state_sizes(cuda, N, T, di):
    """Every lane-group width (N 1 / 5 / 16 / 17 / 33 / 64: 1 to 32 lanes
    per channel, two entries a lane past 32), chunks of the staged steps
    (T 1 to 1000), hymba's width and a ragged channel tail."""
    args = _ssm_case(2, T, di, N, seed=N + T + di)
    before = ssm_kernel.ssm_scan.launches
    y, sT = selective_scan(*args)
    assert ssm_kernel.ssm_scan.launches == before + 1
    ry, rs = selective_scan(*args, force_ref=True)
    torch.cuda.synchronize()
    tol = _scan_tol(T)
    torch.testing.assert_close(y, ry, atol=tol, rtol=tol)
    torch.testing.assert_close(sT, rs, atol=tol, rtol=tol)


@pytest.mark.parametrize("N", [16, 33])
def test_ssm_state_out_aliases_state(cuda, N):
    """The C entry point (serving: no checkpoints) with the final state
    written over the initial one in place (``state_out`` is ``state``):
    one launch, the plain version's result."""
    *args, s0 = _ssm_case(2, 40, 333, N, seed=N)
    ry, rs = selective_scan(*args, s0, force_ref=True)
    state = s0.clone()
    y = torch.empty_like(args[0])
    B, T, di = y.shape
    stream = torch.cuda.current_stream().cuda_stream
    err = ssm_kernel._launcher()(*(t.data_ptr() for t in args),
                                 state.data_ptr(), y.data_ptr(),
                                 state.data_ptr(), None, B, T, di, N,
                                 stream)
    assert err == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, rs, atol=1e-4, rtol=1e-4)


def test_scan_kernels_carry_state(cuda):
    """Two halves with the state threaded through equal the whole."""
    r, k, v, w, u, s0 = _wkv_case(1, 256, 4, 64, seed=1)
    of, sf = wkv(r, k, v, w, u, s0)
    o1, s1 = wkv(*(t[:, :100].contiguous() for t in (r, k, v, w)), u, s0)
    o2, s2 = wkv(*(t[:, 100:].contiguous() for t in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), of, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(s2, sf, atol=1e-4, rtol=1e-4)
    u_, dt, Bm, Cm, A, D, h0 = _ssm_case(1, 256, 512, 16, seed=2)
    yf, hf = selective_scan(u_, dt, Bm, Cm, A, D, h0)
    y1, h1 = selective_scan(*(t[:, :100].contiguous()
                              for t in (u_, dt, Bm, Cm)), A, D, h0)
    y2, h2 = selective_scan(*(t[:, 100:].contiguous()
                              for t in (u_, dt, Bm, Cm)), A, D, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yf, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(h2, hf, atol=1e-4, rtol=1e-4)


def test_scan_kernels_reject_what_they_cannot_run(cuda):
    r, k, v, w, u, s0 = _wkv_case(1, 4, 2, 32, seed=3)
    with pytest.raises(ValueError, match="float32"):
        wkv_kernel.wkv_scan(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv_scan(r.transpose(1, 2), k, v, w, u, s0)
    big = torch.zeros((1, 2, 1, 160), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        wkv_kernel.wkv_scan(big, big, big, big, torch.zeros((1, 160),
                                                            device="cuda"),
                            torch.zeros((1, 1, 160, 160), device="cuda"))
    u_, dt, Bm, Cm, A, D, h0 = _ssm_case(1, 4, 64, 16, seed=4)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_kernel.ssm_scan(u_, dt, Bm.transpose(1, 2).contiguous()
                            .transpose(1, 2), Cm, A, D, h0)
    wide = torch.zeros((1, 4, 65), device="cuda")
    with pytest.raises(ValueError, match="state size"):
        ssm_kernel.ssm_scan(u_, dt, wide, wide,
                            torch.zeros((64, 65), device="cuda"), D,
                            torch.zeros((1, 64, 65), device="cuda"))


@pytest.mark.parametrize("name,kw", [("rwkv6-1.6b", {}),
                                     ("hymba-1.5b", {"n_kv_heads": 2})])
def test_recurrent_engine_on_card(cuda, name, kw):
    """Reduced recurrent models on the card: every prefill call and
    decode step launches the scan kernel once per layer, and the streams
    equal the CPU engine's (plain scans) on the same weights."""
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    fn = wkv_kernel.wkv_scan if name.startswith("rwkv") \
        else ssm_kernel.ssm_scan
    params = build_model(cfg, device="cuda").init(0)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 7, 70, 12)]
    streams = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        p = params if device == "cuda" else _to(params, "cpu")
        before = fn.launches
        eng = ServingEngine(model, p, batch_size=3, max_seq=96,
                            device=device)
        reqs = [Request(rid=i, prompt=list(q), max_new_tokens=6)
                for i, q in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == len(prompts)
        m = eng.metrics
        expect = cfg.n_layers * (m["prefill_batches"] + m["decode_steps"])
        assert fn.launches - before == (expect if device == "cuda" else 0)
        streams[device] = reqs
    for a, b in zip(streams["cuda"], streams["cpu"]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------- flash / decode kernels
def _close(out, ref, dt):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                               rtol=TOL[dt])


# B x Hq x Hkv x hd x S x T x window x causal: the two served head shapes
# (qwen3-4b, hymba-1.5b), a q offset, ragged S, a window, G = 1, wide and
# odd head dims
FLASH_GRID = [
    (1, 32, 8, 128, 300, 300, 0, True),
    (2, 32, 8, 128, 64, 364, 0, True),
    (2, 25, 5, 64, 37, 37, 0, True),
    (1, 25, 5, 64, 300, 300, 128, True),
    (2, 4, 4, 112, 70, 90, 0, True),
    (1, 8, 2, 192, 65, 65, 0, True),
    (1, 4, 1, 256, 33, 50, 24, True),
    (2, 6, 3, 32, 20, 45, 0, False),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,hd,S,T,win,causal", FLASH_GRID)
def test_flash_kernel_matches_plain_version(cuda, dt, B, Hq, Hkv, hd, S, T,
                                            win, causal):
    g = torch.Generator().manual_seed(S + T + hd)
    q = torch.randn((B, Hq, S, hd), generator=g).to("cuda", dt)
    k, v = (torch.randn((B, Hkv, T, hd), generator=g).to("cuda", dt)
            for _ in range(2))
    before = flash_kernel.flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, sliding_window=win)
    assert flash_kernel.flash_attention.launches == before + 1
    ref = flash_attention(q, k, v, causal=causal, sliding_window=win,
                          force_ref=True)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    _close(out, ref, dt)


# (S, T) pairs from {1, 15, 16, 17, 63, 64, 65, 300}: ragged tile edges
# on both axes, q offsets T - S > 0, S = T
FLASH_ST = [(1, 1), (1, 300), (15, 16), (16, 17), (17, 63), (63, 64),
            (64, 65), (65, 300), (16, 16), (300, 300)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("hd", [64, 112, 128, 192, 256])
def test_flash_kernel_over_head_dims_and_groups(cuda, hd, G, dt):
    """Every served head dim (zero-padded to the tensor-core tile in
    bf16) and group size, over ragged S and T, causal and with a sliding
    window."""
    Hkv = 2
    for i, (S, T) in enumerate(FLASH_ST):
        g = torch.Generator().manual_seed(hd * 10 + G + i)
        q = torch.randn((1, G * Hkv, S, hd), generator=g).to("cuda", dt)
        k, v = (torch.randn((1, Hkv, T, hd), generator=g).to("cuda", dt)
                for _ in range(2))
        for win in (0, 24):
            out = flash_attention(q, k, v, sliding_window=win)
            ref = flash_attention(q, k, v, sliding_window=win,
                                  force_ref=True)
            torch.cuda.synchronize()
            _close(out, ref, dt)


# dtype x Hq x Hkv x hd x window: hymba's heads with a window in f32,
# qwen3-4b's and kimi-k2's head dims at G = 4 in bf16 (tensor cores)
VIEW_CASES = [(torch.float32, 25, 5, 64, 20),
              (torch.bfloat16, 32, 8, 112, 0),
              (torch.bfloat16, 32, 8, 128, 20)]


@pytest.mark.parametrize("dt,Hq,Hkv,hd,win", VIEW_CASES)
def test_flash_reads_model_views_in_place(cuda, dt, Hq, Hkv, hd, win):
    """(B,S,H,hd) q and k / v sliced out of one projection, as the model
    passes them: the strided route equals the contiguous one bitwise."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 50, Hq, hd), generator=g).to("cuda", dt)
    kv = torch.randn((2, 50, 2, Hkv, hd), generator=g).to("cuda", dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = attention_bshd(q, k, v, sliding_window=win)
    dense = attention_bshd(q, k.contiguous(), v.contiguous(),
                           sliding_window=win)
    ref = attention_bshd(q, k, v, sliding_window=win, force_ref=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    assert torch.equal(out, dense)
    _close(out, ref, dt)


def _stripe(B, T, Hkv, hd, dt, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, T, Hkv, hd), generator=g).to("cuda", dt)
            for _ in range(2)]


# B x Hq x Hkv x hd x T x window
DECODE_GRID = [
    (8, 32, 8, 128, 1024, 0),
    (8, 25, 5, 64, 1024, 0),
    (8, 25, 5, 64, 1024, 100),
    (3, 8, 8, 112, 300, 0),
    (2, 8, 1, 256, 200, 37),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,hd,T,win", DECODE_GRID)
def test_decode_kernel_matches_plain_version(cuda, dt, B, Hq, Hkv, hd, T,
                                             win):
    """Ragged per-row lengths incl. 1, T and one past T (a stripe at
    capacity); the stripe (B,T,Hkv,hd) read through strides equals the
    contiguous (B,Hkv,T,hd) layout bitwise."""
    g = torch.Generator().manual_seed(T + hd + win)
    q = torch.randn((B, Hq, hd), generator=g).to("cuda", dt)
    k_st, v_st = _stripe(B, T, Hkv, hd, dt, seed=T + win)
    lens = [1, T, T + 1, 64, 65, 300 % T + 1, 17, 129][:B]
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)
    before = decode_kernel.decode_attention.launches
    out, lse = decode_attention(q, k, v, n, sliding_window=win)
    assert decode_kernel.decode_attention.launches == before + 1
    ro, rl = decode_attention(q, k, v, n, sliding_window=win, force_ref=True)
    co, cl = decode_attention(q, k.contiguous(), v.contiguous(), n,
                              sliding_window=win)
    torch.cuda.synchronize()
    assert out.dtype == dt and lse.dtype == torch.float32
    _close(out, ro, dt)
    _close(lse, rl, dt)
    assert torch.equal(out, co) and torch.equal(lse, cl)


def _decode_vs_plain(q, k_st, v_st, lens, win, dt, *, poison=True):
    """One kernel call on the stripe (B,T,Hkv,hd) read in place, with NaN
    past each row's length when ``poison``, against the plain version on
    the clean stripe, out and lse; the contiguous (B,Hkv,T,hd) layout
    gives the same bits. Counts one launch."""
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ro, rl = decode_attention(q, k_st.transpose(1, 2), v_st.transpose(1, 2),
                              n, sliding_window=win, force_ref=True)
    if poison:
        T = k_st.shape[1]
        tail = torch.arange(T, device="cuda")[None] >= n[:, None]
        k_st, v_st = k_st.clone(), v_st.clone()
        k_st[tail], v_st[tail] = float("nan"), float("nan")
    k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)
    before = decode_kernel.decode_attention.launches
    out, lse = decode_attention(q, k, v, n, sliding_window=win)
    assert decode_kernel.decode_attention.launches == before + 1
    co, cl = decode_attention(q, k.contiguous(), v.contiguous(), n,
                              sliding_window=win)
    torch.cuda.synchronize()
    _close(out, ro, dt)
    _close(lse, rl, dt)
    assert torch.equal(out, co) and torch.equal(lse, cl)
    return out, lse


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 5, 8, 12, 32])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_kernel_at_split_edges(cuda, hd, G, dt):
    """Rows whose lengths sit on the edges of the 64-position splits (0,
    1, 63, 64, 65, 127, T - 1, T), the stripe tail past each length
    poisoned with NaN; G 12 and 32 take two and four CTAs a KV head."""
    T = 1024
    g = torch.Generator().manual_seed(hd + G)
    q = torch.randn((8, 2 * G, hd), generator=g).to("cuda", dt)
    k_st, v_st = _stripe(8, T, 2, hd, dt, seed=hd * G)
    _decode_vs_plain(q, k_st, v_st, [0, 1, 63, 64, 65, 127, T - 1, T], 0,
                     dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("win", [33, 70])
def test_decode_window_ends_inside_a_split(cuda, win, dt):
    """Sliding windows whose first position falls inside a split, so
    the first visible split is partly masked; rows of one and of several
    splits, a row longer than the stripe."""
    g = torch.Generator().manual_seed(win)
    q = torch.randn((8, 25, 64), generator=g).to("cuda", dt)
    k_st, v_st = _stripe(8, 1024, 5, 64, dt, seed=win)
    _decode_vs_plain(q, k_st, v_st, [100, 130, 200, 1024, 700, 65, 1100, 10],
                     win, dt)


# hd x G x dtype x window: splits of two 64-position tiles (T > 2048),
# staged one tile at a time
LONG_CASES = [(64, 5, torch.bfloat16, 0), (128, 4, torch.float32, 0),
              (128, 4, torch.bfloat16, 500), (256, 8, torch.float32, 0)]


@pytest.mark.parametrize("hd,G,dt,win", LONG_CASES)
def test_decode_kernel_over_long_stripes(cuda, hd, G, dt, win):
    T = 3000
    p = decode_kernel.plan(4, 2 * G, 2, T, hd, torch.finfo(dt).bits // 8)
    assert p.split_len == 128
    g = torch.Generator().manual_seed(hd + win)
    q = torch.randn((4, 2 * G, hd), generator=g).to("cuda", dt)
    k_st, v_st = _stripe(4, T, 2, hd, dt, seed=G)
    _decode_vs_plain(q, k_st, v_st, [T, 129, 2100, 1], win, dt)


def test_decode_merge_counters_reset(cuda):
    """Back-to-back calls with other lengths (and a smaller batch between
    them, sharing the cached scratch) each equal the plain version: the
    last split of every row left its merge counter at 0."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((8, 32, 128), generator=g).to("cuda", torch.bfloat16)
    k_st, v_st = _stripe(8, 1024, 8, 128, torch.bfloat16, seed=9)
    for lens in ([316, 90, 80, 21, 33, 49, 136, 266],
                 [1024, 1000, 640, 65, 64, 300, 2, 900],
                 [317, 91, 81, 22, 34, 50, 137, 267]):
        _decode_vs_plain(q, k_st, v_st, lens, 0, torch.bfloat16,
                         poison=False)
        _decode_vs_plain(q[:2], k_st[:2], v_st[:2], lens[::-1][:2], 0,
                         torch.bfloat16, poison=False)


def test_decode_scalar_and_empty_rows(cuda):
    q = torch.randn((4, 8, 64), device="cuda")
    k, v = (t.transpose(1, 2) for t in _stripe(4, 96, 2, 64, torch.float32,
                                               seed=3))
    o1, l1 = decode_attention(q, k, v, 50)
    o2, l2 = decode_attention(q, k, v, torch.full((4,), 50, dtype=torch.int32,
                                                  device="cuda"))
    o0, l0 = decode_attention(q, k, v, 0)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert torch.equal(o0, torch.zeros_like(o0))
    torch.testing.assert_close(l0, torch.full_like(l0, math.log(1e-30)))


def test_sharded_decode_on_card(cuda):
    """4 shards of a 1024 stripe, the last one empty, merge to the
    unsharded kernel's output."""
    q = torch.randn((8, 25, 64), device="cuda")
    k, v = (t.transpose(1, 2) for t in _stripe(8, 1024, 5, 64, torch.float32,
                                               seed=4))
    before = decode_kernel.decode_attention.launches
    out = sharded_decode_attention(q, k.chunk(4, 2), v.chunk(4, 2), 700)
    assert decode_kernel.decode_attention.launches == before + 4
    whole, _ = decode_attention(q, k, v, 700)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, whole, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_unaligned_rows(cuda, dt):
    """Rows that do not start 16-byte aligned take the element-wise
    staging path: the same function as the plain version."""
    g = torch.Generator().manual_seed(7)
    qb = torch.randn((2, 4, 40, 65), generator=g).to("cuda", dt)
    kvb = torch.randn((2, 2, 50, 65), generator=g).to("cuda", dt)
    q, k, v = qb[..., 1:], kvb[..., 1:], kvb[..., :64]
    assert not flash_kernel.rows_aligned(q, k, v)
    out = flash_attention(q, k, v, sliding_window=9)
    ref = flash_attention(q, k, v, sliding_window=9, force_ref=True)
    n = torch.tensor([17, 50], dtype=torch.int32, device="cuda")
    od, ld = decode_attention(q[:, :, 0], k, v, n)
    rd, rl = decode_attention(q[:, :, 0], k, v, n, force_ref=True)
    torch.cuda.synchronize()
    _close(out, ref, dt)
    _close(od, rd, dt)
    _close(ld, rl, dt)


def test_attention_kernels_reject_what_they_cannot_run(cuda):
    q = torch.zeros((1, 4, 8, 64), device="cuda")
    k = torch.zeros((1, 2, 8, 64), device="cuda")
    wide = torch.zeros((1, 4, 8, 320), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(wide, wide[:, :2], wide[:, :2])
    with pytest.raises(ValueError, match="dtype"):
        flash_kernel.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="stride"):
        flash_kernel.flash_attention(q.transpose(2, 3), k.transpose(2, 3),
                                     k.transpose(2, 3))
    n = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        decode_kernel.decode_attention(wide[:, :, 0], wide[:, :2],
                                       wide[:, :2], n)
    with pytest.raises(ValueError, match="dtype"):
        decode_kernel.decode_attention(q[:, :, 0], k.bfloat16(),
                                       k.bfloat16(), n)
    with pytest.raises(ValueError, match="stride"):
        decode_kernel.decode_attention(q[:, :, :, 0], k.transpose(2, 3),
                                       k.transpose(2, 3), n)
    with pytest.raises(ValueError, match="int32"):
        decode_kernel.decode_attention(q[:, :, 0], k, k, n.long())
    many = torch.zeros((1, 33, 64), device="cuda")
    with pytest.raises(ValueError, match="group"):
        decode_kernel.decode_attention(many, k[:, :1], k[:, :1], n)


@pytest.mark.parametrize("name,chunk", [("qwen3-4b", 16),
                                        ("hymba-1.5b", None)])
def test_stripe_attention_engine_on_card(cuda, name, chunk):
    """Reduced GQA models on the stripe layout: every prefill call runs
    the flash kernel once per layer, every stripe decode step (not the
    chunk windows) the decode kernel once per layer, and the streams
    equal the CPU engine's (plain attention) on the same weights."""
    cfg = dataclasses.replace(get_config(name).reduced(), n_kv_heads=2)
    params = build_model(cfg, device="cuda").init(0)
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 7, 70, 12)]
    streams = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        p = params if device == "cuda" else _to(params, "cpu")
        before = (flash_kernel.flash_attention.launches,
                  decode_kernel.decode_attention.launches)
        eng = ServingEngine(model, p, batch_size=3, max_seq=96, paged=False,
                            prefill_chunk=chunk, device=device)
        reqs = [Request(rid=i, prompt=list(q), max_new_tokens=6)
                for i, q in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == len(prompts)
        m = eng.metrics
        flash = flash_kernel.flash_attention.launches - before[0]
        dec = decode_kernel.decode_attention.launches - before[1]
        on = device == "cuda"
        assert flash == (cfg.n_layers * m["prefill_batches"] if on else 0)
        assert dec == (cfg.n_layers * (m["decode_steps"] - m["chunk_steps"])
                       if on else 0)
        assert eng.pool_stats()["active"] == 0
        streams[device] = reqs
    for a, b in zip(streams["cuda"], streams["cpu"]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-4, rtol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------- sampler and serving
SAMPLER_ROWS = [(t, k, s) for t in (0.0, 0.3, 1.0, 1.5) for k in (0, 1, 50)
                for s in (0, 7, -1, 2**31 - 1)]


@pytest.mark.parametrize("V", [1000, 151936])
def test_sampler_card_matches_cpu(cuda, V):
    """The same logits on the card and on the CPU: threefry bits and
    uniforms bitwise equal, sampled / draft tokens identical on every row
    of the (temperature, top-k, seed) grid; logprobs within 2e-5."""
    import numpy as np

    from repro_torch.serve import prng, sampling
    g = torch.Generator().manual_seed(V)
    temps, top_ks, seeds = (np.asarray(c, dt) for c, dt in zip(
        zip(*SAMPLER_ROWS), (np.float32, np.int32, np.int32)))
    ctrs = np.arange(len(SAMPLER_ROWS), dtype=np.int32)
    k0, k1 = sampling.stream_keys(seeds, ctrs, sampling.TOKEN_STREAM)
    bits = {d: prng.bits(torch.as_tensor(k0, device=d),
                         torch.as_tensor(k1, device=d), V)
            for d in ("cuda", "cpu")}
    assert torch.equal(bits["cuda"].cpu(), bits["cpu"])
    assert torch.equal(prng.uniform(bits["cuda"]).cpu().view(torch.int32),
                       prng.uniform(bits["cpu"]).view(torch.int32))
    lg = torch.randn((len(SAMPLER_ROWS), V), generator=g) * 3
    out = {d: (sampling.sample(lg.to(d), temps, top_ks, seeds, ctrs),
               sampling.draft_propose(lg.to(d), temps, top_ks, seeds, ctrs,
                                      ctrs % 3))
           for d in ("cuda", "cpu")}
    (tok, lp), (dtok, _) = out["cuda"]
    (ctok, clp), (cdtok, _) = out["cpu"]
    assert tok.cpu().tolist() == ctok.tolist()
    assert dtok.cpu().tolist() == cdtok.tolist()
    torch.testing.assert_close(lp.cpu(), clp, atol=2e-5, rtol=2e-5)


def _sampled_requests(cfg, n, max_new, seed):
    from repro_torch.serve.sampling import SamplingParams
    g = torch.Generator().manual_seed(seed)
    return [Request(rid=i, prompt=torch.randint(2, cfg.vocab_size,
                                                (9 + 11 * i,),
                                                generator=g).tolist(),
                    max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.7, top_k=50 * (i % 3),
                                            seed=i) if i % 2
                    else SamplingParams())
            for i in range(n)]


def test_dispatch_does_not_wait_for_the_device(cuda):
    """With sampled rows in the batch, ``dispatch_step()`` returns while
    the step runs: behind a 200 ms spin it returns before the spin ends
    (nothing in it waited for the device), the stream is busy right
    after it, and PyTorch's sync debug mode sees no synchronising call.
    The reduced model's step (~400 launches) fits the device's launch
    queue; a full-depth step would fill it behind the spin."""
    import time
    import warnings
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cuda")
    eng = ServingEngine(model, model.init(0), batch_size=4, max_seq=128,
                        use_kernel=True)
    assert eng.add_requests(_sampled_requests(cfg, 4, 32, 5)) == 4
    eng.step()
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)           # ~200 ms at 1.98 GHz
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                tick = eng.dispatch_step()
                host_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert not torch.cuda.current_stream().query()
        tick.commit()
        assert host_s < 0.1, host_s
        assert not [w for w in caught if "called a synchronizing CUDA "
                    "operation" in str(w.message)]


def test_lm_service_on_card_counts_kernel_launches(cuda):
    """A small LM service on the card (use_kernel, sampled and greedy
    payloads) launches the paged-window kernel once per layer per step
    and the flash kernel once per layer per prefill call; streams are
    complete and the pool drains."""
    from repro_torch.serve.service import make_lm_service
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              n_kv_heads=2)
    model = build_model(cfg, device="cuda")
    svc = make_lm_service("lm", model, model.init(0), batch_size=4,
                          max_seq=128, use_kernel=True, prefill_chunk=16)
    svc.start()
    pw, fl = pw_kernel.paged_window_attention, flash_kernel.flash_attention
    before = (pw.launches, fl.launches)
    rep = svc.replicas[0].handler
    handles = [rep.submit({"prompt": r.prompt, "max_new_tokens": 6,
                           **({"sampling": {"temperature": 0.7, "seed": i}}
                              if i % 2 else {})})
               for i, r in enumerate(_sampled_requests(cfg, 5, 6, 7))]
    replies = [h.result() for h in handles]
    assert all(len(r["tokens"]) == 6 for r in replies)
    m = rep.scheduler.engine.metrics
    assert pw.launches - before[0] == cfg.n_layers * m["decode_steps"]
    assert fl.launches - before[1] == cfg.n_layers * m["prefill_batches"]
    assert m["chunk_steps"] > 0
    stats = rep.scheduler.engine.pool_stats()
    assert stats["used"] == 0 and stats["logical_blocks"] == 0


# ---------------------------------------- speculative and MoE serving
def spec_launches(m, draft, L_target, L_draft, paged):
    """Launches a speculating engine owes each attention kernel: the
    target's paged kernel once per layer per step (plain, chunk and
    verify alike), its flash kernel once per layer per prefill call,
    its decode kernel once per layer per plain stripe decode step; the
    draft's flash kernel once per layer per admission prefill call and
    its decode kernel once per layer per proposal step (its catch-up
    windows stay plain torch)."""
    plain = m["decode_steps"] - m["chunk_steps"] - m["verify_steps"]
    return {
        "paged_window_attention": L_target * m["decode_steps"] if paged
        else 0,
        "flash_attention": L_target * m["prefill_batches"]
        + L_draft * draft.admit_calls,
        "decode_attention": (0 if paged else L_target * plain)
        + L_draft * (draft.steps_run - draft.ingest_steps)}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "stripes"])
def test_speculating_engine_on_card(cuda, paged):
    """Reduced GQA qwen3-4b (f32) speculating with k = 3 on the card, a
    1-layer draft cut from the target: every kernel launches by the
    rule above, the streams equal the non-speculative engine's on the
    card (logprobs within 1e-3: the verify window's kernel plan sums in
    another order than the decode step's), and the pool drains."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              n_kv_heads=2)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    draft = build_model(dcfg, device="cuda")
    dparams = dict(params, blocks=_to_layers(params["blocks"], 1))
    g = torch.Generator().manual_seed(8)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 23, 5, 12)]
    fns = (pw_kernel.paged_window_attention, flash_kernel.flash_attention,
           decode_kernel.decode_attention)
    streams = {}
    for k in (3, 0):
        before = {fn.__name__: fn.launches for fn in fns}
        eng = ServingEngine(model, params, batch_size=4, max_seq=128,
                            paged=paged, prefill_chunk=16, use_kernel=True,
                            draft_model=draft if k else None,
                            draft_params=dparams if k else None,
                            speculation=k)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=9,
                        speculation=0 if i == 1 else None)
                for i, p in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == len(prompts)
        streams[k] = reqs
        if k:
            m = eng.metrics
            assert m["verify_steps"] > 0 and m["spec_proposed"] > 0
            want = spec_launches(m, eng.draft, cfg.n_layers, 1, paged)
            got = {fn.__name__: fn.launches - before[fn.__name__]
                   for fn in fns}
            assert got == want
        if paged:
            assert eng.pool_stats()["used"] == 0
    for a, b in zip(streams[3], streams[0]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-3, rtol=1e-3)


def test_speculating_dispatch_does_not_wait_for_the_device(cuda):
    """A speculative tick (draft catch-up, k draws, verify, acceptance)
    is launched without a synchronising call: the proposals stay on the
    device. With sampled rows PyTorch's sync debug mode sees no
    synchronising call; an all-greedy tick (k 2, no random draws: a
    sampled draw adds ~200 launches, and k of them fill the device's
    launch queue behind a long spin) returns behind a 200 ms spin before
    the spin ends."""
    import time
    import warnings
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    for sampled in (True, False):
        eng = ServingEngine(model, params, batch_size=4, max_seq=128,
                            use_kernel=True, draft_model=model,
                            draft_params=params,
                            speculation=3 if sampled else 2)
        reqs = _sampled_requests(cfg, 4, 40, 9)
        if not sampled:
            for r in reqs:
                r.sampling = reqs[0].sampling          # greedy
        assert eng.add_requests(reqs) == 4
        eng.step()
        for _ in range(3):
            torch.cuda.synchronize()
            if not sampled:
                torch.cuda._sleep(400_000_000)       # ~200 ms at 1.98 GHz
            steps = eng.metrics["verify_steps"]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    tick = eng.dispatch_step()
                    host_s = time.perf_counter() - t0
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            assert eng.metrics["verify_steps"] == steps + 1
            if not sampled:
                assert not torch.cuda.current_stream().query()
                assert host_s < 0.1, host_s
            tick.commit()
            assert not [w for w in caught if "called a synchronizing CUDA "
                        "operation" in str(w.message)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "stripes"])
def test_moe_engine_on_card(cuda, paged):
    """Reduced grok-1-314b (f32, 4 experts, top-2) on the card: solo
    prefills, the paged kernel once per layer per step, the flash kernel
    once per layer per prefill call (the decode kernel per stripe decode
    step), and the CPU engine's streams on the same weights (logprobs
    within 1e-4)."""
    cfg = get_config("grok-1-314b").reduced()
    params = build_model(cfg, device="cuda").init(0)
    g = torch.Generator().manual_seed(10)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 23, 5, 12)]
    fns = (pw_kernel.paged_window_attention, flash_kernel.flash_attention,
           decode_kernel.decode_attention)
    streams = {}
    for device in ("cuda", "cpu"):
        before = {fn.__name__: fn.launches for fn in fns}
        eng = ServingEngine(build_model(cfg, device=device),
                            params if device == "cuda"
                            else _to(params, "cpu"), batch_size=4,
                            max_seq=128, paged=paged, use_kernel=True,
                            device=device)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == len(prompts)
        m = eng.metrics
        assert m["prefill_batches"] == m["prefills"] == len(prompts)
        got = {fn.__name__: fn.launches - before[fn.__name__] for fn in fns}
        L = cfg.n_layers if device == "cuda" else 0
        assert got == {
            "paged_window_attention": L * m["decode_steps"] if paged else 0,
            "flash_attention": L * m["prefill_batches"],
            "decode_attention": 0 if paged else L * m["decode_steps"]}
        streams[device] = reqs
    for a, b in zip(streams["cuda"], streams["cpu"]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-4, rtol=1e-4)


def _to_layers(tree, n):
    """The first ``n`` layers of a tree of L-stacked tensors."""
    return {k: _to_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


# ------------------------------------------------------------ CV parser
# the sentence encoder's attention: B x S x T (12 / 12 heads of 64, at
# its sentence-batch buckets and S = T = 24, one part-filled KV tile),
# and a ragged S < T
ENCODER_FLASH = [(8, 24, 24), (16, 24, 24), (2, 37, 300)]
NON_CAUSAL_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T", ENCODER_FLASH)
def test_flash_non_causal_at_encoder_shapes(cuda, dt, B, S, T):
    """``causal=False`` on the model's (B,S,H,hd) views against the plain
    version: f32 within 3e-5, bf16 within 3e-2."""
    g = torch.Generator().manual_seed(B + S + T)
    q = torch.randn((B, S, 12, 64), generator=g).to("cuda", dt)
    kv = torch.randn((B, T, 2, 12, 64), generator=g).to("cuda", dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = flash_kernel.flash_attention.launches
    out = attention_bshd(q, k, v, causal=False)
    assert flash_kernel.flash_attention.launches == before + 1
    ref = attention_bshd(q, k, v, causal=False, force_ref=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=NON_CAUSAL_TOL[dt],
                               rtol=NON_CAUSAL_TOL[dt])


def test_cv_parser_on_card_matches_cpu(cuda):
    """``CVParser.create`` on the card (thread dispatch) against the port
    on the CPU with the same weights (sequential): fields equal label for
    label on ``make_corpus(8, seed=1)``, and the flash kernel launched
    once per encoder layer per parse, nothing else."""
    from repro_torch.core import cvdata
    from repro_torch.core.parallel import ParallelDispatcher
    from repro_torch.core.pipeline import CVParser, NERModel
    from repro_torch.core.services import Replica, Service

    parser = CVParser.create(0)
    assert parser.encoder_params["embed"].is_cuda
    services = {}
    for name, svc in parser.services.items():
        ner = svc.replicas[0].handler
        assert ner.params["embed"].is_cuda
        services[name] = Service(name, replicas=[Replica(name, NERModel(
            name, ner.cfg, _to(ner.params, "cpu"), ner.tokenizer))])
        services[name].start()
    cpu = dataclasses.replace(
        parser, services=services,
        encoder_params=_to(parser.encoder_params, "cpu"),
        classifier_params=_to(parser.classifier_params, "cpu"),
        dispatcher=ParallelDispatcher(mode="sequential"))
    docs = cvdata.make_corpus(8, seed=1)
    fns = (pw_kernel.paged_window_attention, flash_kernel.flash_attention,
           decode_kernel.decode_attention, wkv_kernel.wkv_scan,
           ssm_kernel.ssm_scan)
    before = {fn.__name__: fn.launches for fn in fns}
    outs = [parser.parse(d) for d in docs]
    got = {fn.__name__: fn.launches - before[fn.__name__] for fn in fns}
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = parser.encoder_cfg.n_layers * len(docs)
    assert got == want
    for d, o in zip(docs, outs):
        assert o["fields"] == cpu.parse(d)["fields"]
        assert o["dispatch"].mode == "thread"
    parser.dispatcher.shutdown()


# ------------------------------------------------------------ frontends
# B x S x T x (Hq, Hkv, hd) x causal: whisper-tiny's encoder (S = T =
# 1500, not a multiple of the kernel's tiles) and cross-attention (a
# prompt window and a decode step against the 1500 frames), qwen2-vl-2b's
# prefill (a 256-patch prefix and 64 text tokens, G 6)
FRONTEND_FLASH = [(4, 1500, 1500, (6, 6, 64), False),
                  (4, 16, 1500, (6, 6, 64), False),
                  (4, 1, 1500, (6, 6, 64), False),
                  (4, 320, 320, (12, 2, 128), True)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,heads,causal", FRONTEND_FLASH)
def test_flash_at_frontend_shapes(cuda, dt, B, S, T, heads, causal):
    """On the model's (B,S,H,hd) views against the plain version:
    non-causal f32 within 3e-5, causal 1e-4, bf16 3e-2."""
    Hq, Hkv, hd = heads
    g = torch.Generator().manual_seed(S + T + hd)
    q = torch.randn((B, S, Hq, hd), generator=g).to("cuda", dt)
    kv = torch.randn((B, T, 2, Hkv, hd), generator=g).to("cuda", dt)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = attention_bshd(q, k, v, causal=causal)
    ref = attention_bshd(q, k, v, causal=causal, force_ref=True)
    torch.cuda.synchronize()
    tol = TOL[dt] if causal else NON_CAUSAL_TOL[dt]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,T,lens", [
    ((6, 6, 64), 128, [1, 128, 37, 80]),          # whisper-tiny's stripes
    ((12, 2, 128), 512, [261, 512, 1, 336])])     # qwen2-vl-2b's (G 6)
def test_decode_at_frontend_stripes(cuda, dt, heads, T, lens):
    Hq, Hkv, hd = heads
    g = torch.Generator().manual_seed(T)
    q = torch.randn((len(lens), Hq, hd), generator=g).to("cuda", dt)
    k, v = (torch.randn((len(lens), T, Hkv, hd), generator=g).to("cuda", dt)
            .transpose(1, 2) for _ in range(2))
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lse = decode_attention(q, k, v, n)
    ro, rl = decode_attention(q, k, v, n, force_ref=True)
    torch.cuda.synchronize()
    _close(out, ro, dt)
    _close(lse, rl, dt)


@pytest.mark.parametrize("name", ["whisper-tiny", "qwen2-vl-2b"])
def test_frontend_model_on_card_matches_cpu(cuda, name):
    """Reduced width, f32: a right-padded prefill with the frontend's
    input and three decode steps at per-row lengths on stripes, on the
    card (flash and decode kernels) and on the CPU with the same weights:
    logits within 1e-4; flash once per attention layer at the prefill
    (whisper: encoder, self and cross) and once per cross-attention
    layer a step, decode once per layer a step."""
    cfg = get_config(name).reduced()
    card = build_model(cfg, device="cuda")
    host = build_model(cfg, device="cpu")
    params = card.init(0)
    hparams = _to(params, "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (3, 8), generator=g)
    batch = {"tokens": toks}
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn((3, cfg.n_frames, cfg.d_model),
                                      generator=g)
    else:
        batch["patch_embeds"] = torch.randn((3, cfg.n_patches, cfg.d_model),
                                            generator=g)
    last = torch.tensor([7, 2, 5])
    prefix = cfg.n_patches if cfg.frontend == "vision" else 0
    cross = cfg.encoder_layers + cfg.n_layers if cfg.cross_attention else 0
    fns = (flash_kernel.flash_attention, decode_kernel.decode_attention)
    outs = {}
    for dev, model, p in (("cuda", card, params), ("cpu", host, hparams)):
        before = [fn.launches for fn in fns]
        logits, kv = model.prefill(p, _to(batch, dev), last_idx=last.to(dev))
        cache = model.init_cache(3, 32)
        S = kv["k"].shape[2]
        for key, t in kv.items():
            if key in ("k", "v"):
                cache[key][:, :, :S] = t
            else:
                cache[key].copy_(t)
        n = (last + 1 + prefix).to(dev, torch.int32)
        steps = [logits]
        for j in range(3):
            steps.append(model.decode_step(p, toks[:, j:j + 1].to(dev),
                                           cache, n + j)[0])
        outs[dev] = [t.cpu() for t in steps]
        if dev == "cuda":
            torch.cuda.synchronize()
            got = [fn.launches - b for fn, b in zip(fns, before)]
            L = cfg.n_layers
            assert got == [L + cross + 3 * (L if cross else 0), 3 * L]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------- training on the card
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # of max |g|
# B x Hq x Hkv x hd x S x T x window x causal: G 1 / 4 / 6, S < T, S > T
# (keyless rows), a window, non-causal (whisper), the config head dims;
# then the bf16 route's edges: S and T one under and one over a multiple
# of the 64-key tile and of the 32-query item, key tiles whose items the
# plan splits over several CTAs (G 6 at hd 128, S 200; S 333), and a
# 40-key window that spans items in different Q / dO stages; then hd 160
# / 192 / 256 (bf16 on two warpgroups in dK / dV and 32-key tiles in dQ;
# f32 on 32-key tiles at hd > 128): S and T one over and one under the
# 32-key dQ tile and the 32-query item (64 in bf16 at hd 192), GQA 12 /
# 4, a sliding window,
# non-causal S < T, and split tiles on both routes (hd 192 S 300: key
# tile 0's 30 items; f32 hd 64 S 333 and hd 128 S 200 split too)
BWD_GRID = [
    (2, 8, 2, 128, 100, 100, 0, True),
    (1, 6, 6, 64, 150, 150, 0, False),
    (1, 6, 6, 64, 45, 150, 0, False),
    (1, 12, 2, 128, 70, 70, 0, True),
    (1, 8, 2, 128, 130, 130, 32, True),
    (1, 4, 2, 112, 65, 90, 0, True),
    (1, 4, 1, 192, 33, 50, 24, True),
    (1, 4, 2, 64, 40, 20, 0, True),
    (2, 2, 2, 32, 17, 17, 0, True),
    (1, 4, 2, 128, 63, 63, 0, True),
    (1, 4, 2, 128, 65, 65, 0, True),
    (1, 4, 2, 64, 31, 127, 0, True),
    (1, 4, 2, 64, 33, 129, 0, False),
    (1, 12, 2, 128, 200, 200, 0, True),
    (2, 8, 2, 64, 333, 333, 0, True),
    (1, 8, 2, 128, 160, 160, 40, True),
    (1, 12, 4, 192, 33, 63, 0, True),
    (1, 12, 4, 192, 97, 95, 24, True),
    (1, 12, 4, 192, 300, 300, 0, True),
    (1, 12, 4, 192, 65, 127, 0, True),
    (1, 12, 4, 192, 63, 129, 16, True),
    (2, 12, 4, 160, 129, 129, 0, True),
    (1, 4, 1, 160, 31, 150, 0, False),
    (1, 8, 2, 256, 65, 129, 0, True),
    (1, 8, 2, 256, 200, 200, 40, True),
]


def _bwd_case(B, Hq, Hkv, hd, S, T, dt, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to("cuda", dt)
            for shape in ((B, Hq, S, hd), (B, Hkv, T, hd), (B, Hkv, T, hd),
                          (B, Hq, S, hd))]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,hd,S,T,win,causal", BWD_GRID)
def test_flash_backward_matches_plain_version(cuda, dt, B, Hq, Hkv, hd, S,
                                              T, win, causal):
    """The kernel's lse against the plain one; the backward kernel against
    ``flash_attention_bwd_ref`` on the same out / lse, twice bitwise, no
    NaN, dq 0 on rows that see no key."""
    from repro_torch.kernels.flash_attention import backward
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    q, k, v, do = _bwd_case(B, Hq, Hkv, hd, S, T, dt, S * T + hd)
    out, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                            sliding_window=win,
                                            with_lse=True)
    _, rlse = flash_attention_ref(q, k, v, causal=causal,
                                  sliding_window=win, return_lse=True)
    live = torch.isfinite(rlse)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], rlse[live], atol=1e-3, rtol=1e-4)
    before = backward.flash_attention_bwd.launches
    got = backward.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       sliding_window=win)
    again = backward.flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, sliding_window=win)
    assert backward.flash_attention_bwd.launches == before + 2
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   sliding_window=win)
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, g2) and torch.isfinite(g).all()
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) \
            <= BWD_TOL[dt] * max(scale, 1e-30)
    assert (got[0][~live] == 0).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 100, 192, 256])
def test_flash_backward_takes_unaligned_rows(cuda, dt, hd):
    """Rows that do not start 16-byte aligned (views one element into
    their buffers), and hd 100 (no whole 16-byte loads), take the
    element-wise staging path of either route: the plain version's
    gradients."""
    from repro_torch.kernels.flash_attention import backward
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    g = torch.Generator().manual_seed(hd)
    qb = torch.randn((2, 4, 40, hd + 1), generator=g).to("cuda", dt)
    kvb = torch.randn((2, 2, 50, hd + 1), generator=g).to("cuda", dt)
    dob = torch.randn((2, 4, 40, hd + 1), generator=g).to("cuda", dt)
    q, k, v, do = qb[..., 1:], kvb[..., 1:], kvb[..., :hd], dob[..., 1:]
    assert not flash_kernel.rows_aligned(q, k, v, do)
    out, lse = flash_kernel.flash_attention(q, k, v, sliding_window=9,
                                            with_lse=True)
    got = backward.flash_attention_bwd(q, k, v, out, lse, do,
                                       sliding_window=9)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, sliding_window=9)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) \
            <= BWD_TOL[dt] * scale


@pytest.mark.parametrize("hd,causal,win", [(128, True, 0), (64, False, 0),
                                           (128, True, 40), (192, True, 0),
                                           (256, True, 40)])
def test_flash_backward_staging_routes_agree(cuda, hd, causal, win):
    """bf16 (one warpgroup in dK / dV at hd <= 128, two above): the same
    values as contiguous tensors (16-byte cp.async staging) and as views
    one element into their buffers (element-wise staging) give the same
    gradients bit for bit, each within BWD_TOL of the plain version; the
    plan splits key tile 0."""
    from repro_torch.kernels.flash_attention import backward
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    B, Hq, Hkv, S, T = 1, 8, 2, 190, 190
    q, k, v, do = _bwd_case(B, Hq, Hkv, hd, S, T, torch.bfloat16, hd + win)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    oq, ok_, ov, odo = (offset(t) for t in (q, k, v, do))
    assert flash_kernel.rows_aligned(q, k, v, do)
    assert not flash_kernel.rows_aligned(oq, ok_, ov, odo)
    rt = backward.route(torch.bfloat16, hd)
    p = backward.plan(B, Hq, Hkv, S, T, causal, win, rt=rt)
    assert all(r[3] > 1 for r in p.entries if r[0] == 0)
    out, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                            sliding_window=win,
                                            with_lse=True)
    got = backward.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       sliding_window=win)
    staged = backward.flash_attention_bwd(oq, ok_, ov, offset(out), lse, odo,
                                          causal=causal, sliding_window=win)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   sliding_window=win)
    torch.cuda.synchronize()
    for a, c, w in zip(got, staged, want):
        assert torch.equal(a, c)
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) \
            <= BWD_TOL[torch.bfloat16] * scale


def test_flash_backward_rejects_what_it_cannot_run(cuda):
    from repro_torch.kernels.flash_attention import backward
    q = torch.zeros((1, 4, 8, 64), device="cuda")
    kv = torch.zeros((1, 2, 8, 64), device="cuda")
    lse = torch.zeros((1, 4, 8), device="cuda")
    fn = backward.flash_attention_bwd
    before = fn.launches
    bad = [(q, kv, kv, q, lse[..., :4], q),                  # lse shape
           (q, kv, kv, q, lse.double(), q),                  # lse dtype
           (q, kv, kv, q, lse, q[:, :, :4]),                 # dout shape
           (q, kv, kv, q.bfloat16(), lse, q),                # out dtype
           (q, kv, kv, q, lse, torch.zeros(
               (1, 4, 8, 128), device="cuda")[..., ::2])]    # dout stride
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args)
    wide = torch.zeros((1, 4, 8, 264), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fn(wide, wide[:, :2], wide[:, :2], wide, lse, wide)
    assert fn.launches == before


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_autograd_route_matches_plain_autograd(cuda, dt):
    """attention_bshd on the model's (B,S,H,hd) views that require grad:
    one forward and one backward launch, gradients equal to autograd of
    the plain version; under no_grad the forward alone."""
    from repro_torch.kernels.flash_attention import backward
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 90, 8, 128), generator=g).to("cuda", dt)
    kv = torch.randn((2, 90, 2, 2, 128), generator=g).to("cuda", dt)
    do = torch.randn((2, 90, 8, 128), generator=g).to("cuda", dt)
    grads = []
    for force_ref in (False, True):
        qg, kvg = q.clone().requires_grad_(True), kv.clone().requires_grad_(
            True)
        before = (flash_kernel.flash_attention.launches,
                  backward.flash_attention_bwd.launches)
        out = attention_bshd(qg, kvg[:, :, 0], kvg[:, :, 1],
                             sliding_window=40, force_ref=force_ref)
        grads.append(torch.autograd.grad(out, (qg, kvg), do))
        after = (flash_kernel.flash_attention.launches,
                 backward.flash_attention_bwd.launches)
        assert [a - b for a, b in zip(after, before)] == \
            ([0, 0] if force_ref else [1, 1])
    for a, b in zip(*grads):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) \
            <= BWD_TOL[dt] * scale
    with torch.no_grad():
        before = backward.flash_attention_bwd.launches
        attention_bshd(q.requires_grad_(True), kv[:, :, 0], kv[:, :, 1])
        assert backward.flash_attention_bwd.launches == before


def test_kernels_without_backward_raise_under_grad(cuda):
    """The paged-window and decode ops, which serve only, refuse a call
    autograd would record (no plain-version fallback), and run under
    no_grad; the flash, WKV and selective-scan kernels refuse it when
    called directly (their ops train through autograd functions)."""
    q, pk, pv, table, base = _case(2, 4, 8, 2, 64, 16, 4, torch.float32)
    g = torch.Generator().manual_seed(2)
    kst = torch.randn((2, 2, 64, 64), generator=g).cuda()
    n = torch.tensor([5, 64], dtype=torch.int32, device="cuda")
    r, k, v, w, u, s = _wkv_case(1, 5, 2, 32, 0)
    x = _ssm_case(1, 5, 40, 16, 0)
    calls = {
        "paged_window_attention": lambda a: paged_window_attention(
            a, pk, pv, table, base),
        "decode_attention": lambda a: decode_attention(a, kst, kst, n),
        "wkv_scan": lambda a: wkv_kernel.wkv_scan(a, k, v, w, u, s),
        "ssm_scan": lambda a: ssm_kernel.ssm_scan(a, *x[1:]),
        "flash_attention": lambda a: flash_kernel.flash_attention(
            a, kst, kst),
    }
    firsts = {"paged_window_attention": q,
              "decode_attention": torch.randn((2, 4, 64), generator=g).cuda(),
              "wkv_scan": r, "ssm_scan": x[0],
              "flash_attention": torch.randn((2, 4, 9, 64),
                                             generator=g).cuda()}
    for name, call in calls.items():
        a = firsts[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call(a)
        with torch.no_grad():
            call(a)
    torch.cuda.synchronize()


# (B, T, H, hd, decays) of the WKV backward: T 1, the 8-step chunk edge,
# several chunks with a partial last one, the 4-chunk groups whose dv
# partials cross the cluster at once (T 40 and 300: a partial last
# group), hd off the row blocks (40) and at every padded head dim (32, 64,
# 128): clusters of 1, 2, 8 and 2 CTAs; hd 8 and 16, one CTA a head; hd
# 30, whose rows take the 4-byte staging path
WKV_BWD_GRID = [
    (2, 1, 4, 64, "mid"),
    (2, 17, 3, 32, "model"),
    (1, 40, 2, 64, "model"),
    (1, 33, 2, 128, "mid"),
    (2, 9, 2, 40, "model"),
    (1, 300, 4, 64, "model"),
    (2, 24, 2, 8, "model"),
    (1, 41, 3, 16, "mid"),
    (2, 21, 3, 30, "model"),
]
# (B, T, di, N) of the selective-scan backward: every lane layout, a
# ragged channel tail, T 1, the 8-step chunk edges and partial 4-chunk
# groups (T 300); clusters padded
# with CTAs that hold no channel (520 channels at N 16: 33 CTAs of 16
# channels, 5 clusters of 8) and clusters of fewer than 8 CTAs (24
# channels: 2)
SSM_BWD_GRID = [
    (2, 1, 3200, 16),
    (2, 17, 40, 16),
    (1, 40, 130, 64),
    (2, 7, 200, 5),
    (1, 33, 70, 1),
    (1, 16, 48, 2),
    (2, 300, 3200, 16),
    (1, 20, 520, 16),
    (2, 9, 24, 16),
    (1, 12, 300, 32),
]


def _grad_err(got, want):
    """Largest |got - want| over largest |want|, per gradient."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(got, want)]


def _ssm_bwd_case(B, T, di, N, seed):
    """``_ssm_case`` with A in hymba's [-16, -1], steps where exp(dt A)
    underflows to 0 (dt 8), and the cotangents dy and dstate_out."""
    u, dt, Bm, Cm, A, D, s0 = _ssm_case(B, T, di, N, seed=seed)
    g = torch.Generator().manual_seed(T)
    A = -(1.0 + 15.0 * torch.rand((di, N), generator=g)).cuda()
    dt = torch.where(torch.rand((B, T, di), generator=g).cuda() < 0.1,
                     8.0, dt)
    dy = torch.randn((B, T, di), generator=g).cuda()
    ds = torch.randn((B, di, N), generator=g).cuda()
    return (u, dt, Bm, Cm / math.sqrt(N), A, D, s0), (dy, ds)


@pytest.mark.parametrize("B,T,H,hd,decays", WKV_BWD_GRID)
def test_wkv_backward_matches_plain_version(cuda, B, T, H, hd, decays):
    """The backward kernel, fed the checkpoints the training forward wrote,
    against ``wkv_bwd_ref`` on the same inputs and cotangents (decays
    down to exactly 0 in the model's range), each gradient within 1e-4
    of its largest magnitude; two calls bitwise equal; nothing NaN."""
    from repro_torch.kernels.rwkv_scan import backward
    from repro_torch.kernels.rwkv_scan.ref import wkv_bwd_ref
    args = _wkv_case(B, T, H, hd, seed=T + hd, decays=decays)
    g = torch.Generator().manual_seed(T)
    dout = torch.randn((B, T, H, hd), generator=g).cuda()
    ds = torch.randn((B, H, hd, hd), generator=g).cuda()
    ck = wkv_kernel.wkv_scan(*args, checkpoints=True)[2]
    before = backward.wkv_bwd.launches
    got = backward.wkv_bwd(*args, ck, dout, ds)
    again = backward.wkv_bwd(*args, ck, dout, ds)
    assert backward.wkv_bwd.launches == before + 2
    want = wkv_bwd_ref(*args, dout, ds)
    for a, b in zip(got, again):
        assert torch.equal(a, b) and torch.isfinite(a).all()
    assert max(_grad_err(got, want)) <= 1e-4


@pytest.mark.parametrize("B,T,di,N", SSM_BWD_GRID)
def test_ssm_backward_matches_plain_version(cuda, B, T, di, N):
    """The backward kernel, fed the checkpoints the training forward wrote,
    against ``ssm_scan_bwd_ref`` on the same inputs and cotangents (A in
    hymba's [-16, -1] with steps where exp(dt A) underflows to 0), each
    gradient within 1e-4 of its largest magnitude; two calls bitwise
    equal; nothing NaN."""
    from repro_torch.kernels.ssm_scan import backward
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    args, (dy, ds) = _ssm_bwd_case(B, T, di, N, seed=T + N)
    ck = ssm_kernel.ssm_scan(*args, checkpoints=True)[2]
    before = backward.ssm_scan_bwd.launches
    got = backward.ssm_scan_bwd(*args, ck, dy, ds)
    again = backward.ssm_scan_bwd(*args, ck, dy, ds)
    assert backward.ssm_scan_bwd.launches == before + 2
    want = ssm_scan_bwd_ref(*args, dy, ds)
    for a, b in zip(got, again):
        assert torch.equal(a, b) and torch.isfinite(a).all()
    assert max(_grad_err(got, want)) <= 1e-4


@pytest.mark.parametrize("op", ["wkv", "ssm"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 33, 300])
def test_scan_checkpoints_match_plain_states(cuda, op, T):
    """The training forward's checkpoints equal the plain recurrence's
    states at the backward's 8-step chunk starts (none at T up to one
    chunk; WKV's transposed),
    within the scan tolerance, with an
    exact-zero decay (WKV) or dt 8 (exp(dt A) = 0) at every chunk's first
    step; its out and final state are the serving forward's, bitwise."""
    if op == "wkv":
        from repro_torch.kernels.rwkv_scan.ref import wkv_checkpoints_ref
        args = _wkv_case(2, T, 3, 64, seed=T, decays="model")
        every = wkv_kernel.CHECKPOINT_STEPS
        args[3][:, ::every] = 0.0
        fn = wkv_kernel.wkv_scan
        want = wkv_checkpoints_ref(*args[:4], args[5], every=every)
        count = wkv_kernel.checkpoint_count(T)
    else:
        from repro_torch.kernels.ssm_scan.ref import ssm_scan_checkpoints_ref
        args = list(_ssm_bwd_case(2, T, 130, 16, seed=T)[0])
        every = ssm_kernel.CHECKPOINT_STEPS
        args[1][:, ::every] = 8.0
        fn = ssm_kernel.ssm_scan
        want = ssm_scan_checkpoints_ref(args[0], args[1], args[2], args[4],
                                        args[6], every=every)
        count = ssm_kernel.checkpoint_count(T)
    assert count == max(T - 1, 0) // every
    before = fn.launches
    out, st, ck = fn(*args, checkpoints=True)
    with torch.no_grad():
        out2, st2 = fn(*args)
    assert fn.launches == before + 2
    assert ck.shape == want.shape
    assert ck.shape[2 if op == "wkv" else 1] == count
    assert torch.equal(out, out2) and torch.equal(st, st2)
    if count:
        assert float((ck - want).abs().max()) <= _scan_tol(T)


@pytest.mark.parametrize("op", ["wkv", "ssm"])
def test_scan_backward_scratch_sizing_refuses_what_the_kernel_does_not_take(
        cuda, op):
    """The CUDA sources size their own scratch (WKV: the du partials;
    the selective scan: the clusters' dB / dC partials and the batch
    rows' dA / dD partials): every shape of the grids above gets positive
    sizes, and a head dim past 128, a state past 64, an empty axis or a
    batch past the grid's 65535 is refused with a ValueError before
    anything is launched."""
    if op == "wkv":
        from repro_torch.kernels.rwkv_scan import backward
        fn, good = backward.wkv_bwd, [c[:4] for c in WKV_BWD_GRID]
        bad = [(1, 8, 2, 129), (1, 0, 2, 64), (65536, 1, 1, 64),
               (1, 1, 65536, 64)]
        sizes = {(2, 1, 4, 64): (2 * 4 * 64,)}
    else:
        from repro_torch.kernels.ssm_scan import backward
        fn, good = backward.ssm_scan_bwd, SSM_BWD_GRID
        bad = [(1, 8, 40, 65), (1, 8, 0, 16), (65536, 1, 40, 16)]
        # 200 CTAs of 16 channels a batch row: 25 clusters of 8
        sizes = {(2, 300, 3200, 16): (2 * 25 * 300 * 16, 2 * 25 * 300 * 16,
                                      2 * 3200 * 16, 2 * 3200)}
    before = fn.launches
    for shape in good:
        assert all(n > 0 for n in backward._scratch_sizes(*shape)), shape
    for shape, want in sizes.items():
        assert backward._scratch_sizes(*shape) == want
    for shape in bad:
        with pytest.raises(ValueError, match="takes no"):
            backward._scratch_sizes(*shape)
    assert fn.launches == before


@pytest.mark.parametrize("op", ["wkv", "ssm"])
def test_scan_backward_geometry_is_the_sources(cuda, op):
    """``backward.geometry`` (what the CPU tests cover) is the geometry the
    CUDA source launches, and the card holds at least one cluster of it at
    every shape of the grids above."""
    if op == "wkv":
        from repro_torch.kernels.rwkv_scan import backward
        for B, T, H, hd, _ in WKV_BWD_GRID:
            p = backward.geometry(hd)
            rows, threads, _, cluster = backward.source_geometry(hd)
            assert (rows, threads, cluster) == tuple(p)
            assert backward.max_active_clusters(B, T, H, hd) >= 1
    else:
        from repro_torch.kernels.ssm_scan import backward
        for B, T, di, N in SSM_BWD_GRID:
            p = backward.geometry(di, N)
            lanes, channels, _, cluster, clusters = \
                backward.source_geometry(B, T, di, N)
            assert (lanes, channels, cluster, clusters) == tuple(p)
            assert backward.max_active_clusters(B, T, di, N) >= 1


@pytest.mark.parametrize("op", ["wkv", "ssm"])
def test_scan_autograd_route_matches_plain_autograd(cuda, op):
    """On CUDA inputs that require grad the op takes its autograd function
    (one forward launch, with checkpoints, and one backward launch; the
    final state's gradient None), within 1e-4 of autograd of the plain
    version on the same inputs; a non-contiguous upstream gradient is
    taken; under no_grad the forward launches alone."""
    from repro_torch.kernels.rwkv_scan import backward as wkv_bwd
    from repro_torch.kernels.ssm_scan import backward as ssm_bwd
    if op == "wkv":
        xs = _wkv_case(2, 40, 3, 64, seed=5, decays="model")
        fn, fns = wkv, (wkv_kernel.wkv_scan, wkv_bwd.wkv_bwd)
    else:
        xs = _ssm_case(2, 40, 130, 16, seed=5)
        fn, fns = selective_scan, (ssm_kernel.ssm_scan, ssm_bwd.ssm_scan_bwd)
    g = torch.Generator().manual_seed(6)
    up = torch.randn(xs[0].shape[:-1] + (2 * xs[0].shape[-1],),
                     generator=g).cuda()[..., ::2]        # strided
    grads = []
    for force_ref in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in xs]
        before = [f.launches for f in fns]
        out, _ = fn(*leaves, force_ref=force_ref)
        grads.append(torch.autograd.grad(out, leaves, up))
        assert [f.launches - b for f, b in zip(fns, before)] == \
            ([0, 0] if force_ref else [1, 1])
    assert max(_grad_err(*grads)) <= 1e-4
    with torch.no_grad():
        before = [f.launches for f in fns]
        fn(*(t.clone().requires_grad_(True) for t in xs))
        assert [f.launches - b for f, b in zip(fns, before)] == [1, 0]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_train_loss_grads_on_card_match_cpu(cuda, arch):
    """Reduced configs, f32: train_loss and every gradient through the scan
    kernels (and hymba's flash kernels) on the card against the port on
    the CPU (plain loops), 1e-4 of each leaf's largest |g|; one scan
    forward and one scan backward launch a layer."""
    from repro_torch.kernels.rwkv_scan import backward as wkv_bwd
    from repro_torch.kernels.ssm_scan import backward as ssm_bwd
    from repro_torch.train import tree
    cfg = get_config(arch).reduced()
    fns = ((wkv_kernel.wkv_scan, wkv_bwd.wkv_bwd) if arch == "rwkv6-1.6b"
           else (ssm_kernel.ssm_scan, ssm_bwd.ssm_scan_bwd))
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (2, 33),
                                     generator=g)}
    params = build_model(cfg, device="cpu").init(0)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        p = _to(params, dev)
        leaves = tree.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        before = [f.launches for f in fns]
        loss, _ = model.train_loss(p, _to(batch, dev))
        grads = torch.autograd.grad(loss, leaves)
        n = [f.launches - b for f, b in zip(fns, before)]
        out[dev] = (float(loss.detach()), [t.cpu() for t in grads], n)
    assert out["cuda"][2] == [cfg.n_layers] * 2 and out["cpu"][2] == [0, 0]
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) \
            <= 1e-4 * max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("arch,kw", [("qwen3-4b", {"use_kernel": True}),
                                     ("hymba-1.5b", {}),
                                     ("rwkv6-1.6b", {})])
def test_params_requiring_grad_serve_on_card(cuda, arch, kw):
    """Params that require grad (as a train step leaves them) serve
    without tripping a kernel's refusal, with the detached params'
    streams: the engine runs under no_grad."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_kv_heads=2) \
        if arch != "rwkv6-1.6b" else get_config(arch).reduced()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    streams = []
    for p in (params, _grad_tree(params)):
        eng = ServingEngine(model, p, batch_size=2, max_seq=64, **kw)
        reqs = [Request(rid=i, prompt=list(range(3 + i, 12 + 3 * i)),
                        max_new_tokens=4) for i in range(3)]
        assert len(eng.run(list(reqs))) == 3
        streams.append([(r.out_tokens, r.out_logprobs) for r in reqs])
    assert streams[0] == streams[1]


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.clone().requires_grad_(True)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny",
                                  "qwen2-vl-2b"])
def test_train_loss_grads_on_card_match_cpu(cuda, arch):
    """Reduced configs (G 2 where the config has GQA), f32: train_loss and
    every gradient through the flash kernels on the card against the
    port on the CPU (plain attention), 1e-4 of each leaf's largest |g|;
    one forward and one backward flash launch per attention call."""
    from repro_torch.kernels.flash_attention import backward
    from repro_torch.train import tree
    cfg = get_config(arch).reduced()
    if arch == "qwen3-4b":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (2, 17),
                                     generator=g)}
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      generator=g)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                            generator=g)
    params = build_model(cfg, device="cpu").init(0)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        p = _to(params, dev)
        leaves = tree.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        before = (flash_kernel.flash_attention.launches,
                  backward.flash_attention_bwd.launches)
        loss, _ = model.train_loss(p, _to(batch, dev))
        grads = torch.autograd.grad(loss, leaves)
        n = (flash_kernel.flash_attention.launches - before[0],
             backward.flash_attention_bwd.launches - before[1])
        out[dev] = (float(loss.detach()), [t.cpu() for t in grads], n)
    calls = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers
                            if cfg.cross_attention else 0)
    assert out["cuda"][2] == (calls, calls) and out["cpu"][2] == (0, 0)
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) \
            <= 1e-4 * max(float(b.abs().max()), 1e-30)
