"""Binding of the CUDA flash-attention backward kernel
(``csrc/flash_bwd.cu``, built by ``kernels._build``, loaded with
``ctypes``): warpgroup MMA for bf16 (hd <= 256), register-tiled CUDA
cores for f32.

The kernel reads q, k, v, out and dout through their element strides
(head-dim stride 1) and writes dq, dk, dv, allocated here contiguous in
the inputs' dtype; lse is the forward's (B, Hq, S) f32 log-sum-exp. It
launches twice on the current CUDA stream (dQ, which also writes the
row sums D = rowsum(dO * O) to a scratch, then dK / dV) without
synchronising; a launch CUDA refuses raises.
``flash_attention_bwd.launches`` counts successful calls. The launch
is the CUDA implementation of the op ``repro_torch::flash_attention_bwd``
(``kernels.kernel_op``).

``plan`` is the dK / dV launch's work list on both routes, a function of
shapes and of the route (``route``: the keys of a CTA, the queries of an
item and the CTAs an SM holds): a key tile's items (one query tile of one query head of
its group each) are split into runs of at most ``chunk`` items, one CTA
each, largest runs first, so the causal tiles that see every query no
longer set the launch's length. A tile split over several CTAs is summed
from f32 partials in a fixed order, so every run gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import (_build, costs, count_launch, kernel_op,
                                 stream_scratch)
from repro_torch.kernels.flash_attention import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"
WAVES = 4               # runs planned per CTA the card holds at once
MIN_CHUNK = 8           # items a run has at least, where a tile splits
MAX_ENTRIES = 65535     # the launch's grid.y
# the C signature: q, k, v, out, lse, dout, dq, dk, dv, dsum, plan, part,
# counters; B, Hq, Hkv, S, T, hd, 24 strides (q, k, v, out, dout, dq, dk,
# dv: batch, head, position), causal, window, vec, dtype, n_entries,
# n_slots; stream
ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 36 + [ctypes.c_void_p]


class Route(NamedTuple):
    """The kernels one (dtype, head dim) takes, as the dK / dV plan and the
    scratch sizes see them (``csrc/flash_bwd.cu``'s WgCfg / F32Cfg)."""
    wgmma: bool         # bf16 on warpgroup MMA, else f32 on CUDA cores
    hdp: int            # hd zero-padded to 64, 128, 192 or 256
    key_tile: int       # keys of a dK / dV CTA
    query_tile: int     # queries of a dK / dV item
    ctas_per_sm: int    # dK / dV CTAs an SM holds (registers, shared memory)


def _hdp(hd: int) -> int:
    if not 1 <= hd <= kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the backward kernel takes "
                         f"1..{kernel.MAX_HEAD_DIM}")
    return -(-hd // 64) * 64


def route(dtype, hd: int) -> Route:
    """bf16: wgmma, 64-key tiles, items of 32 queries (64 at HDP 192),
    two CTAs an SM at HDP 64 / 128 (one warpgroup, 82 KB) and one at 192
    / 256 (two warpgroups, up to 255 registers a thread). f32: CUDA
    cores, items of 32 queries, 64-key tiles at HDP 64 / 128 and 32-key
    tiles at 192 / 256; two CTAs an SM at HDP 64 (88 KB), one above
    (155-216 KB of f32 tiles). A head dim past 256 raises."""
    hdp = _hdp(hd)
    if dtype == torch.bfloat16:
        return Route(True, hdp, 64, 64 if hdp == 192 else 32,
                     2 if hdp <= 128 else 1)
    if dtype == torch.float32:
        return Route(False, hdp, 64 if hdp <= 128 else 32, 32,
                     2 if hdp == 64 else 1)
    raise ValueError(f"dtype {dtype}: float32 or bfloat16 only")


# the qwen3-4b train shape's route, the plan's default
BF16_128 = route(torch.bfloat16, 128)


def wgmma_route(dtype, hd: int) -> bool:
    """bf16 at hd <= 256 takes the warpgroup-MMA kernels, f32 the CUDA-core
    ones; a head dim past 256 raises."""
    return route(dtype, hd).wgmma


def query_tiles(kt: int, S: int, T: int, causal: bool, window: int,
                key_tile: int, query_tile: int) -> range:
    """The query tiles (``query_tile`` rows) with a row that sees a key of
    key tile ``kt`` (``key_tile`` keys), as the dK / dV kernels compute
    them."""
    off = T - S
    k0, k1 = kt * key_tile, min(kt * key_tile + key_tile, T)
    lo = max(0, k0 - off) if causal else 0
    hi = min(S, k1 - 1 + window - off) if window > 0 else S
    if lo >= hi:
        return range(0)
    return range(lo // query_tile, -(-hi // query_tile))


class Plan(NamedTuple):
    # per CTA row: (key tile, first item, end item, splits of the tile,
    # this split, the tile's first partial slot); the same for every
    # (batch row, KV head)
    entries: tuple
    n_slots: int       # partial slots a (batch row, KV head) needs
    chunk: int         # items a run has at most
    key_tile: int      # keys of a CTA
    query_tile: int    # queries of an item


def plan(B: int, Hq: int, Hkv: int, S: int, T: int, causal: bool,
         window: int, sms: int = 132, rt: Route = BF16_128) -> Plan:
    """The dK / dV launch's work list on route ``rt``. Item i of key tile
    kt is query tile ``query_tiles(kt, ...)[i % n]`` of query head ``i // n``
    of the group (n tiles). Runs hold at most ``chunk`` items: the items
    of all tiles over WAVES x the CTAs the card holds at once
    (``rt.ctas_per_sm`` an SM), at least MIN_CHUNK, so at the qwen3-4b
    train shape in bf16 key tile 0 (all 4 heads x 32 query tiles)
    becomes 4 runs of 32. A tile splits into equal runs (within one
    item); a tile with no item keeps one run, which writes zeros. Runs
    are ordered longest first (launched first), ties by key tile and
    split."""
    G = Hq // Hkv
    kt_n = rt.key_tile
    n_kt = -(-T // kt_n)
    items = [G * len(query_tiles(kt, S, T, causal, window, kt_n,
                                 rt.query_tile))
             for kt in range(n_kt)]
    chunk = max(MIN_CHUNK,
                -(-B * Hkv * sum(items) // (WAVES * rt.ctas_per_sm * sms)))
    while True:
        runs, slots = [], 0
        for kt, n_it in enumerate(items):
            n = max(1, -(-n_it // chunk))
            runs += [(kt, s * n_it // n, (s + 1) * n_it // n, n, s,
                      slots if n > 1 else 0) for s in range(n)]
            slots += n if n > 1 else 0
        if len(runs) <= MAX_ENTRIES:
            break
        chunk *= 2
    runs.sort(key=lambda r: (r[1] - r[2], r[0], r[4]))
    return Plan(tuple(runs), slots, chunk, kt_n, rt.query_tile)


def owned(p: Plan, S: int, T: int, G: int, causal: bool, window: int):
    """(key tile, query head of the group, query tile) for every item of
    every run, as the kernel walks them: the coverage the tests check."""
    for kt, i0, i1, *_ in p.entries:
        tiles = query_tiles(kt, S, T, causal, window, p.key_tile,
                            p.query_tile)
        for i in range(i0, i1):
            yield kt, i // len(tiles), tiles[i % len(tiles)]


@functools.lru_cache(maxsize=64)
def _plan_on(device, B, Hq, Hkv, S, T, causal, window, rt):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = plan(B, Hq, Hkv, S, T, causal, window, sms, rt)
    rows = [list(r) + [0, 0] for r in p.entries]
    return p, torch.tensor(rows, dtype=torch.int32, device=device)


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).flash_attention_bwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, out, lse, dout):
    kernel._check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
        kernel.check_strided(name, t)
    B, Hq, S, _ = q.shape
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be (B, Hq, S) = {(B, Hq, S)} float32 "
                         f"contiguous on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        sliding_window: int = 0):
    """The gradient of ``kernel.flash_attention`` at (q, k, v): q / out /
    dout (B,Hq,S,hd), k/v (B,Hkv,T,hd) on one CUDA device, f32 or bf16
    alike; lse (B,Hq,S) f32 from the forward. Returns (dq, dk, dv),
    contiguous, in q.dtype; a row that saw no key gets 0 and adds 0. On
    meta tensors the op gives their shapes."""
    _check(q, k, v, out, lse, dout)
    return _op(q, k, v, out, lse, dout, bool(causal), int(sliding_window))


def _launch(q, k, v, out, lse, dout, causal, sliding_window):
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    dq, dk, dv = _fake(q, k, v)
    if B == 0 or Hq == 0 or S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rt = route(q.dtype, hd)
    p, rows = _plan_on(q.device, B, Hq, Hkv, S, T, causal, sliding_window,
                       rt)
    part, cnt = stream_scratch("flash_attention_bwd", q.device, stream, (
        (B * Hkv * p.n_slots * 2 * rt.key_tile * rt.hdp, torch.float32,
         False),
        (B * Hkv * -(-T // rt.key_tile), torch.int32, True)))
    strides = [s for t in (q, k, v, out, dout, dq, dk, dv)
               for s in t.stride()[:3]]
    vec = kernel.rows_aligned(q, k, v, out, dout, dq, dk, dv)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dsum.data_ptr(), rows.data_ptr(), part.data_ptr(),
                      cnt.data_ptr(), B, Hq, Hkv, S, T, hd, *strides,
                      int(causal), int(sliding_window), int(vec),
                      kernel.DTYPES[q.dtype], len(p.entries), p.n_slots,
                      stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t "
                           f"{err}")
    count_launch(flash_attention_bwd)
    return dq, dk, dv


def _fake(q, k, v, *_):
    return tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device)
                 for t in (q, k, v))


def _cost(q, k, v, out, lse, dout, causal, sliding_window):
    B, Hq, S, hd = q.shape
    return costs.flash_bwd(B, Hq, k.shape[1], S, k.shape[2], hd, q.dtype,
                           causal, sliding_window)


_op = kernel_op("flash_attention_bwd",
                "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
                "Tensor dout, bool causal, int sliding_window) -> "
                "(Tensor, Tensor, Tensor)", _launch, _fake, _cost)
flash_attention_bwd.launches = 0
