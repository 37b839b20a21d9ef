"""The work of each hand-written kernel: FLOPs and the bytes it must move.

One source for every reader: ``chip_smoke.py``'s ``bound_ms`` column,
the FLOP formulas of the kernels' ``torch.library`` ops (registered with
``torch.utils.flop_counter``) and ``launch/step_analysis.py``, which
counts a kernel launch as one op of these costs. Each function takes
shapes (and, where the work depends on the data, the counts this call's
data needs) and returns ``(flops, nbytes)``: ``nbytes`` reads each input
once and writes each output once; ``flops`` counts the operations of the
function the kernel computes, not those of the kernel's own schedule
(the scan backwards' second forward pass, a split's merge). The
costs hold no hardware: ``chip_smoke.py``'s ``bound_ms`` and
``launch/roofline.py`` divide them by the card's rates.
"""
from __future__ import annotations

import torch


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def visible(n: int, window: int = 0, cap: int | None = None) -> int:
    """Keys a query sees when ``n`` keys end at it (itself included),
    within a sliding ``window`` and a capacity ``cap``."""
    hi = n if cap is None else min(n, cap)
    lo = max(n - window, 0) if window else 0
    return max(hi - lo, 0)


def visible_pairs(S: int, T: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the masks let through, per head: query i sits
    at absolute position T - S + i. Closed form, exact."""
    if not causal:
        if not window:
            return S * T
        return sum(T - max(0, T - S + i - window + 1) for i in range(S))
    first, last = T - S + 1, T            # keys seen by the first / last
    if not window or window >= last:
        return (first + last) * S // 2
    if window <= first:
        return window * S
    ramp = window - first                  # queries before the window caps
    return (first + window - 1) * ramp // 2 + window * (S - ramp)


def flash(B, Hq, Hkv, S, T, hd, dtype, causal=True, window=0,
          with_lse=False):
    """The flash forward: q, k, v read once, out (and the LSE) written
    once; 4 * hd flops per (query head, key) pair, the pairs of a causal
    call without a window taken as S * T / 2."""
    es = _itemsize(dtype)
    nbytes = es * B * hd * (2 * S * Hq + 2 * T * Hkv)
    if with_lse:
        nbytes += 4 * B * Hq * S
    pairs = S * T / 2 if causal and not window \
        else visible_pairs(S, T, causal, window)
    return 4 * B * Hq * hd * pairs, nbytes


def flash_bwd(B, Hq, Hkv, S, T, hd, dtype, causal=True, window=0):
    """q, k, v, out and dout read once, lse read once, dq, dk and dv
    written once; 10 * hd flops per (query head, visible pair): the
    recomputed scores, dP, dV, dQ and dK products."""
    es = _itemsize(dtype)
    nbytes = es * B * hd * (4 * S * Hq + 4 * T * Hkv) + 4 * B * Hq * S
    return 10 * hd * B * Hq * visible_pairs(S, T, causal, window), nbytes


def decode(lens, Hq, Hkv, hd, dtype):
    """Stripe decode: the valid K/V of every row (``lens``: the keys each
    row sees) read once, q and the lengths read once, out and lse
    written once; 4 * hd flops per (query head, valid position)."""
    es = _itemsize(dtype)
    n = sum(lens)
    nbytes = (n * Hkv * hd * 2 * es + len(lens) * Hq * hd * 2 * es
              + len(lens) * (Hq + 1) * 4)
    return 4 * hd * Hq * n, nbytes


def paged_window(bases, S, Hq, Hkv, hd, dtype, bs, max_blocks, window=0):
    """A window of S queries a row over the paged pool (``bases``: the
    tokens each row holds before its window): the K/V of every position
    the row's window sees read once, q read once, out and lse written
    once, the block table and bases read once; 4 * hd flops per (query
    head, visible key)."""
    es = _itemsize(dtype)
    cap = max_blocks * bs
    B = len(bases)
    seen = [min(b + S, cap) - (max(0, b + 1 - window) if window else 0)
            for b in bases]
    kv_bytes = sum(seen) * Hkv * hd * 2 * es
    q_numel = B * S * Hq * hd
    io_bytes = 2 * q_numel * es + B * S * Hq * 4 + B * (max_blocks + 1) * 4
    pairs = sum(visible(b + w + 1, window, cap) for b in bases
                for w in range(S)) * Hq
    return 4 * hd * pairs, kv_bytes + io_bytes


def wkv(B, T, H, hd, checkpoints=False):
    """r, k, v, w and u read once, out written once, the state read and
    written once (and the checkpoints written), f32; 7 flops per state
    entry per step (k v product, bonus, r dot, decay FMA)."""
    nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
    if checkpoints:
        nbytes += 4 * B * H * (max(T - 1, 0) // 8) * hd * hd
    return 7 * B * T * H * hd * hd, nbytes


def ssm(B, T, di, N, checkpoints=False):
    """u, dt, B, C, A and D read once, y written once, the state read and
    written once (and the checkpoints written), f32; 7 operations per
    state entry per step (dt A, exp, decay, input FMA, C dot) and 2 per
    channel (dt u, D u)."""
    nbytes = 4 * (3 * B * T * di + 2 * B * T * N + di * N + di
                  + 2 * B * di * N)
    if checkpoints:
        nbytes += 4 * B * (max(T - 1, 0) // 8) * di * N
    return 7 * B * T * di * N + 2 * B * T * di, nbytes


def wkv_bwd(B, T, H, hd):
    """r, k, v, w, dout and u read once, dr, dk, dv, dw and du written
    once, the state and the final state's gradient read and dstate
    written once, f32; 14 flops per state entry per step: the forward
    once, for S_{t-1} (k v and the decay FMA, 3), dr, dk, dw and dv (an
    FMA each, 8) and the dS update (r dout and an FMA, 3)."""
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd + 3 * B * H * hd * hd)
    return 14 * B * T * H * hd * hd, nbytes


def ssm_bwd(B, T, di, N):
    """u, dt, dy, B, C, A and D read once, du, ddt, dB, dC, dA and dD
    written once, the state and the final state's gradient read and
    dstate written once, f32; 23 operations per state entry per step: the
    forward once, for h_{t-1} (5), the carry of the state's gradient (3),
    dC, dB and du (6), ddt (6) and dA (3)."""
    nbytes = 4 * (5 * B * T * di + 4 * B * T * N + 4 * di * N + 4 * di
                  + 3 * B * di * N)
    return 23 * B * T * di * N, nbytes


def moe_decode_bytes(cfg) -> int:
    """The bytes of every expert's weights of one MoE layer: a decode
    step's batch (B 8 at top-2) reaches every expert, so its FFN reads
    them all once."""
    nmat = 3 if cfg.act in ("swiglu", "geglu") else 2
    return cfg.n_experts * nmat * cfg.d_model * cfg.moe_d_ff \
        * _itemsize(cfg.dtype)
