"""Binding of the CUDA decode-attention kernel (``csrc/decode.cu``, built
by ``kernels._build``, loaded with ``ctypes``).

``plan`` is the kernel's host-side plan, a function of shapes only (the
wrapper never reads ``n_valid`` on the host): the split of the stripe's
``[0, T)`` into KV splits (flash-decoding across CTAs), the query heads
of a CTA and the shared memory. The kernel reads q, k and v
through their element strides (head-dim stride 1), so the model's (B, T,
Hkv, hd) stripe, transposed to (B, Hkv, T, hd), is read in place. The
wrapper checks device, dtype, shape and strides, allocates ``out`` /
``lse`` with ``torch.empty`` and, when the plan has more than one split,
takes the f32 partials and the merge counters from a scratch kept per
device and stream; it launches on the current CUDA stream without
synchronising, and a launch CUDA refuses raises. The last split of a row
to finish merges the row inside the kernel, so a call is one launch:
``decode_attention.launches`` counts them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, refuse_grad, stream_scratch
from repro_torch.kernels.flash_attention.kernel import (check_strided,
                                                       rows_aligned)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode.cu"
MAX_HEAD_DIM = 256
MAX_WARPS = 8                    # warps per CTA, one query head each
MAX_GROUP = 32                   # query heads of a KV head
TILE = 64                        # positions per staged K / V tile
MAX_SPLITS = 32                  # longer stripes get splits of more tiles
SMEM_LIMIT = 227 * 1024          # dynamic shared memory a CTA may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C signature: q, k, v, n_valid, out, lse, part_o, part_lse,
# counters; B, Hq, Hkv, T, hd, 8 strides (q: batch, head; k, v: batch,
# head, position), window, vec, split_len, n_splits, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18 + [ctypes.c_void_p]


class Plan(NamedTuple):
    split_len: int     # positions per split, whole tiles
    n_splits: int      # splits of [0, T); > 1 needs the scratch
    heads: int         # query heads per CTA, a warp each
    groups: int        # CTAs per KV head and split (G over ``heads``)
    smem: int          # bytes of dynamic shared memory per CTA


def padded_head_dim(hd: int) -> int:
    """The kernel's head dim: hd rounded up to a multiple of 32."""
    return -(-hd // 32) * 32


def smem_bytes(heads: int, hd: int, itemsize: int) -> int:
    """A CTA's query rows of the padded head dim in f32 and as copied
    (the input's dtype), then a K and a V tile of TILE positions in the
    input's dtype, each row padded by one 16-byte chunk."""
    hdp = padded_head_dim(hd)
    return (4 + itemsize) * heads * hdp \
        + itemsize * 2 * TILE * (hdp + 16 // itemsize)


def heads_per_cta(G: int) -> int:
    """The G query heads of a KV head split evenly over ceil(G /
    MAX_WARPS) CTAs: all G in one CTA up to G = 8."""
    groups = -(-G // MAX_WARPS)
    return -(-G // groups)


def plan(B: int, Hq: int, Hkv: int, T: int, hd: int, itemsize: int) -> Plan:
    """The launch plan for one call, from shapes alone. Splits are whole
    64-position tiles: one tile each up to MAX_SPLITS tiles (T <= 2048),
    then as many tiles as keep the splits at MAX_SPLITS. Raises on a
    grid CUDA cannot launch."""
    G = Hq // Hkv
    tiles = -(-T // TILE)
    per_split = max(1, -(-tiles // MAX_SPLITS))
    split_len = TILE * per_split
    n_splits = max(1, -(-T // split_len))
    heads = heads_per_cta(G)
    if B > 65535:
        raise ValueError(f"B {B}: the grid takes at most 65535")
    return Plan(split_len, n_splits, heads, -(-G // heads),
                smem_bytes(heads, hd, itemsize))


def split_ranges(p: Plan, T: int) -> list[range]:
    """The stripe positions each split covers, in order."""
    return [range(s * p.split_len, min(s * p.split_len + p.split_len, T))
            for s in range(p.n_splits)]


def visible_splits(p: Plan, n: int, T: int, window: int = 0) -> range:
    """The splits that hold a position of a row's range ``[max(0, n -
    window), min(n, T))``: each one's CTA works (and writes a partial
    when there are several), the others exit at once."""
    hi = max(0, min(n, T))
    lo = max(0, n - window) if window > 0 else 0
    first = lo // p.split_len
    return range(first, (hi - 1) // p.split_len + 1 if hi > lo else first)


def _scratch(device, stream, B, Hq, ctas, hd, n_splits):
    """The f32 partials and the int32 merge counters, one per row and
    CTA of heads (``ctas`` = Hkv * groups), for a call
    (``kernels.stream_scratch``)."""
    return stream_scratch("decode_attention", device, stream, (
        (B * Hq * n_splits * hd, torch.float32, False),
        (B * Hq * n_splits, torch.float32, False),
        (B * ctas, torch.int32, True)))


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).decode_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, n_valid):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got q "
                         f"on {q.device}")
    for name, t in (("k", k), ("v", v), ("n_valid", n_valid)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: float32 or bfloat16 only")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k / v dtypes {k.dtype}/{v.dtype} != q dtype "
                         f"{q.dtype}")
    if n_valid.dtype != torch.int32 or not n_valid.is_contiguous():
        raise ValueError("n_valid must be a contiguous int32 tensor")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B,Hq,hd), "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"(B,Hkv,T,hd)")
    B, Hq, hd = q.shape
    Bk, Hkv, _, hd_kv = k.shape
    if Bk != B or hd_kv != hd or tuple(n_valid.shape) != (B,):
        raise ValueError(f"k / v {tuple(k.shape)}, n_valid "
                         f"{tuple(n_valid.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1..{MAX_HEAD_DIM}")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq {Hq} / Hkv {Hkv}: the group must be whole and "
                         f"at most {MAX_GROUP}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t)


def decode_attention(q, k, v, n_valid, *, sliding_window: int = 0):
    """The CUDA kernel. q (B,Hq,hd), k/v (B,Hkv,T,hd) on one CUDA device,
    f32 or bf16 alike, any strides with head-dim stride 1; n_valid (B,)
    int32. Row b attends to positions ``[max(0, n - window), min(n, T))``,
    ``n = n_valid[b]``. Returns (out (B,Hq,hd) in q.dtype, lse (B,Hq)
    f32)."""
    _check(q, k, v, n_valid)
    refuse_grad("decode_attention", q, k, v)
    B, Hq, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    if B == 0 or Hq == 0:
        return out, lse
    p = plan(B, Hq, Hkv, T, hd, q.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = (None, None, None)
    if p.n_splits > 1:
        part = tuple(t.data_ptr() for t in _scratch(
            q.device, stream, B, Hq, Hkv * p.groups, hd, p.n_splits))
    strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3]]
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      n_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      *part, B, Hq, Hkv, T, hd, *strides,
                      int(sliding_window), int(rows_aligned(q, k, v)),
                      p.split_len, p.n_splits, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError_t "
                           f"{err}")
    decode_attention.launches += 1
    return out, lse


decode_attention.launches = 0
