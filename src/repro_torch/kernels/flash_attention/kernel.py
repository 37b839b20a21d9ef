"""Binding of the CUDA flash-attention kernel (``csrc/flash.cu``, built
by ``kernels._build``, loaded with ``ctypes``).

The kernel reads q, k and v through their element strides (head-dim
stride 1), so (B, S, H, hd) views transposed to (B, H, S, hd) need no
copy. The wrapper checks device, dtype, shape and strides, allocates
``out`` with ``torch.empty_like(q)`` (q's stride order) and, when asked
(the autograd route of ``ops``), the rows' log-sum-exp (B, Hq, S) f32
for the backward kernel (``backward.py``), and launches on the current
CUDA stream without synchronising; a launch CUDA refuses raises.
``flash_attention.launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# the C signature: q, k, v, out, lse (or null); B, Hq, Hkv, S, T, hd, 12
# strides (q, k, v, out: batch, head, position), causal, window, vec,
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 22 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).flash_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build and load the library now, not at the first launch (a caller
    whose first launch may come from a worker thread)."""
    _launcher()


def check_strided(name, t):
    """The kernels take any strides but the last, which must be 1, and
    index in 32-bit elements."""
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name} needs head-dim stride 1, has strides "
                         f"{tuple(t.stride())}")
    span = sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    if span > _INT_MAX:
        raise ValueError(f"{name} spans {span} elements: more than the "
                         f"kernel's 32-bit strides address")


def rows_aligned(*tensors) -> bool:
    """Every row (head-dim run) of every tensor starts 16-byte aligned and
    fills whole 16-byte loads: the kernels' 16-byte staging path
    (``cp.async`` in the bf16 tensor-core flash kernel, 16-byte loads in
    the f32 flash and the decode kernels); else they stage element by
    element."""
    for t in tensors:
        es = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * es) % 16 \
                or any((s * es) % 16 for s in t.stride()[:-1]):
            return False
    return True


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got q "
                         f"on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q dtype {q.dtype}: float32 or bfloat16 only")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k / v dtypes {k.dtype}/{v.dtype} != q dtype "
                         f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} must be (B,Hq,S,hd), "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"(B,Hkv,T,hd)")
    B, Hq, _, hd = q.shape
    Bk, Hkv, _, hd_kv = k.shape
    if Bk != B or hd_kv != hd:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1..{MAX_HEAD_DIM}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    with_lse: bool = False):
    """The CUDA kernel. q (B,Hq,S,hd), k/v (B,Hkv,T,hd) on one CUDA
    device, f32 or bf16 alike, any strides with head-dim stride 1. Query
    i sits at absolute position ``T - S + i``. Returns out (B,Hq,S,hd) in
    q.dtype, with ``with_lse`` (out, lse (B,Hq,S) f32; -inf for a row
    that sees no key). A call autograd would record raises: the
    differentiable route is ``ops.FlashAttention``."""
    _check(q, k, v)
    refuse_grad("flash_attention", q, k, v)
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if B == 0 or S == 0 or Hq == 0 or T == 0:
        if T == 0:
            out.zero_()
            if lse is not None:
                lse.fill_(float("-inf"))
        return (out, lse) if with_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      B, Hq, Hkv, S, T, hd, *strides, int(bool(causal)),
                      int(sliding_window), int(rows_aligned(q, k, v)),
                      DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t "
                           f"{err}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0
