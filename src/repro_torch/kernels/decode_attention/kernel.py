"""Binding of the CUDA decode-attention kernel (``csrc/decode.cu``, built
by ``kernels._build``, loaded with ``ctypes``).

The kernel reads q, k and v through their element strides (head-dim
stride 1), so the model's (B, T, Hkv, hd) stripe, transposed to (B, Hkv,
T, hd), is read in place. The wrapper checks device, dtype, shape and
strides, allocates ``out`` / ``lse`` with ``torch.empty``, and launches
on the current CUDA stream without synchronising; a launch CUDA refuses
raises. ``decode_attention.launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (check_strided,
                                                       rows_aligned)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode.cu"
MAX_HEAD_DIM = 256
MAX_GROUP = 32                   # one warp per query head of a KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C signature: q, k, v, n_valid, out, lse; B, Hq, Hkv, T, hd, 8
# strides (q: batch, head; k, v: batch, head, position), window, vec,
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


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
    B, Hq, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    if B == 0 or Hq == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3]]
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      n_valid.data_ptr(), out.data_ptr(), lse.data_ptr(), B,
                      Hq, Hkv, T, hd, *strides, int(sliding_window),
                      int(rows_aligned(q, k, v)), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError_t "
                           f"{err}")
    decode_attention.launches += 1
    return out, lse


decode_attention.launches = 0
