"""Binding of the CUDA flash-attention backward kernel
(``csrc/flash_bwd.cu``, built by ``kernels._build``, loaded with
``ctypes``): tensor cores for bf16 at hd <= 128, CUDA cores otherwise.

The kernel reads q, k, v, out and dout through their element strides
(head-dim stride 1) and writes dq, dk, dv, allocated here contiguous in
the inputs' dtype; lse is the forward's (B, Hq, S) f32 log-sum-exp. It
launches twice on the current CUDA stream (dQ, which also writes the
row sums D = rowsum(dO * O) to a scratch, then dK / dV) without
synchronising; a launch CUDA refuses raises.
``flash_attention_bwd.launches`` counts successful calls.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"
# the C signature: q, k, v, out, lse, dout, dq, dk, dv, dsum; B, Hq, Hkv,
# S, T, hd, 24 strides (q, k, v, out, dout, dq, dk, dv: batch, head,
# position), causal, window, vec, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 34 + [ctypes.c_void_p]


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
    contiguous, in q.dtype; a row that saw no key gets 0 and adds 0."""
    _check(q, k, v, out, lse, dout)
    B, Hq, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    if B == 0 or Hq == 0 or S == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out, dout, dq, dk, dv)
               for s in t.stride()[:3]]
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dsum.data_ptr(), B, Hq, Hkv, S, T, hd, *strides,
                      int(bool(causal)), int(sliding_window),
                      int(kernel.rows_aligned(q, k, v, dout)),
                      kernel.DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
