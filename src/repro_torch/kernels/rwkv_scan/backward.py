"""Binding of the CUDA WKV6 backward kernel (``csrc/wkv_bwd.cu``, built
by ``kernels._build``, loaded with ``ctypes``).

The kernel owns its launch geometry: a CTA holds 16 rows of one (b, h)'s
state and all of its columns, and time runs in 16-step chunks. Its
scratch (the state at every chunk's start, the row blocks' dv partials
and the (b, h) du partials, which a second launch adds in a fixed order)
is sized by the source's own ``wkv_bwd_scratch``. The wrapper checks
device, dtype, shape and contiguity, allocates the gradients with
``torch.empty``, and launches on the current CUDA stream without
synchronising; a shape the kernel does not take, or a launch CUDA
refuses, raises. ``wkv_bwd.launches`` counts successful calls (two
device launches each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, stream_scratch
from repro_torch.kernels.rwkv_scan import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv_bwd.cu"
# the C signature: r, k, v, w, u, state, dout, dstate_out, dr, dk, dv,
# dw, du, dstate, ck, dvpart, dupart; B, T, H, hd; stream
ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# wkv_bwd_scratch: B, T, H, hd; the three sizes (long long[3])
SCRATCH_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    for fn, argtypes in ((lib.wkv_bwd, ARGTYPES),
                         (lib.wkv_bwd_scratch, SCRATCH_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _scratch_sizes(B, T, H, hd):
    sizes = (ctypes.c_longlong * 3)()
    if _library().wkv_bwd_scratch(B, T, H, hd, sizes):
        raise ValueError(f"wkv_bwd takes no (B, T, H, hd) = "
                         f"{(B, T, H, hd)}")
    return tuple(sizes)


def wkv_bwd(r, k, v, w, u, state, dout, dstate_out):
    """The CUDA backward of ``kernel.wkv_scan``: r/k/v/w/dout (B,T,H,hd),
    u (H,hd), state/dstate_out (B,H,hd,hd), contiguous float32 on one
    CUDA device (dout and dstate_out the gradients of out and the final
    state). Returns (dr, dk, dv, dw, du, dstate), float32, as
    ``ref.wkv_bwd_ref`` computes them."""
    kernel._check(r, k, v, w, u, state)
    for name, t, like in (("dout", dout, r), ("dstate_out", dstate_out,
                                              state)):
        if t.shape != like.shape or t.dtype != torch.float32 \
                or t.device != r.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(like.shape)} on {r.device}")
    B, T, H, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    if B == 0 or T == 0:
        for t in (dr, dk, dv, dw):
            t.zero_()
        return dr, dk, dv, dw, torch.zeros_like(u), dstate_out.clone()
    sizes = _scratch_sizes(B, T, H, hd)
    du, dstate = torch.empty_like(u), torch.empty_like(state)
    stream = torch.cuda.current_stream(r.device)
    ck, dvpart, dupart = stream_scratch(
        "wkv_bwd", r.device, stream.cuda_stream,
        tuple((n, torch.float32, False) for n in sizes))
    err = _library().wkv_bwd(*(t.data_ptr() for t in (
        r, k, v, w, u, state, dout, dstate_out, dr, dk, dv, dw, du, dstate,
        ck, dvpart, dupart)), B, T, H, hd, stream.cuda_stream)
    if err:
        raise RuntimeError(f"wkv_bwd launch failed: cudaError_t {err}")
    wkv_bwd.launches += 1
    return dr, dk, dv, dw, du, dstate


wkv_bwd.launches = 0
