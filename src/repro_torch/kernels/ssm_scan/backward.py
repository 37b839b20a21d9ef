"""Binding of the CUDA selective-scan backward kernel
(``csrc/ssm_scan_bwd.cu``, built by ``kernels._build``, loaded with
``ctypes``).

The kernel owns its launch geometry, the forward's lane layout: a
channel's N state entries over a power of two of lanes, a CTA over
consecutive channels of one batch row, a ragged channel tail, time in
16-step chunks. Its scratch (the state at every chunk's start, the
channel blocks' dB and dC partials, the batch rows' dA and dD partials,
which a second launch adds in a fixed order) is sized by the source's
own ``ssm_scan_bwd_scratch``. The wrapper checks device, dtype, shape
and contiguity, allocates the gradients with ``torch.empty``, and
launches on the current CUDA stream without synchronising; a shape the
kernel does not take, or a launch CUDA refuses, raises.
``ssm_scan_bwd.launches`` counts successful calls (two device launches
each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, stream_scratch
from repro_torch.kernels.ssm_scan import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan_bwd.cu"
# the C signature: u, dt, Bm, Cm, A, D, state, dy, dstate_out, du, ddt,
# dB, dC, dA, dD, dstate, ck, partB, partC, dApart, dDpart; B, T, di, N;
# stream
ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# ssm_scan_bwd_scratch: B, T, di, N; the five sizes (long long[5])
SCRATCH_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    for fn, argtypes in ((lib.ssm_scan_bwd, ARGTYPES),
                         (lib.ssm_scan_bwd_scratch, SCRATCH_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _scratch_sizes(B, T, di, N):
    sizes = (ctypes.c_longlong * 5)()
    if _library().ssm_scan_bwd_scratch(B, T, di, N, sizes):
        raise ValueError(f"ssm_scan_bwd takes no (B, T, di, N) = "
                         f"{(B, T, di, N)}")
    return tuple(sizes)


def ssm_scan_bwd(u, dt, Bm, Cm, A, D, state, dy, dstate_out):
    """The CUDA backward of ``kernel.ssm_scan``: u/dt/dy (B,T,di), Bm/Cm
    (B,T,N), A (di,N), D (di,), state/dstate_out (B,di,N), contiguous
    float32 on one CUDA device (dy and dstate_out the gradients of y and
    the final state). Returns (du, ddt, dB, dC, dA, dD, dstate), float32,
    as ``ref.ssm_scan_bwd_ref`` computes them."""
    kernel._check(u, dt, Bm, Cm, A, D, state)
    for name, t, like in (("dy", dy, u), ("dstate_out", dstate_out, state)):
        if t.shape != like.shape or t.dtype != torch.float32 \
                or t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(like.shape)} on {u.device}")
    B, T, di = u.shape
    N = Bm.shape[-1]
    grads = [torch.empty_like(t) for t in (u, dt, Bm, Cm, A, D)]
    if B == 0 or T == 0 or di == 0:
        for t in grads:
            t.zero_()
        return (*grads, dstate_out.clone())
    sizes = _scratch_sizes(B, T, di, N)
    dstate = torch.empty_like(state)
    stream = torch.cuda.current_stream(u.device)
    ck, partB, partC, dApart, dDpart = stream_scratch(
        "ssm_scan_bwd", u.device, stream.cuda_stream,
        tuple((n, torch.float32, False) for n in sizes))
    err = _library().ssm_scan_bwd(*(t.data_ptr() for t in (
        u, dt, Bm, Cm, A, D, state, dy, dstate_out, *grads, dstate, ck,
        partB, partC, dApart, dDpart)), B, T, di, N, stream.cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd launch failed: cudaError_t {err}")
    ssm_scan_bwd.launches += 1
    return (*grads, dstate)


ssm_scan_bwd.launches = 0
