"""Binding of the CUDA WKV6 backward kernel (``csrc/wkv_bwd.cu``, built by
``kernels._build``, loaded with ``ctypes``).

The kernel owns its launch geometry (``geometry`` mirrors it for the
tests): a lane holds two rows of a (b, h)'s state and 4 of its columns,
a CTA ``rows`` rows, and a head's ``cluster`` CTAs run as one
thread-block cluster that adds dv's row-block partials on chip. It walks
back over the 8-step chunks from the checkpoints that
``kernel.wkv_scan(..., checkpoints=True)`` wrote. Its scratch (the (b,
h) du partials, which a second launch adds over b in a fixed order) is
sized by the source's own ``wkv_bwd_scratch``. The wrapper checks
device, dtype, shape and contiguity, allocates the gradients with
``torch.empty``, and launches on the current CUDA stream without
synchronising; a shape the kernel does not take, or a launch CUDA
refuses, raises. ``wkv_bwd.launches`` counts successful calls (two
device launches each).
The launch is the CUDA implementation of the op
``repro_torch::wkv_bwd`` (``kernels.kernel_op``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import (_build, costs, count_launch, kernel_op,
                                 stream_scratch)
from repro_torch.kernels.flash_attention.kernel import rows_aligned
from repro_torch.kernels.rwkv_scan import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv_bwd.cu"
MAX_CLUSTER = 8                # CTAs a portable cluster may hold
# the C signature: r, k, v, w, u, state, ck, dout, dstate_out, dr, dk,
# dv, dw, du, dstate, dupart; B, T, H, hd, vec; stream
ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# wkv_bwd_scratch: B, T, H, hd; the size (long long[1])
SCRATCH_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


class Geometry(NamedTuple):
    rows: int          # rows of a (b, h)'s state a CTA holds
    threads: int       # per CTA: ``threads // rows`` lanes a row
    cluster: int       # a head's CTAs, one cluster


def geometry(hd: int) -> Geometry:
    """The kernel's geometry at head dim hd, from the shape alone (as
    ``wkv_bwd_geometry`` in the source gives it): a lane holds two rows
    and 4 columns; up to hd 64 a CTA holds 32 rows (128 threads at hd
    padded to 32, 256 at 64), above 16 rows (256 threads); a head's CTAs
    one cluster (1 / 2 / 2 / 8 at hd 32 / 40 / 64 / 128). Raises on a head
    dim the kernel does not take."""
    if not 1 <= hd <= kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes "
                         f"1..{kernel.MAX_HEAD_DIM}")
    hdp = kernel.padded_head_dim(hd)
    rows = 32 if hd <= 64 else 16
    return Geometry(rows, rows // 2 * (hdp // 4), -(-hd // rows))


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    for fn, argtypes in (
            (lib.wkv_bwd, ARGTYPES),
            (lib.wkv_bwd_scratch, SCRATCH_ARGTYPES),
            (lib.wkv_bwd_geometry, [ctypes.c_int, ctypes.c_void_p]),
            (lib.wkv_bwd_max_clusters,
             [ctypes.c_int] * 4 + [ctypes.c_void_p])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _scratch_sizes(B, T, H, hd):
    sizes = (ctypes.c_longlong * 1)()
    if _library().wkv_bwd_scratch(B, T, H, hd, sizes):
        raise ValueError(f"wkv_bwd takes no (B, T, H, hd) = "
                         f"{(B, T, H, hd)}")
    return tuple(sizes)


def source_geometry(hd: int) -> tuple:
    """(rows, threads, shared bytes, cluster) as the source gives them."""
    geo = (ctypes.c_int * 4)()
    if _library().wkv_bwd_geometry(hd, geo):
        raise ValueError(f"wkv_bwd takes no head dim {hd}")
    return tuple(geo)


def max_active_clusters(B, T, H, hd) -> int:
    """The clusters of this shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int()
    err = _library().wkv_bwd_max_clusters(B, T, H, hd, ctypes.byref(n))
    if err:
        raise RuntimeError(f"wkv_bwd_max_clusters: cudaError_t {err}")
    return n.value


def wkv_bwd(r, k, v, w, u, state, ck, dout, dstate_out):
    """The CUDA backward of ``kernel.wkv_scan``: r/k/v/w/dout (B,T,H,hd),
    u (H,hd), state/dstate_out (B,H,hd,hd), ck (B, H,
    ``kernel.checkpoint_count(T)``, hd, hd) the checkpoints the forward
    wrote for these inputs, contiguous float32 on one CUDA device (dout
    and dstate_out the gradients of out and the final state). Returns
    (dr, dk, dv, dw, du, dstate), float32, as ``ref.wkv_bwd_ref``
    computes them. On meta tensors the op gives their shapes."""
    kernel._check(r, k, v, w, u, state)
    B, T, H, hd = r.shape
    for name, t, shape in (
            ("dout", dout, r.shape), ("dstate_out", dstate_out, state.shape),
            ("ck", ck, (B, H, kernel.checkpoint_count(T), hd, hd))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
                or t.device != r.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} on {r.device}")
    return _op(r, k, v, w, u, state, ck, dout, dstate_out)


def _launch(r, k, v, w, u, state, ck, dout, dstate_out):
    B, T, H, hd = r.shape
    dr, dk, dv, dw, du, dstate = _fake(r, k, v, w, u, state)
    if B == 0 or T == 0:
        for t in (dr, dk, dv, dw):
            t.zero_()
        return dr, dk, dv, dw, du.zero_(), dstate_out.clone()
    sizes = _scratch_sizes(B, T, H, hd)
    stream = torch.cuda.current_stream(r.device)
    (dupart,) = stream_scratch(
        "wkv_bwd", r.device, stream.cuda_stream,
        tuple((n, torch.float32, False) for n in sizes))
    vec = rows_aligned(r, k, v, w, dout, *((ck,) if ck.numel() else ()))
    err = _library().wkv_bwd(
        *(t.data_ptr() for t in (r, k, v, w, u, state)),
        ck.data_ptr() if ck.numel() else None,
        *(t.data_ptr() for t in (dout, dstate_out, dr, dk, dv, dw, du,
                                 dstate, dupart)),
        B, T, H, hd, int(vec), stream.cuda_stream)
    if err:
        raise RuntimeError(f"wkv_bwd launch failed: cudaError_t {err}")
    count_launch(wkv_bwd)
    return dr, dk, dv, dw, du, dstate


def _fake(r, k, v, w, u, state, *_):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u),
            torch.empty_like(state))


def _cost(r, *_):
    return costs.wkv_bwd(*r.shape)


_op = kernel_op("wkv_bwd",
                "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
                "Tensor state, Tensor ck, Tensor dout, Tensor dstate_out) -> "
                "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
                _launch, _fake, _cost)
wkv_bwd.launches = 0
