"""Binding of the CUDA selective-scan backward kernel
(``csrc/ssm_scan_bwd.cu``, built by ``kernels._build``, loaded with
``ctypes``).

The kernel owns its launch geometry (``geometry`` mirrors it for the
tests): the forward's lane layout, two state entries a lane (one at N
1), a channel's entries over ``lanes`` lanes, a CTA of 128 threads over
``channels`` consecutive channels of one batch row, and ``cluster``
consecutive CTAs a thread-block cluster that adds its dB / dC partials
on chip (the channel blocks padded to a multiple of it). It walks back
over the 8-step chunks from the checkpoints that ``kernel.ssm_scan(...,
checkpoints=True)`` wrote. Its scratch (the clusters' dB and dC
partials, the batch rows' dA and dD partials, which a second launch adds
in a fixed order) is sized by the source's own ``ssm_scan_bwd_scratch``.
The wrapper checks device, dtype, shape and contiguity, allocates the
gradients with ``torch.empty``, and launches on the current CUDA stream
without synchronising; a shape the kernel does not take, or a launch
CUDA refuses, raises. ``ssm_scan_bwd.launches`` counts successful calls
(two device launches each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, stream_scratch
from repro_torch.kernels.flash_attention.kernel import rows_aligned
from repro_torch.kernels.ssm_scan import kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan_bwd.cu"
THREADS = 128
MAX_CLUSTER = 8                # channel blocks whose dB / dC add on chip
# the C signature: u, dt, Bm, Cm, A, D, state, ck, dy, dstate_out, du,
# ddt, dB, dC, dA, dD, dstate, partB, partC, dApart, dDpart; B, T, di, N,
# vec; stream
ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# ssm_scan_bwd_scratch (and _geometry, _max_clusters): B, T, di, N; the
# four sizes (long long[4])
SCRATCH_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


class Geometry(NamedTuple):
    lanes: int         # lanes of a channel
    channels: int      # channels of a CTA
    cluster: int       # CTAs of a cluster
    clusters: int      # clusters of a batch row (the grid's x / cluster)


def geometry(di: int, N: int) -> Geometry:
    """The kernel's geometry, from the shape alone (as
    ``ssm_scan_bwd_geometry`` in the source gives it). Raises on a shape
    the kernel does not take."""
    if not 1 <= N <= kernel.MAX_STATE or di < 1:
        raise ValueError(f"d_inner {di}, state size {N}: the kernel takes "
                         f"N 1..{kernel.MAX_STATE}, d_inner >= 1")
    lanes = 1 if N <= 2 else min(1 << (-(-N // 2) - 1).bit_length(), 32)
    channels = THREADS // lanes
    blocks = -(-di // channels)
    cluster = min(blocks, MAX_CLUSTER)
    return Geometry(lanes, channels, cluster, -(-blocks // cluster))


@functools.cache
def _library():
    lib = _build.load(SOURCE)
    for fn, argtypes in ((lib.ssm_scan_bwd, ARGTYPES),
                         (lib.ssm_scan_bwd_scratch, SCRATCH_ARGTYPES),
                         (lib.ssm_scan_bwd_geometry, SCRATCH_ARGTYPES),
                         (lib.ssm_scan_bwd_max_clusters,
                          SCRATCH_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _scratch_sizes(B, T, di, N):
    sizes = (ctypes.c_longlong * 4)()
    if _library().ssm_scan_bwd_scratch(B, T, di, N, sizes):
        raise ValueError(f"ssm_scan_bwd takes no (B, T, di, N) = "
                         f"{(B, T, di, N)}")
    return tuple(sizes)


def source_geometry(B, T, di, N) -> tuple:
    """(lanes, channels, shared bytes, cluster, clusters) as the source
    gives them."""
    geo = (ctypes.c_int * 5)()
    if _library().ssm_scan_bwd_geometry(B, T, di, N, geo):
        raise ValueError(f"ssm_scan_bwd takes no (B, T, di, N) = "
                         f"{(B, T, di, N)}")
    return tuple(geo)


def max_active_clusters(B, T, di, N) -> int:
    """The clusters of this shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int()
    err = _library().ssm_scan_bwd_max_clusters(B, T, di, N, ctypes.byref(n))
    if err:
        raise RuntimeError(f"ssm_scan_bwd_max_clusters: cudaError_t {err}")
    return n.value


def ssm_scan_bwd(u, dt, Bm, Cm, A, D, state, ck, dy, dstate_out):
    """The CUDA backward of ``kernel.ssm_scan``: u/dt/dy (B,T,di), Bm/Cm
    (B,T,N), A (di,N), D (di,), state/dstate_out (B,di,N), ck (B,
    ``kernel.checkpoint_count(T)``, di, N) the checkpoints the forward
    wrote for these inputs, contiguous float32 on one CUDA device (dy and
    dstate_out the gradients of y and the final state). Returns (du, ddt,
    dB, dC, dA, dD, dstate), float32, as ``ref.ssm_scan_bwd_ref``
    computes them."""
    kernel._check(u, dt, Bm, Cm, A, D, state)
    B, T, di = u.shape
    N = Bm.shape[-1]
    for name, t, shape in (
            ("dy", dy, u.shape), ("dstate_out", dstate_out, state.shape),
            ("ck", ck, (B, kernel.checkpoint_count(T), di, N))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
                or t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} on {u.device}")
    grads = [torch.empty_like(t) for t in (u, dt, Bm, Cm, A, D)]
    if B == 0 or T == 0 or di == 0:
        for t in grads:
            t.zero_()
        return (*grads, dstate_out.clone())
    sizes = _scratch_sizes(B, T, di, N)
    dstate = torch.empty_like(state)
    stream = torch.cuda.current_stream(u.device)
    partB, partC, dApart, dDpart = stream_scratch(
        "ssm_scan_bwd", u.device, stream.cuda_stream,
        tuple((n, torch.float32, False) for n in sizes))
    vec = rows_aligned(u, dt, dy, Bm, Cm, state,
                       *((ck,) if ck.numel() else ()))
    err = _library().ssm_scan_bwd(
        *(t.data_ptr() for t in (u, dt, Bm, Cm, A, D, state)),
        ck.data_ptr() if ck.numel() else None,
        *(t.data_ptr() for t in (dy, dstate_out, *grads, dstate, partB,
                                 partC, dApart, dDpart)),
        B, T, di, N, int(vec), stream.cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd launch failed: cudaError_t {err}")
    ssm_scan_bwd.launches += 1
    return (*grads, dstate)


ssm_scan_bwd.launches = 0
