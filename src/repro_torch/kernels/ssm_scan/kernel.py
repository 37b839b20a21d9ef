"""Binding of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``,
built by ``kernels._build``, loaded with ``ctypes``).

The kernel lays each channel's N state entries over a group of lanes,
two entries a lane (the next power of two >= N / 2 lanes, at most 32).
The wrapper checks device, dtype, shape and contiguity, allocates ``y``
/ the final state with ``torch.empty``, and launches on the current CUDA
stream without synchronising; a launch CUDA refuses raises.
``ssm_scan.launches`` counts successful launches.

With ``checkpoints=True`` (the training forward of
``ops.SelectiveScan``) the kernel's checkpoint instantiation also writes
the state after every 8th step short of the last,
``checkpoint_count(T)`` states of (di, N) a batch row, which
``backward.ssm_scan_bwd`` walks back from; the serving call (the
default) writes nothing more.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 64                 # h of a channel lives in 32 lanes' registers
CHECKPOINT_STEPS = 8           # the training forward's checkpoint interval
# the C signature: u, dt, Bm, Cm, A, D, state, y, state_out, ck; B, T,
# di, N; stream
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def checkpoint_count(T: int) -> int:
    """The states the training forward writes for T steps: h_{8 c} for
    c = 1 .. ceil(T / 8) - 1 (none at T <= 8)."""
    return max(T - 1, 0) // CHECKPOINT_STEPS


@functools.cache
def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.ssm_scan
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    lib.ssm_scan_checkpoints.argtypes = [ctypes.c_int]
    lib.ssm_scan_checkpoints.restype = ctypes.c_int
    if any(lib.ssm_scan_checkpoints(T) != checkpoint_count(T)
           for T in (1, 8, 9, 17, 1024)):
        raise RuntimeError("ssm_scan.cu's checkpoint interval is not "
                           "CHECKPOINT_STEPS")
    return fn


def _check(u, dt, Bm, Cm, A, D, state):
    named = (("u", u), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A),
             ("D", D), ("state", state))
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan kernel needs CUDA tensors, got u on "
                         f"{u.device}")
    for name, t in named:
        if t.device != u.device:
            raise ValueError(f"{name} on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype}: float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.dim() != 3 or dt.shape != u.shape or Bm.dim() != 3 \
            or Cm.shape != Bm.shape or Bm.shape[:2] != u.shape[:2]:
        raise ValueError(f"u/dt {tuple(u.shape)}, {tuple(dt.shape)} must be "
                         f"(B, T, di); Bm/Cm {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)} (B, T, N)")
    B, _, di = u.shape
    N = Bm.shape[-1]
    if tuple(A.shape) != (di, N) or tuple(D.shape) != (di,) \
            or tuple(state.shape) != (B, di, N):
        raise ValueError(f"A {tuple(A.shape)} / D {tuple(D.shape)} / state "
                         f"{tuple(state.shape)} for di={di}, N={N}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N}: the kernel takes 1..{MAX_STATE}")
    if B > 65535:
        raise ValueError(f"B {B}: the grid takes at most 65535")


def ssm_scan(u, dt, Bm, Cm, A, D, state, *, checkpoints: bool = False):
    """The CUDA kernel. u/dt (B,T,di), Bm/Cm (B,T,N), A (di,N), D (di,),
    state (B,di,N): contiguous float32 on one CUDA device. Returns
    (y (B,T,di), final state (B,di,N)), both float32, and with
    ``checkpoints`` the states after every 8th step short of the last,
    (B, checkpoint_count(T), di, N) float32."""
    _check(u, dt, Bm, Cm, A, D, state)
    refuse_grad("ssm_scan", u, dt, Bm, Cm, A, D, state)
    B, T, di = u.shape
    N = Bm.shape[-1]
    y = torch.empty_like(u)
    ck = (u.new_empty((B, checkpoint_count(T), di, N)) if checkpoints
          else None)
    if B == 0 or T == 0 or di == 0:
        return (y, state.clone()) + ((ck,) if checkpoints else ())
    state_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _launcher()(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                      Cm.data_ptr(), A.data_ptr(), D.data_ptr(),
                      state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
                      ck.data_ptr() if ck is not None and ck.numel() else None,
                      B, T, di, N, stream)
    if err:
        raise RuntimeError(f"ssm_scan launch failed: cudaError_t {err}")
    ssm_scan.launches += 1
    return (y, state_out) + ((ck,) if checkpoints else ())


ssm_scan.launches = 0
