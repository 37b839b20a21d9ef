"""Binding of the CUDA WKV6 kernel (``csrc/wkv.cu``, built by
``kernels._build``, loaded with ``ctypes``).

``plan`` is the kernel's launch plan, a function of shapes only (the
wrapper never reads a tensor's values): each pair of state columns
(b, h, j), (b, h, j + 1) gets ``lanes`` lanes, each holding ``rows``
consecutive rows of both (the head dim padded to 32, 64 or 128), a CTA
of ``threads`` covers ``columns`` consecutive columns of one (b, h), and
time is staged in chunks of ``chunk`` steps (one step at T 1, in one
stage; else 16, in a ring of two). The wrapper checks device, dtype,
shape and contiguity, allocates ``out`` / the final state with
``torch.empty``, and launches on the current CUDA stream without
synchronising; a launch CUDA refuses raises. ``wkv_scan.launches``
counts successful launches.

With ``checkpoints=True`` (the training forward of ``ops.WKV``) the
kernel's checkpoint instantiation also writes the state after every 8th
step short of the last, ``checkpoint_count(T)`` states of
(hd, hd) a (b, h), each transposed (S[i][j] at [..., j, i], so the
kernel's stores are whole 16-byte runs), which ``backward.wkv_bwd`` walks
back from; the serving call (the default) writes nothing more.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_attention.kernel import rows_aligned

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
MAX_HEAD_DIM = 128             # 32 lanes of 4 rows a column pair
THREADS = 128                  # per CTA
ROWS = 4                       # rows of a column a lane holds
PAIR = 2                       # columns a lane holds
CHUNK = 16                     # time steps a staged chunk above T 1
CHECKPOINT_STEPS = 8           # the training forward's checkpoint interval
# the C signature: r, k, v, w, u, state, out, state_out, ck; B, T, H, hd,
# lanes, chunk, vec; stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class Plan(NamedTuple):
    lanes: int         # L: lanes a column pair
    rows: int          # E: rows a lane holds; lanes * rows = padded hd
    columns: int       # CH: columns a CTA covers
    chunk: int         # TC: time steps a staged chunk
    stages: int        # chunks in the shared-memory ring
    grid: tuple        # (column blocks, H, B)
    threads: int       # per CTA
    smem: int          # bytes of dynamic shared memory per CTA


def padded_head_dim(hd: int) -> int:
    """The kernel's head dim: 32, 64 or 128, the least that holds hd."""
    return next(p for p in (32, 64, 128) if hd <= p)


def plan(B: int, T: int, H: int, hd: int) -> Plan:
    """The launch plan for one call, from shapes alone. Raises on a shape
    the kernel does not take."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1..{MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B {B}, H {H}: the grid takes at most 65535")
    hdp = padded_head_dim(hd)
    lanes = hdp // ROWS
    columns = PAIR * THREADS // lanes
    chunk, stages = (1, 1) if T == 1 else (CHUNK, 2)
    stage = 3 * chunk * hdp + chunk * columns          # r, k, w rows; v
    smem = 4 * (stages * stage + columns * (hdp + 4))  # + the state slice
    return Plan(lanes, ROWS, columns, chunk, stages,
                (-(-hd // columns), H, B), THREADS, smem)


def owned(p: Plan, hd: int, cta: tuple, thread: int) -> list[tuple]:
    """The state entries (b, h, i, j) that ``thread`` of CTA ``cta`` =
    (x, y, z) carries, as the kernel assigns them: columns j = x *
    columns + PAIR * (thread // lanes) + (0, 1), rows i = rows * (thread
    % lanes) + e; entries past hd are padding and carry nothing."""
    x, h, b = cta
    j0 = x * p.columns + PAIR * (thread // p.lanes)
    i0 = p.rows * (thread % p.lanes)
    return [(b, h, i, j) for j in range(j0, j0 + PAIR)
            for i in range(i0, i0 + p.rows) if i < hd and j < hd]


def checkpoint_count(T: int) -> int:
    """The states the training forward writes for T steps: S_{8 c} for
    c = 1 .. ceil(T / 8) - 1 (none at T <= 8)."""
    return max(T - 1, 0) // CHECKPOINT_STEPS


@functools.cache
def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.wkv_scan
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    lib.wkv_scan_checkpoints.argtypes = [ctypes.c_int]
    lib.wkv_scan_checkpoints.restype = ctypes.c_int
    if any(lib.wkv_scan_checkpoints(T) != checkpoint_count(T)
           for T in (1, 16, 17, 33, 1024)):
        raise RuntimeError("wkv.cu's checkpoint interval is not "
                           "CHECKPOINT_STEPS")
    return fn


def _check(r, k, v, w, u, state):
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state))
    if r.device.type != "cuda":
        raise ValueError(f"wkv kernel needs CUDA tensors, got r on "
                         f"{r.device}")
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype}: float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r/k/v/w shapes {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}: one (B, T, H, hd)")
    B, _, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)}"
                         f" for r {tuple(r.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1..{MAX_HEAD_DIM}")


def wkv_scan(r, k, v, w, u, state, *, checkpoints: bool = False):
    """The CUDA kernel. r/k/v/w (B,T,H,hd), u (H,hd), state (B,H,hd,hd):
    contiguous float32 on one CUDA device. Returns (out (B,T,H,hd),
    final state (B,H,hd,hd)), both float32, and with ``checkpoints`` the
    states after every 8th step short of the last, transposed, (B, H,
    checkpoint_count(T), hd, hd) float32."""
    _check(r, k, v, w, u, state)
    refuse_grad("wkv_scan", r, k, v, w, u, state)
    B, T, H, hd = r.shape
    out = torch.empty_like(r)
    ck = (r.new_empty((B, H, checkpoint_count(T), hd, hd)) if checkpoints
          else None)
    if B == 0 or T == 0:
        return (out, state.clone()) + ((ck,) if checkpoints else ())
    p = plan(B, T, H, hd)
    state_out = torch.empty_like(state)
    vec = rows_aligned(r, k, v, w, state, out, state_out)  # ck too: fresh
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), state.data_ptr(), out.data_ptr(),
                      state_out.data_ptr(),
                      ck.data_ptr() if ck is not None and ck.numel() else None,
                      B, T, H, hd, p.lanes, p.chunk, int(vec), stream)
    if err:
        raise RuntimeError(f"wkv_scan launch failed: cudaError_t {err}")
    wkv_scan.launches += 1
    return (out, state_out) + ((ck,) if checkpoints else ())


wkv_scan.launches = 0
