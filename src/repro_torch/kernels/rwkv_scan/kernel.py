"""Binding of the CUDA WKV6 kernel (``csrc/wkv.cu``, built by
``kernels._build``, loaded with ``ctypes``).

The wrapper checks device, dtype, shape and contiguity, allocates
``out`` / the final state with ``torch.empty``, and launches on the
current CUDA stream without synchronising; a launch CUDA refuses raises.
``wkv_scan.launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
MAX_HEAD_DIM = 128             # column j of the state lives in registers
# the C signature: r, k, v, w, u, state, out, state_out; B, T, H, hd;
# stream
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).wkv_scan
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
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


def wkv_scan(r, k, v, w, u, state):
    """The CUDA kernel. r/k/v/w (B,T,H,hd), u (H,hd), state (B,H,hd,hd):
    contiguous float32 on one CUDA device. Returns (out (B,T,H,hd),
    final state (B,H,hd,hd)), both float32."""
    _check(r, k, v, w, u, state)
    B, T, H, hd = r.shape
    out = torch.empty_like(r)
    if B == 0 or T == 0:
        return out, state.clone()
    state_out = torch.empty_like(state)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), state.data_ptr(), out.data_ptr(),
                      state_out.data_ptr(), B, T, H, hd, stream)
    if err:
        raise RuntimeError(f"wkv_scan launch failed: cudaError_t {err}")
    wkv_scan.launches += 1
    return out, state_out


wkv_scan.launches = 0
