"""Binding of the CUDA paged-window attention kernel
(``csrc/paged_window.cu``, built by ``kernels._build``, loaded with
``ctypes``).

The wrapper checks device, dtype, shape and contiguity, allocates
``out`` / ``lse`` with ``torch.empty``, and launches on the current CUDA
stream without synchronising; a launch CUDA refuses raises.
``paged_window_attention.launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_window.cu"
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024          # static-launch shared memory per CTA
# the C signature: q, pool_k, pool_v, table, base_lens, out, lse; B, S,
# Hq, Hkv, hd, bs, max_blocks, window, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).paged_window_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, pool_k, pool_v, block_table, base_lens):
    if q.device.type != "cuda":
        raise ValueError(f"paged_window kernel needs CUDA tensors, got q on "
                         f"{q.device}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_table", block_table), ("base_lens", base_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_table", block_table), ("base_lens", base_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: float32 or bfloat16 only")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError(f"pool dtypes {pool_k.dtype}/{pool_v.dtype} != q "
                         f"dtype {q.dtype}")
    if block_table.dtype != torch.int32 or base_lens.dtype != torch.int32:
        raise ValueError("block_table and base_lens must be int32")
    if q.dim() != 4 or pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, pool_k "
                         f"{tuple(pool_k.shape)}, pool_v {tuple(pool_v.shape)}")
    B, S, Hq, hd = q.shape
    _, bs, Hkv, hd_kv = pool_k.shape
    if hd != hd_kv or hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} (pool {hd_kv}): one of {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(base_lens.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"base_lens {tuple(base_lens.shape)} for B={B}")
    if 2 * bs * hd * 4 > _SMEM_LIMIT:
        raise ValueError(f"block_size {bs} x head dim {hd} exceeds the "
                         f"kernel's {_SMEM_LIMIT} B of shared memory")


def paged_window_attention(q, pool_k, pool_v, block_table, base_lens, *,
                           sliding_window: int = 0):
    """The CUDA kernel. q (B,S,Hq,hd); pool_k/pool_v (num_blocks, bs, Hkv,
    hd); block_table (B, max_blocks) int32; base_lens (B,) int32 — all
    contiguous on one CUDA device, q and pool f32 or bf16. Window query
    w of row b attends to cache positions ``[0, base_lens[b] + w]``.
    Returns (out (B,S,Hq,hd) in q.dtype, lse (B,S,Hq) f32)."""
    _check(q, pool_k, pool_v, block_table, base_lens)
    B, S, Hq, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out, lse
    _, bs, Hkv, _ = pool_k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      block_table.data_ptr(), base_lens.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), B, S, Hq, Hkv, hd, bs,
                      block_table.shape[1], int(sliding_window),
                      _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_window_attention launch failed: "
                           f"cudaError_t {err}")
    paged_window_attention.launches += 1
    return out, lse


paged_window_attention.launches = 0
