"""Binding of the CUDA paged-window attention kernel
(``csrc/paged_window.cu``, built by ``kernels._build``, loaded with
``ctypes``).

``plan`` is the kernel's host-side plan, a function of shapes only (the
wrapper never reads ``base_lens`` on the host): the staged tile and the
split of the block table into whole-block ranges of the KV length
(flash-decoding), the tiles of packed query rows, the shared memory.
The wrapper checks device, dtype, shape, contiguity and alignment,
allocates ``out`` / ``lse`` and, when the plan has more than one split,
the f32 partials with ``torch.empty``, and launches on the current CUDA
stream without synchronising; a launch CUDA refuses raises. One call
launches the split kernel and, with more than one split, the merge
kernel: ``paged_window_attention.launches`` counts calls.
The launch is the CUDA implementation of the op
``repro_torch::paged_window_attention`` (``kernels.kernel_op``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import (_build, check_device, costs, count_launch,
                                 kernel_op, refuse_grad)

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_window.cu"
# the head dims the kernels are instantiated on: a head dim hd (a
# multiple of 8 up to 256) runs on the smallest of them >= hd, its
# padded dims zero in shared memory
HEAD_DIMS = (32, 64, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 227 * 1024         # dynamic shared memory a CTA may use
ROW_TILE = 16                   # packed query rows per CUDA-core CTA
MMA_ROWS = 64                   # packed query rows per tensor-core CTA
MMA_MIN_S = 16                  # window length from which bf16 takes mma
SPLIT_POSITIONS = 64            # KV positions of a decode split
# the C signature: q, pool_k, pool_v, table, base_lens, out, lse, part_o,
# part_lse; B, S, Hq, Hkv, hd, bs, max_blocks, window, tile_blocks,
# split_blocks, n_splits, mma, dtype; stream
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def padded_head_dim(hd: int) -> int:
    """The instantiated head dim that runs ``hd``; raises for a head dim
    the kernel does not take (not a multiple of 8, or above 256: a pool
    row must be whole 16-byte chunks in f32 and bf16)."""
    if hd <= 0 or hd % 8 or hd > HEAD_DIMS[-1]:
        raise ValueError(f"head dim {hd}: a multiple of 8 up to "
                         f"{HEAD_DIMS[-1]}")
    return next(h for h in HEAD_DIMS if h >= hd)


class Plan(NamedTuple):
    mma: bool          # the tensor-core kernel (bf16, S >= 16, hd >= 64)
    tile_blocks: int   # pool blocks per staged K/V tile (CUDA-core kernel)
    split_blocks: int  # pool blocks per split, a multiple of tile_blocks
    n_splits: int      # splits of the table; > 1 adds the merge kernel
    row_tiles: int     # tiles of packed rows (R = S * G) per KV head
    smem: int          # bytes of dynamic shared memory per CTA


def smem_bytes(hd: int, itemsize: int, tile_positions: int, stages: int,
               qrows: int) -> int:
    """The CUDA-core kernel's shared memory: ``qrows`` f32 query rows,
    then ``stages`` stages of K and of V rows in the pool's dtype, each
    row of the padded head dim padded by one 16-byte chunk."""
    hdp = padded_head_dim(hd)
    return 4 * qrows * hdp \
        + itemsize * 2 * stages * tile_positions * (hdp + 16 // itemsize)


def mma_smem_bytes(hd: int) -> int:
    """The tensor-core kernel's: a bf16 tile of MMA_ROWS query rows and
    two stages of K and of V tiles (64 positions, 32 above a padded head
    dim of 128), at the padded head dim."""
    hdp = padded_head_dim(hd)
    bk = 64 if hdp <= 128 else 32
    return 2 * (MMA_ROWS * hdp + 4 * bk * hdp)


def plan(S: int, Hq: int, Hkv: int, hd: int, bs: int, max_blocks: int,
         itemsize: int) -> Plan:
    """The launch plan for one call, from shapes alone. A split is S
    times the whole blocks of SPLIT_POSITIONS positions (one block at bs
    >= 64): a decode split covers 64 positions, a chunk window's one
    split the whole table. bf16 windows of S >= 16 (hd >= 64) take the
    tensor-core kernel; the others the CUDA-core one, whose staged tile
    is those blocks, fewer where two stages would not fit (one stage
    when a split is one tile). Shared memory is sized at the padded head
    dim. Raises if one block does not fit."""
    R = S * (Hq // Hkv)
    mma = itemsize == 2 and S >= MMA_MIN_S and padded_head_dim(hd) >= 64
    stages = 1 if S == 1 else 2
    qrows = min(R, ROW_TILE)
    tile_blocks = max(1, SPLIT_POSITIONS // bs)
    while tile_blocks > 1 and smem_bytes(hd, itemsize, tile_blocks * bs,
                                         stages, qrows) > SMEM_LIMIT:
        tile_blocks //= 2
    smem = (mma_smem_bytes(hd) if mma else
            smem_bytes(hd, itemsize, tile_blocks * bs, stages, qrows))
    if smem > SMEM_LIMIT:
        raise ValueError(f"block_size {bs} x head dim {hd} exceeds the "
                         f"kernel's {SMEM_LIMIT} B of shared memory")
    split_blocks = tile_blocks * max(S, 1)
    n_splits = max(1, -(-max_blocks // split_blocks))
    row_tiles = -(-R // (MMA_ROWS if mma else ROW_TILE))
    return Plan(mma, tile_blocks, split_blocks, n_splits, row_tiles, smem)


def split_ranges(p: Plan, bs: int, max_blocks: int) -> list[range]:
    """The cache positions each split covers, in order."""
    n = max_blocks * bs
    step = p.split_blocks * bs
    return [range(s * step, min(s * step + step, n))
            for s in range(p.n_splits)]


def visible_splits(p: Plan, bs: int, max_blocks: int, base: int, w: int,
                   window: int = 0) -> range:
    """The splits whose partials the merge reads for window query w of a
    row with ``base`` resident tokens: those that hold a position of
    ``[max(0, n - window), min(n, max_blocks * bs))``, n = base + w + 1.
    Every CTA that serves the row in such a split writes its partial."""
    n = base + w + 1
    hi = min(n, max_blocks * bs)
    lo = max(n - window, 0) if window > 0 else 0
    step = p.split_blocks * bs
    first = lo // step
    return range(first, (hi - 1) // step + 1 if hi > lo else first)


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).paged_window_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, pool_k, pool_v, block_table, base_lens):
    check_device("paged_window", q)
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
    if hd != hd_kv:
        raise ValueError(f"head dim {hd} != pool head dim {hd_kv}")
    padded_head_dim(hd)
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(base_lens.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"base_lens {tuple(base_lens.shape)} for B={B}")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"B {B} / Hkv {Hkv}: the grid takes at most 65535")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (cp.async)")


def paged_window_attention(q, pool_k, pool_v, block_table, base_lens, *,
                           sliding_window: int = 0):
    """The CUDA kernel. q (B,S,Hq,hd); pool_k/pool_v (num_blocks, bs, Hkv,
    hd); block_table (B, max_blocks) int32; base_lens (B,) int32 — all
    contiguous on one CUDA device, q and pool f32 or bf16. Window query
    w of row b attends to cache positions ``[0, base_lens[b] + w]``.
    Returns (out (B,S,Hq,hd) in q.dtype, lse (B,S,Hq) f32). On meta
    tensors the op gives their shapes."""
    _check(q, pool_k, pool_v, block_table, base_lens)
    refuse_grad("paged_window_attention", q, pool_k, pool_v)
    return _op(q, pool_k, pool_v, block_table, base_lens,
               int(sliding_window))


def _launch(q, pool_k, pool_v, block_table, base_lens, sliding_window):
    B, S, Hq, hd = q.shape
    out, lse = _fake(q)
    if B == 0 or S == 0:
        return out, lse
    _, bs, Hkv, _ = pool_k.shape
    max_blocks = block_table.shape[1]
    p = plan(S, Hq, Hkv, hd, bs, max_blocks, q.element_size())
    if p.n_splits * p.row_tiles > 65535:
        raise ValueError(f"{p.n_splits} splits x {p.row_tiles} row tiles: "
                         f"the grid takes at most 65535")
    part_o = part_lse = None
    if p.n_splits > 1:
        part_o = torch.empty((B, S, Hq, p.n_splits, padded_head_dim(hd)),
                             dtype=torch.float32, device=q.device)
        part_lse = torch.empty((B, S, Hq, p.n_splits), dtype=torch.float32,
                               device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                      block_table.data_ptr(), base_lens.data_ptr(),
                      out.data_ptr(), lse.data_ptr(),
                      part_o.data_ptr() if part_o is not None else None,
                      part_lse.data_ptr() if part_lse is not None else None,
                      B, S, Hq, Hkv, hd, bs, max_blocks, sliding_window,
                      p.tile_blocks, p.split_blocks, p.n_splits,
                      int(p.mma), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_window_attention launch failed: "
                           f"cudaError_t {err}")
    count_launch(paged_window_attention)
    return out, lse


def _fake(q, *_):
    B, S, Hq, _ = q.shape
    return torch.empty_like(q), torch.empty((B, S, Hq), dtype=torch.float32,
                                            device=q.device)


def _cost(q, pool_k, pool_v, block_table, base_lens, sliding_window):
    """The work of the bases this call holds; on meta tensors, whose
    values are unknown, each row's window ends at the table's end."""
    B, S, Hq, hd = q.shape
    _, bs, Hkv, _ = pool_k.shape
    max_blocks = block_table.shape[1]
    bases = [max_blocks * bs - S] * B if base_lens.device.type == "meta" \
        else base_lens.tolist()
    return costs.paged_window(bases, S, Hq, Hkv, hd, q.dtype, bs, max_blocks,
                              sliding_window)


_op = kernel_op("paged_window_attention",
                "(Tensor q, Tensor pool_k, Tensor pool_v, Tensor block_table, "
                "Tensor base_lens, int sliding_window) -> (Tensor, Tensor)",
                _launch, _fake, _cost)
paged_window_attention.launches = 0
