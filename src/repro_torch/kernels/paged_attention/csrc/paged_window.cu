// Paged-window GQA attention for Hopper (sm_90a), q_len >= 1.
//
// Replaces the TPU kernel `_paged_window_kernel`
// (src/repro/kernels/paged_attention/kernel.py:148, pallas_call at :239)
// and computes the same function: window query w of batch row b attends
// to cache positions [0, base[b] + w] of the row's paged KV, read in
// place through its block table; an optional sliding window clips the
// low side at base[b] + w + 1 - window. Outputs out (B,S,Hq,hd) in q's
// dtype and lse (B,S,Hq) in f32. Inputs are f32 or bf16; every sum is
// taken in f32. A row that sees no position writes out 0 and lse
// log(1e-30) (m_safe, max(l, 1e-30)).
//
// Layouts (all contiguous): q (B,S,Hq,hd); pool_k / pool_v
// (num_blocks, bs, Hkv, hd); block_table (B, max_blocks) int32;
// base_lens (B,) int32. Query head h reads KV head h / G, G = Hq / Hkv.
//
// Head dims: any hd <= 256 that is a multiple of 8 (so a row of the
// pool is whole 16-byte chunks in f32 and bf16: 224 B at hd 112 in
// bf16, 384 B at hd 192). The kernels are instantiated on the padded
// head dim HD (32, 64, 128, 192 or 256, the smallest >= hd); loads of
// the chunks past hd are zero-filled in shared memory, so the padded
// dims add nothing to a score or an output, and stores stop at hd.
// Global rows are addressed with the true hd; the split partials keep
// the padded stride.
//
// Design: split-KV (flash-decoding) inside the kernel. The host plan
// (`kernel.py::plan`, a function of shapes only: base_lens is never read
// on the host) cuts the table into splits of `split_blocks` whole blocks
// (S times 64 positions: 4 blocks at bs 16 for decode, the whole table
// for a 64-token chunk window) and the R = S * G packed rows of a KV
// head (row r: window position r / G, query head kvh * G + r % G) into
// tiles. The grid is (Hkv, B, splits x row tiles), split-major, so every
// row's first splits are dispatched first; a CTA whose rows see nothing
// of its split (by base_lens, read on the device) exits at once. One
// CTA serves all the rows of its tile, so every staged K/V position is
// shared by the G query heads. Positions are copied one K and one V row
// at a time through the table with 16-byte `cp.async`, kept in q's dtype
// (bf16 stays bf16); positions outside the CTA's visible range are
// zero-filled and their table entries never read, so scratch block 0 and
// stale block tails never reach a sum.
//
// Two kernels compute a split, chosen by the plan:
// - CUDA cores (decode, short windows, f32): tiles of 16 packed rows,
//   4 warps, warp w takes rows w, w + 4, ...; K/V tiles of `tile_blocks`
//   blocks (64 positions) in a ring of two stages (one when a split is
//   one tile, as at decode), each row padded by 16 bytes against bank
//   conflicts; the next tile is in flight while the current one is
//   scored. Lane t owns key t of a 32-key chunk and dots it with the
//   row's query (f32 in shared memory), so one pass yields 32 scores and
//   the online softmax costs one max and one sum reduction per row per
//   32 keys; PV with the lanes splitting hd, the chunk's probabilities
//   broadcast by shuffles.
// - Tensor cores (bf16 windows of S >= 16, hd >= 64): tiles of 64 packed
//   rows, 16 a warp; K/V tiles of 64 positions (32 at hd 256) in a
//   swizzled two-stage bf16 ring; S = QK^T and O += PV on `mma.sync`
//   m16n8k16 with `ldmatrix`, as the flash kernel does
//   (kernels/include/hopper.cuh).
// With one split a kernel writes out / lse itself; with more it writes
// f32 partials (out normalised, lse) per (row, query head, split) to a
// scratch the wrapper allocates, and a merge kernel in this file
// combines each row's visible splits with the closed-form LSE combine
// (`decode_attention/ref.py::merge_partials`). Either way the wrapper
// counts one launch per call.
//
// Bound on an H100 SXM: the bytes of K/V the rows can see, read once,
// over 3.35 TB/s. At the serving decode shape (qwen3-4b: Hkv 8, hd 128,
// bf16) that is 2 * 8 * 128 * 2 = 4 KB of K/V per cached token per
// layer, against 2 * G = 8 flops per byte, so the kernel is memory-bound
// (0.00125 ms at the smoke's decode lengths). The split gives 160
// working CTAs there (lengths 316, 90, 80, 21, 33, 49, 136, 266: 20
// splits of 64 x 8 KV heads), against B * Hkv = 64 in the first design;
// a 64-token chunk window runs 4 tensor-core row tiles x 8 x 8 = 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Dot of one 16-byte chunk of a K row with the matching f32 query slice.
__device__ __forceinline__ float dot16(const float* q, const float* k) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 c = *reinterpret_cast<const float4*>(k);
  return a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
}
__device__ __forceinline__ float dot16(const float* q,
                                       const __nv_bfloat16* k) {
  const uint4 u = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float4 a = reinterpret_cast<const float4*>(q)[0];
  const float4 c = reinterpret_cast<const float4*>(q)[1];
  const float2 k0 = __bfloat1622float2(h[0]), k1 = __bfloat1622float2(h[1]);
  const float2 k2 = __bfloat1622float2(h[2]), k3 = __bfloat1622float2(h[3]);
  return a.x * k0.x + a.y * k0.y + a.z * k1.x + a.w * k1.y + c.x * k2.x +
         c.y * k2.y + c.z * k3.x + c.w * k3.y;
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // packed rows per CTA

template <typename T, int HD>
struct Layout {
  static constexpr int EV = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int CPR = HD / EV;        // copies per K / V row
  static constexpr int LD = HD + EV;         // padded shared row, elements
  static constexpr int EPL = HD / 32;        // head dims per lane in PV
};

// Shared memory of the CUDA-core kernel: `qrows` f32 query rows, then
// `stages` stages of K and of V tiles of `tp` positions. A split of one
// tile (decode) needs one stage.
template <typename T, int HD>
size_t smem_bytes(int qrows, int stages, int tp) {
  return sizeof(float) * qrows * HD +
         sizeof(T) * 2 * stages * (size_t)tp * Layout<T, HD>::LD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int* __restrict__ table,
                       const int* __restrict__ base_lens, T* __restrict__ out,
                       float* __restrict__ lse, float* __restrict__ part_o,
                       float* __restrict__ part_lse, int S, int Hq, int Hkv,
                       int hd, int bs, int max_blocks, int window,
                       int tile_blocks, int split_blocks, int n_splits,
                       float scale) {
  using L = Layout<T, HD>;
  constexpr int EV = L::EV, CPR = L::CPR, LD = L::LD, EPL = L::EPL;
  const int cpr = hd / EV;  // chunks of a row that hold data
  extern __shared__ uint4 smem_u4[];
  const int G = Hq / Hkv;
  const int R = S * G;
  const int qrows = min(R, kRowTile);
  const int stages = split_blocks > tile_blocks ? 2 : 1;
  const int tp = tile_blocks * bs;                // positions per tile
  float* qs = reinterpret_cast<float*>(smem_u4);  // (qrows, HD) f32
  T* kst = reinterpret_cast<T*>(qs + qrows * HD);  // stages x (tp, LD)
  T* vst = kst + stages * tp * LD;                 // stages x (tp, LD)

  // split-major grid: every row's first splits are dispatched first,
  // the CTAs past the rows' ranges (which exit at once) last
  const int row_tiles = (R + kRowTile - 1) / kRowTile;
  const int split = blockIdx.z / row_tiles;
  const int r0 = (blockIdx.z - split * row_tiles) * kRowTile;
  const int r_last = min(r0 + kRowTile, R) - 1;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int base = base_lens[b];
  const int kv_len = max_blocks * bs;
  const int s_lo = split * split_blocks * bs;
  const int s_hi = min(s_lo + split_blocks * bs, kv_len);
  // positions of this split any row of the CTA can see: [lo, hi)
  const int hi = min(base + r_last / G + 1, s_hi);
  const int lo =
      max(window > 0 ? base + r0 / G + 1 - window : 0, s_lo);
  if (n_splits > 1 && hi <= lo) return;  // the merge skips this split

  for (int e = threadIdx.x; e < qrows * HD; e += kThreads) {
    const int r = e / HD;
    const int pr = r0 + r;
    const int d = e - r * HD;
    qs[e] = pr < R && d < hd
                ? to_f32(q[(((size_t)b * S + pr / G) * Hq + kvh * G + pr % G) *
                               hd +
                           d])
                : 0.f;
  }

  const int* trow = table + (size_t)b * max_blocks;
  // copy tile positions [first, first + tp) of K and V, zero outside
  // [lo, hi)
  auto stage = [&](int buf, int first) {
    T* kd = kst + buf * tp * LD;  // buf < stages
    T* vd = vst + buf * tp * LD;
#pragma unroll 4
    for (int e = threadIdx.x; e < 2 * tp * CPR; e += kThreads) {
      const int kv = e >= tp * CPR;
      const int rem = e - kv * tp * CPR;
      const int t = rem / CPR;
      const int c = rem - t * CPR;
      const int p = first + t;
      const bool ok = p >= lo && p < hi && c < cpr;
      const T* pool = kv ? pool_v : pool_k;
      const T* src = pool;
      if (ok) {
        const int blk = p / bs;
        src = pool + (((size_t)trow[blk] * bs + (p - blk * bs)) * Hkv + kvh) *
                         hd +
              c * EV;
      }
      cp_async16((kv ? vd : kd) + t * LD + c * EV, src, ok);
    }
  };

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][EPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < EPL; ++d) acc[i][d] = 0.f;
  }

  int t0 = hi > lo ? s_lo + (lo - s_lo) / tp * tp : hi;
  if (t0 < hi) stage(0, t0);
  cp_async_commit();
  for (int buf = 0; t0 < hi; t0 += tp, buf ^= 1) {
    if (t0 + tp < hi) stage(buf ^ 1, t0 + tp);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the query rows) have landed
    __syncthreads();
    const T* ks = kst + buf * tp * LD;
    const T* vs = vst + buf * tp * LD;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      // continue, not break: a break kept m, l and acc in local memory
      if (r0 + r > r_last) continue;
      const int n_valid = base + (r0 + r) / G + 1;  // causal: [0, n_valid)
      const int lo_r = window > 0 ? n_valid - window : 0;
      const float* qrow = qs + r * HD;
      for (int c0 = 0; c0 < tp; c0 += 32) {
        const int kpos0 = t0 + c0;
        if (kpos0 >= n_valid || kpos0 + 32 <= lo_r) continue;
        const int t = c0 + lane;
        const int kpos = kpos0 + lane;
        float sc = -INFINITY;
        if (t < tp) {
          const T* krow = ks + t * LD;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < CPR; ++c)
            dot += dot16(qrow + c * EV, krow + c * EV);
          if (kpos < n_valid && kpos >= lo_r && kpos >= lo && kpos < hi)
            sc = dot * scale;
        }
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float p = sc == -INFINITY ? 0.f : expf(sc - m_safe);
        const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
        l[i] = l[i] * alpha + warp_sum(p);
        m[i] = m_new;
#pragma unroll
        for (int d = 0; d < EPL; ++d) acc[i][d] *= alpha;
        const int nt = min(32, tp - c0);
        for (int j = 0; j < nt; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const T* vrow = vs + (c0 + j) * LD + lane * EPL;
#pragma unroll
          for (int d = 0; d < EPL; ++d) acc[i][d] += pj * to_f32(vrow[d]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int pr = r0 + warp + kWarps * i;
    if (pr > r_last) continue;
    const size_t row = ((size_t)b * S + pr / G) * Hq + kvh * G + pr % G;
    const float m_safe = m[i] == -INFINITY ? 0.f : m[i];
    const float ls = fmaxf(l[i], 1e-30f);
    if (n_splits == 1) {
#pragma unroll
      for (int d = 0; d < EPL; ++d)
        if (lane * EPL + d < hd)
          out[row * hd + lane * EPL + d] = from_f32<T>(acc[i][d] / ls);
      if (lane == 0) lse[row] = m_safe + logf(ls);
    } else {
      const size_t prow = row * n_splits + split;
#pragma unroll
      for (int d = 0; d < EPL; ++d)
        part_o[prow * HD + lane * EPL + d] = acc[i][d] / ls;
      if (lane == 0) part_lse[prow] = m_safe + logf(ls);
    }
  }
}

constexpr int kMergeWarps = 8;

// One warp per (b, w, head) row: merge the partials of the splits the
// row can see, [lo_r, hi_r) of the cache, with the LSE combine. A row
// that sees no split writes out 0 and lse log(1e-30).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMergeWarps)
    paged_merge_kernel(const float* __restrict__ part_o,
                       const float* __restrict__ part_lse,
                       const int* __restrict__ base_lens, T* __restrict__ out,
                       float* __restrict__ lse, int rows, int S, int Hq,
                       int hd, int kv_len, int window, int split_len,
                       int n_splits) {
  constexpr int EPL = HD / 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int b = row / (S * Hq);
  const int w = row / Hq - b * S;
  const int n_valid = base_lens[b] + w + 1;
  const int hi = min(n_valid, kv_len);
  const int lo = window > 0 ? max(n_valid - window, 0) : 0;
  const int s_first = lo / split_len;
  const int s_end = hi > lo ? (hi - 1) / split_len + 1 : s_first;
  const float* pl = part_lse + (size_t)row * n_splits;
  const float* po = part_o + (size_t)row * n_splits * HD + lane * EPL;
  float mx = -INFINITY;
  for (int s = s_first + lane; s < s_end; s += 32) mx = fmaxf(mx, pl[s]);
  mx = warp_max(mx);
  float den = 0.f;
  for (int s = s_first + lane; s < s_end; s += 32) den += expf(pl[s] - mx);
  den = warp_sum(den);
  float acc[EPL];
#pragma unroll
  for (int d = 0; d < EPL; ++d) acc[d] = 0.f;
  for (int s = s_first; s < s_end; ++s) {
    const float wgt = expf(pl[s] - mx);
#pragma unroll
    for (int d = 0; d < EPL; ++d) acc[d] += wgt * po[(size_t)s * HD + d];
  }
  const bool empty = s_end == s_first;
#pragma unroll
  for (int d = 0; d < EPL; ++d)
    if (lane * EPL + d < hd)
      out[(size_t)row * hd + lane * EPL + d] =
          from_f32<T>(empty ? 0.f : acc[d] / den);
  if (lane == 0) lse[row] = empty ? logf(1e-30f) : mx + logf(den);
}

// ------------------------------------ bf16 windows, S >= 16: tensor cores
using hopper::bf16;

constexpr int kMmaRows = 64;     // packed rows per CTA: 4 warps x 16
constexpr int kMmaThreads = 128;

template <int HD>
struct MmaCfg {
  static constexpr int BK = HD <= 128 ? 64 : 32;  // positions per K/V tile
  static constexpr int CPR = HD / 8;              // 16-byte chunks per row
  static constexpr int TILE = BK * HD;
  // the Q tile, then two stages of K and of V, all bf16
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)kMmaRows * HD + 4 * (size_t)TILE);
};

// The same function for bf16 and many packed rows (chunk windows,
// verify): one CTA per (split, tile of 64 packed rows, KV head, row).
// Each K / V tile of BK positions is copied position by position
// through the table with 16-byte cp.async into a swizzled bf16 ring of
// two stages (zero outside the CTA's range [lo, hi)); S = QK^T and
// O += PV run on mma.sync as in the flash kernel.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    paged_mma_kernel(const bf16* __restrict__ q,
                     const bf16* __restrict__ pool_k,
                     const bf16* __restrict__ pool_v,
                     const int* __restrict__ table,
                     const int* __restrict__ base_lens,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     float* __restrict__ part_o,
                     float* __restrict__ part_lse, int S, int Hq, int Hkv,
                     int hd, int bs, int max_blocks, int window,
                     int split_len, int n_splits, float scale_log2) {
  using namespace hopper;
  using C = MmaCfg<HD>;
  constexpr int BK = C::BK;
  constexpr int CPR = C::CPR;
  const int cpr = hd / 8;  // chunks of a row that hold data
  constexpr int NT = BK / 8;
  constexpr int DT = HD / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // (kMmaRows, HD)
  bf16* kst = qs + kMmaRows * HD;               // 2 x (BK, HD)
  bf16* vst = kst + 2 * C::TILE;                // 2 x (BK, HD)

  const int G = Hq / Hkv;
  const int R = S * G;
  const int row_tiles = (R + kMmaRows - 1) / kMmaRows;
  const int split = blockIdx.z / row_tiles;
  const int r0 = (blockIdx.z - split * row_tiles) * kMmaRows;
  const int r_last = min(r0 + kMmaRows, R) - 1;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int base = base_lens[b];
  const int kv_len = max_blocks * bs;
  const int s_lo = split * split_len;
  const int s_hi = min(s_lo + split_len, kv_len);
  // positions of this split any row of the CTA can see: [lo, hi)
  const int hi = min(base + r_last / G + 1, s_hi);
  const int lo = max(window > 0 ? base + r0 / G + 1 - window : 0, s_lo);
  if (n_splits > 1 && hi <= lo) return;  // the merge skips this split
  // positions every row sees: tiles inside [full_lo, full_hi) need no
  // mask
  const int full_hi = min(base + r0 / G + 1, hi);
  const int full_lo = max(window > 0 ? base + r_last / G + 1 - window : 0,
                          lo);

  for (int e = threadIdx.x; e < kMmaRows * CPR; e += kMmaThreads) {
    const int r = e / CPR;
    const int c = e - r * CPR;
    const int pr = r0 + r;
    const bool ok = pr < R && c < cpr;
    const bf16* src =
        ok ? q + (((size_t)b * S + pr / G) * Hq + kvh * G + pr % G) * hd +
                 c * 8
           : q;
    cp_async16(qs + swz(r, c, CPR), src, ok);
  }
  const int* trow = table + (size_t)b * max_blocks;
  // copy positions [first, first + BK) of K and V, zero outside [lo, hi)
  auto stage = [&](int buf, int first) {
#pragma unroll 4
    for (int e = threadIdx.x; e < 2 * BK * CPR; e += kMmaThreads) {
      const int kv = e >= BK * CPR;
      const int rem = e - kv * BK * CPR;
      const int t = rem / CPR;
      const int c = rem - t * CPR;
      const int p = first + t;
      const bool ok = p >= lo && p < hi && c < cpr;
      const bf16* pool = kv ? pool_v : pool_k;
      const bf16* src = pool;
      if (ok) {
        const int blk = p / bs;
        src = pool + (((size_t)trow[blk] * bs + (p - blk * bs)) * Hkv + kvh) *
                         hd +
              c * 8;
      }
      cp_async16((kv ? vst : kst) + buf * C::TILE + swz(t, c, CPR), src, ok);
    }
  };

  int nv[2], lo_r[2];  // this thread's rows: causal end, window start
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    nv[i] = base + (r0 + warp * 16 + gid + 8 * i) / G + 1;
    lo_r[i] = window > 0 ? nv[i] - window : 0;
  }
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  int t0 = hi > lo ? s_lo + (lo - s_lo) / BK * BK : hi;
  if (t0 < hi) stage(0, t0);
  cp_async_commit();
  for (int buf = 0; t0 < hi; t0 += BK, buf ^= 1) {
    if (t0 + BK < hi) stage(buf ^ 1, t0 + BK);  // in flight meanwhile
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the query tile) have landed
    __syncthreads();
    float s[NT][4];
    qk_tile<HD, BK>(s, qs, warp * 16, kst + buf * C::TILE, lane);
    const bool need_mask = t0 < full_lo || t0 + BK > full_hi;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int key = t0 + j * 8 + tig * 2 + (e & 1);
          const int i = e >> 1;
          if (!(key < nv[i] && key >= lo_r[i] && key >= lo && key < hi))
            x = -INFINITY;
        }
        s[j][e] = x;
      }
    softmax_step<NT, DT>(s, o, m, l);
    pv_tile<HD, BK>(o, s, vst + buf * C::TILE, lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int pr = r0 + warp * 16 + gid + 8 * i;
    if (pr >= R) continue;
    const size_t row = ((size_t)b * S + pr / G) * Hq + kvh * G + pr % G;
    const float ls = fmaxf(li, 1e-30f);
    const float inv = 1.f / ls;
    // m is in base 2: lse = ln 2 * m + ln l
    const float row_lse =
        (m[i] == -INFINITY ? 0.f : m[i]) * 0.6931471805599453f + logf(ls);
    if (n_splits == 1) {
#pragma unroll
      for (int j = 0; j < DT; ++j)
        if (j * 8 < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + row * hd + j * 8 +
                                             tig * 2) =
              __floats2bfloat162_rn(o[j][2 * i] * inv,
                                    o[j][2 * i + 1] * inv);
      if (tig == 0) lse[row] = row_lse;
    } else {
      const size_t prow = row * n_splits + split;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<float2*>(part_o + prow * HD + j * 8 + tig * 2) =
            make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (tig == 0) part_lse[prow] = row_lse;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_merge(const float* part_o, const float* part_lse,
                         const int* base_lens, T* out, float* lse, int B,
                         int S, int Hq, int hd, int bs, int max_blocks,
                         int window, int split_blocks, int n_splits,
                         cudaStream_t stream) {
  if (n_splits == 1) return cudaSuccess;
  const int rows = B * S * Hq;
  paged_merge_kernel<T, HD>
      <<<(rows + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
         stream>>>(part_o, part_lse, base_lens, out, lse, rows, S, Hq, hd,
                   max_blocks * bs, window, split_blocks * bs, n_splits);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const T* q, const T* pool_k, const T* pool_v,
                      const int* table, const int* base_lens, T* out,
                      float* lse, float* part_o, float* part_lse, int B,
                      int S, int Hq, int Hkv, int hd, int bs, int max_blocks,
                      int window, int tile_blocks, int split_blocks,
                      int n_splits, int mma, cudaStream_t stream) {
  const int R = S * (Hq / Hkv);
  cudaError_t err;
  if (mma) {
    if constexpr (sizeof(T) == 2 && HD >= 64) {
      using C = MmaCfg<HD>;
      err = cudaFuncSetAttribute(paged_mma_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)C::SMEM);
      if (err != cudaSuccess) return err;
      const dim3 grid(Hkv, B, n_splits * ((R + kMmaRows - 1) / kMmaRows));
      paged_mma_kernel<HD><<<grid, kMmaThreads, C::SMEM, stream>>>(
          q, pool_k, pool_v, table, base_lens, out, lse, part_o, part_lse,
          S, Hq, Hkv, hd, bs, max_blocks, window, split_blocks * bs,
          n_splits, 1.4426950408889634f / sqrtf((float)hd));
    } else {
      return cudaErrorInvalidValue;  // tensor cores take bf16, hd >= 64
    }
  } else {
    const size_t smem =
        smem_bytes<T, HD>(R < kRowTile ? R : kRowTile,
                          split_blocks > tile_blocks ? 2 : 1,
                          tile_blocks * bs);
    err = cudaFuncSetAttribute(paged_split_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Hkv, B, n_splits * ((R + kRowTile - 1) / kRowTile));
    paged_split_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        q, pool_k, pool_v, table, base_lens, out, lse, part_o, part_lse, S,
        Hq, Hkv, hd, bs, max_blocks, window, tile_blocks, split_blocks,
        n_splits, 1.0f / sqrtf((float)hd));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T, HD>(part_o, part_lse, base_lens, out, lse, B, S,
                             Hq, hd, bs, max_blocks, window, split_blocks,
                             n_splits, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* table, const int* base_lens, void* out,
                   float* lse, float* part_o, float* part_lse, int B, int S,
                   int Hq, int Hkv, int hd, int bs, int max_blocks,
                   int window, int tile_blocks, int split_blocks,
                   int n_splits, int mma, cudaStream_t stream) {
#define PW_LAUNCH(HD_)                                                      \
  case HD_:                                                                 \
    return launch_hd<T, HD_>(                                               \
        static_cast<const T*>(q), static_cast<const T*>(pool_k),            \
        static_cast<const T*>(pool_v), table, base_lens, static_cast<T*>(out), \
        lse, part_o, part_lse, B, S, Hq, Hkv, hd, bs, max_blocks, window,   \
        tile_blocks, split_blocks, n_splits, mma, stream)
  if (hd <= 0 || hd > 256 || hd % 8) return cudaErrorInvalidValue;
  // the padded head dim: kernel.py::padded_head_dim
  const int hdp = hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128
                : hd <= 192 ? 192 : 256;
  switch (hdp) {
    PW_LAUNCH(32);
    PW_LAUNCH(64);
    PW_LAUNCH(128);
    PW_LAUNCH(192);
    PW_LAUNCH(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef PW_LAUNCH
}

}  // namespace

// Launches on `stream` and returns the first cudaError_t (0 = queued).
// dtype: 0 = float32, 1 = bfloat16 (q, pool_k, pool_v and out alike).
// tile_blocks, split_blocks, n_splits and mma (1: the tensor-core
// kernel, bf16 with hd >= 64 only) come from the host plan; with
// n_splits > 1, part_o (B,S,Hq,n_splits,hdp) with hdp the padded head
// dim and part_lse (B,S,Hq,n_splits) are f32 scratch and the merge
// kernel follows. hd: a multiple of 8 up to 256.
extern "C" int paged_window_attention(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* base_lens, void* out, float* lse, float* part_o,
    float* part_lse, int B, int S, int Hq, int Hkv, int hd, int bs,
    int max_blocks, int window, int tile_blocks, int split_blocks,
    int n_splits, int mma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, pool_k, pool_v, table, base_lens, out, lse,
                              part_o, part_lse, B, S, Hq, Hkv, hd, bs,
                              max_blocks, window, tile_blocks, split_blocks,
                              n_splits, mma, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        q, pool_k, pool_v, table, base_lens, out, lse, part_o, part_lse, B, S,
        Hq, Hkv, hd, bs, max_blocks, window, tile_blocks, split_blocks,
        n_splits, mma, st);
  return (int)cudaErrorInvalidValue;
}
