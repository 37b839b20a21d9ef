// Blocked causal / sliding-window GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:24, pallas_call at :90)
// and computes the same function: query i of (b, head h) sits at
// absolute position T - S + i and attends to the keys of KV head h / G
// (G = Hq / Hkv) at positions j with j <= T - S + i when causal, and
// j > T - S + i - window when a sliding window is set. The softmax and
// every sum are taken in f32; the output is in q's dtype. A query row
// that sees no key writes 0 (the reference kernel's m_safe / alpha and
// max(l, 1e-30) guards).
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp of
// its scaled scores, (B, Hq, S) f32 contiguous, -inf for a row that sees
// no key: the backward kernel (flash_bwd.cu) recomputes the
// probabilities from it. That is a second instantiation of each kernel
// (the LSE template flag); serving passes null and runs the first, whose
// code the lse write does not touch.
//
// Layouts: q / out (B, Hq, S, hd), k / v (B, Hkv, T, hd), each read
// through element strides of its batch, head and position axes with the
// head-dim stride 1. So the model's (B, S, H, hd) tensors (k and v are
// non-contiguous slices of one projection) and the reference's
// (B, H, S, hd) layout are both read without a copy. Inputs are f32 or
// bf16; hd <= 256, any S, T >= 1 (no multiple-of-tile gate).
//
// Two instantiations, chosen by dtype (neither is a fallback of the other).
//
// bf16: tensor cores. One CTA takes one (batch row, KV head, tile of 64
// packed query rows); packed row r is (position r / G, query head
// kvh * G + r % G), so the G query heads of a KV head share every K/V
// tile the CTA stages (G-fold less K/V traffic than one CTA per q head).
// Two warp groups of 4 warps each hold all 64 rows (16 a warp) and take
// alternate 64-position K/V tiles of the causal / window band (32 at
// hd > 128), and merge (o, m, l) through shared memory at the end. Each
// group has one K and one V tile in shared memory, bf16, XOR-swizzled in
// 16-byte chunks (chunk ^ (row & 7)) so `ldmatrix` is conflict-free,
// filled by 16-byte `cp.async.cg`: V_j is in flight during QK_j and the
// group's next K during PV_j. Positions outside the band are zero-filled
// (the src-size-0 form) and never read. S = QK^T and O += PV run as
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate) fed by `ldmatrix` (V
// through `ldmatrix.trans`); P stays in registers, rounded to bf16 as
// the A operand of PV (kernels/include/hopper.cuh). The online softmax
// is f32, in base 2 with the scale folded in. Only tiles that cross the
// diagonal, the window edge or T are masked. The grid's slow axis is the
// query tile, heaviest (last) tiles first. hd is zero-padded to a
// multiple of 64 (64, 128, 192, 256; the configs use 64, 112, 128 and
// 192). `mma.sync` and not `wgmma`: at the served shapes the bound is
// bytes, and a warpgroup product needs 64-row warpgroup tiles fed from
// shared memory by a producer (TMA, mbarriers), a larger redesign. Rows
// that are not 16-byte aligned are staged element by element into the
// same layout.
//
// f32: CUDA cores. TF32 keeps about three digits, which the f32 callers'
// 1e-4 tolerance and identical f32 token streams do not allow, so the
// f32 kernel keeps the first design: one CTA per (batch row, q head,
// 64-query tile), K/V tiles staged as f32 (16-byte loads where rows are
// aligned), each warp 16 query rows (8 at hd > 128), lane t scores key t
// of a 32-key chunk, PV with the lanes splitting the head dim.
//
// Bound on an H100 SXM. At the qwen3-4b prefill shape (Hq 32, Hkv 8, hd
// 128, S = T = 300, bf16) the causal work is 4 * Hq * S * T * hd / 2
// = 0.74 GFLOP against 6.1 MB of q, k, v and out: 0.0007 ms at the bf16
// tensor-core peak, 0.0018 ms at 3.35 TB/s, so the bound is bytes; on
// CUDA cores in f32 (67 TFLOP/s) the same work takes 0.011 ms at best.
// The bf16 grid there is ceil(300 * 4 / 64) * 8 = 152 CTAs (160 with
// one CTA per q head before), one per SM (registers). What holds it
// above its bound and its SDPA yardstick (PERF.md has the times): every
// query tile re-streams its band's K/V from L2, and the warps that issue
// a tile's cp.async copies stall while the L2 serves them, so copies and
// math overlap only across the two groups; with one or two warps per
// scheduler the QK, softmax and PV latencies of a tile are exposed. A
// producer warp with TMA bulk copies and wgmma consumers is the next
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

// f32 path: the CUDA-core kernel (T = float only)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One 16-byte load of `src` (4 f32) at `dst`.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) =
      __ldg(reinterpret_cast<const float4*>(src));
}

// Stage rows [0, nrows) of a tile into shared memory as f32: row r is
// position p = first + r of `src` (row stride `stride` elements), loaded
// when lo <= p < hi and zero otherwise; head dims past hd are zero. With
// `vec` every row starts 16-byte aligned (checked by the wrapper) and is
// read in 16-byte loads, several in flight per thread; else element by
// element.
template <typename T, int HDP>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int stride, int first, int lo, int hi,
                                      int nrows, int hd, bool vec) {
  if (vec) {
    constexpr int EV = 16 / sizeof(T);  // elements per 16-byte load
    constexpr int CPR = HDP / EV;       // loads per padded row
#pragma unroll 4
    for (int e = threadIdx.x; e < nrows * CPR; e += blockDim.x) {
      const int r = e / CPR;
      const int d = (e - r * CPR) * EV;
      const int p = first + r;
      float* out = dst + r * ld + d;
      if (p >= lo && p < hi && d < hd) {
        load16<T>(src + (size_t)p * stride + d, out);
      } else {
#pragma unroll
        for (int i = 0; i < EV; ++i) out[i] = 0.f;
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < nrows * HDP; e += blockDim.x) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int p = first + r;
    dst[r * ld + d] = (p >= lo && p < hi && d < hd)
                          ? to_f32(src[(size_t)p * stride + d])
                          : 0.f;
  }
}

constexpr int kBQ = 64;     // query rows per CTA
constexpr int kBK = 64;     // key positions per staged K/V tile
constexpr int kChunk = 32;  // keys scored at once, one per lane

template <int HDP>
struct Cfg {
  static constexpr int ROWS = HDP <= 128 ? 16 : 8;  // query rows per warp
  static constexpr int WARPS = kBQ / ROWS;
  static constexpr int EPL = HDP / 32;  // head dims per lane in PV
  static constexpr int KLD = HDP + 4;   // padded K row, in floats
  static constexpr size_t SMEM =
      sizeof(float) *
      ((size_t)kBQ * HDP + (size_t)kBK * KLD + (size_t)kBK * HDP +
       (size_t)kBQ * kChunk);
};

struct Strides {
  int b, h, s;
};

template <typename T, int HDP, bool LSE>
__global__ void __launch_bounds__(Cfg<HDP>::WARPS * 32)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int T_,
                 int hd, int G, Strides qs_, Strides ks_, Strides vs_,
                 Strides os_, int causal, int window, int vec,
                 float scale) {
  using C = Cfg<HDP>;
  constexpr int ROWS = C::ROWS;
  constexpr int EPL = C::EPL;
  constexpr int KLD = C::KLD;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (kBQ, HDP)
  float* ks = qs + kBQ * HDP;                    // (kBK, KLD)
  float* vs = ks + kBK * KLD;                    // (kBK, HDP)
  float* ps = vs + kBK * HDP;                    // (kBQ, kChunk)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / G;
  const int off = T_ - S;  // absolute position of query 0
  const T* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
  const T* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const T* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;

  stage<T, HDP>(qs, HDP, qb, qs_.s, q0, 0, S, kBQ, hd, vec);

  // key positions any row of this tile can see: [lo, hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int hi = causal ? min(T_, off + q_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int row0 = warp * ROWS;
  const bool warp_live = q0 + row0 < S;

  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // the query tile is staged / the last tile is done
    // positions outside [lo, hi) are zero: never read past the band
    stage<T, HDP>(ks, KLD, kb, ks_.s, t0, lo, hi, kBK, hd, vec);
    stage<T, HDP>(vs, HDP, vb, vs_.s, t0, lo, hi, kBK, hd, vec);
    __syncthreads();
    if (!warp_live) continue;
    for (int c = 0; c < kBK && t0 + c < hi; c += kChunk) {
      const int kpos = t0 + c + lane;
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      const float4* krow =
          reinterpret_cast<const float4*>(ks + (c + lane) * KLD);
#pragma unroll 4
      for (int d4 = 0; d4 < HDP / 4; ++d4) {
        const float4 kk = krow[d4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qq =
              reinterpret_cast<const float4*>(qs + (row0 + r) * HDP)[d4];
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
      float* prow = ps + row0 * kChunk;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int qpos = off + q0 + row0 + r;
        const bool ok = kpos >= lo && kpos < hi &&
                        (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        const float sc = ok ? s[r] * scale : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float p = sc == -INFINITY ? 0.f : expf(sc - m_safe);
        const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
        l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
        prow[r * kChunk + lane] = p;
      }
      __syncwarp();
#pragma unroll 2
      for (int t = 0; t < kChunk; t += 4) {
        float vv[4][EPL];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < EPL; ++i)
            vv[j][i] = vs[(c + t + j) * HDP + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 pp =
              *reinterpret_cast<const float4*>(prow + r * kChunk + t);
#pragma unroll
          for (int i = 0; i < EPL; ++i) {
            float a = acc[r][i];
            a = fmaf(pp.x, vv[0][i], a);
            a = fmaf(pp.y, vv[1][i], a);
            a = fmaf(pp.z, vv[2][i], a);
            a = fmaf(pp.w, vv[3][i], a);
            acc[r][i] = a;
          }
        }
      }
      __syncwarp();  // the chunk's probabilities are consumed
    }
  }
  if (!warp_live) return;
  T* ob = out + (size_t)b * os_.b + (size_t)h * os_.h;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + row0 + r;
    if (row >= S) break;
    if constexpr (LSE) {
      if (lane == 0)
        lse[((size_t)b * gridDim.y + h) * S + row] =
            l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) ob[(size_t)row * os_.s + d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HDP, bool LSE>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Hq, int Hkv, int S, int T_,
                      int hd, Strides qs_, Strides ks_, Strides vs_,
                      Strides os_, int causal, int window, int vec,
                      cudaStream_t stream) {
  using C = Cfg<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HDP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  const dim3 block(C::WARPS * 32);
  flash_kernel<T, HDP, LSE><<<grid, block, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, T_, hd,
      Hq / Hkv, qs_, ks_, vs_, os_, causal, window, vec,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Hq, int Hkv, int S, int T_,
                       int hd, Strides qs_, Strides ks_, Strides vs_,
                       Strides os_, int causal, int window, int vec,
                       cudaStream_t stream) {
#define FLASH_HD(HDP_)                                                     \
  case HDP_:                                                               \
    return lse ? launch_hd<float, HDP_, true>(                             \
                     q, k, v, out, lse, B, Hq, Hkv, S, T_, hd, qs_, ks_,   \
                     vs_, os_, causal, window, vec, stream)                \
               : launch_hd<float, HDP_, false>(                            \
                     q, k, v, out, lse, B, Hq, Hkv, S, T_, hd, qs_, ks_,   \
                     vs_, os_, causal, window, vec, stream)
  switch ((hd + 31) / 32 * 32) {
    FLASH_HD(32);
    FLASH_HD(64);
    FLASH_HD(96);
    FLASH_HD(128);
    FLASH_HD(160);
    FLASH_HD(192);
    FLASH_HD(224);
    FLASH_HD(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_HD
}

// ------------------------------------------------ bf16 tensor-core path
using hopper::bf16;

constexpr int kMmaRows = 64;        // packed query rows per CTA
constexpr int kGroups = 2;          // warp groups; group g takes K/V tiles
                                    // g, g + 2, ... of the band
constexpr int kGroupThreads = 128;  // 4 warps x 16 rows
constexpr int kMmaThreads = kGroups * kGroupThreads;

template <int HDP>
struct MmaCfg {
  static constexpr int BK = HDP <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int CPR = HDP / 8;              // 16-byte chunks per row
  static constexpr int TILE = BK * HDP;            // elements of a tile
  // the Q tile, then per group one K and one V tile, all bf16
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)kMmaRows * HDP + kGroups * 2 * (size_t)TILE);
};

// Stage positions [first, first + ROWS) of one K or V tile (row stride
// `stride`) into a swizzled bf16 tile, by the `nthreads` threads of a
// warp group (`tid` within it): positions outside [lo, hi) and head
// dims past hd are zero and never read from device memory. With `vec`
// (16-byte aligned rows, hd % 8 == 0) every 16-byte chunk is one
// cp.async; else element-wise loads and stores.
template <int HDP, int ROWS>
__device__ __forceinline__ void stage_kv(bf16* dst, const bf16* src,
                                         int stride, int first, int lo,
                                         int hi, int hd, bool vec, int tid,
                                         int nthreads) {
  constexpr int CPR = HDP / 8;
  if (vec) {
#pragma unroll 4
    for (int e = tid; e < ROWS * CPR; e += nthreads) {
      const int r = e / CPR;
      const int c = e - r * CPR;
      const int p = first + r;
      const bool ok = p >= lo && p < hi && c * 8 < hd;
      hopper::cp_async16(dst + hopper::swz(r, c, CPR),
                         ok ? src + (size_t)p * stride + c * 8 : src, ok);
    }
    return;
  }
  for (int e = tid; e < ROWS * HDP; e += nthreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int p = first + r;
    dst[hopper::swz(r, d / 8, CPR) + (d & 7)] =
        (p >= lo && p < hi && d < hd) ? src[(size_t)p * stride + d]
                                      : __float2bfloat16(0.f);
  }
}

template <int HDP, bool LSE>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_, int hd, int G,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     int causal, int window, int vec, float scale_log2) {
  using namespace hopper;
  using C = MmaCfg<HDP>;
  constexpr int BK = C::BK;
  constexpr int CPR = C::CPR;
  constexpr int NT = BK / 8;     // 8-key score tiles per K/V tile
  constexpr int DT = HDP / 8;    // 8-wide output tiles
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // (kMmaRows, HDP)
  bf16* kv = qs + kMmaRows * HDP;               // per group K, V

  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  const int warp = gtid / 32;  // rows warp * 16 .. + 15 of the tile
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;   // accumulator row within the warp's 16
  const int tig = lane & 3;    // accumulator column pair
  bf16* ks = kv + group * 2 * C::TILE;
  bf16* vs = ks + C::TILE;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int R = S * G;
  const int r0 = tile * kMmaRows;
  const int r_last = min(r0 + kMmaRows, R) - 1;
  const int off = T_ - S;  // absolute position of query 0
  const int pos_first = r0 / G;
  const int pos_last = r_last / G;
  // keys any row of this tile can see: [lo, hi)
  const int hi = causal ? min(T_, off + pos_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + pos_first - window + 1) : 0;
  // keys every row of this tile sees: tiles inside [full_lo, full_hi)
  // need no mask
  const int full_hi = causal ? off + pos_first + 1 : T_;
  const int full_lo = window > 0 ? off + pos_last - window + 1 : 0;

  const bf16* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const bf16* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;
  const bf16* qb = q + (size_t)b * qs_.b + (size_t)kvh * G * qs_.h;

  // the query tile: packed row r -> (position, head), zero past R / hd
  if (vec) {
    for (int e = threadIdx.x; e < kMmaRows * CPR; e += kMmaThreads) {
      const int r = e / CPR;
      const int c = e - r * CPR;
      const int pr = r0 + r;
      const bool ok = pr < R && c * 8 < hd;
      const bf16* src =
          ok ? qb + (size_t)(pr % G) * qs_.h + (size_t)(pr / G) * qs_.s +
                   c * 8
             : q;
      cp_async16(qs + swz(r, c, CPR), src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kMmaRows * HDP; e += kMmaThreads) {
      const int r = e / HDP;
      const int d = e - r * HDP;
      const int pr = r0 + r;
      qs[swz(r, d / 8, CPR) + (d & 7)] =
          (pr < R && d < hd)
              ? qb[(size_t)(pr % G) * qs_.h + (size_t)(pr / G) * qs_.s + d]
              : __float2bfloat16(0.f);
    }
  }
  int t0 = (lo / BK + group) * BK;  // this group's first tile
  if (t0 < hi)
    stage_kv<HDP, BK>(ks, kb, ks_.s, t0, lo, hi, hd, vec, gtid,
                      kGroupThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the query tile, staged by both groups, has landed

  // absolute positions of this thread's two accumulator rows
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = off + (r0 + warp * 16 + gid + 8 * i) / G;

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  // V_j is in flight during QK_j and K_j+2 (the group's next) during
  // PV_j: each copy overlaps the other product, and a thread issues half
  // a tile's copies at a time
  for (; t0 < hi; t0 += kGroups * BK) {
    stage_kv<HDP, BK>(vs, vb, vs_.s, t0, lo, hi, hd, vec, gtid,
                      kGroupThreads);
    cp_async_commit();
    cp_async_wait<1>();  // K_j has landed
    group_sync(1 + group, kGroupThreads);

    float s[NT][4];
    qk_tile<HDP, BK>(s, qs, warp * 16, ks, lane);
    // scale (base 2), mask where the tile crosses an edge
    const bool need_mask = t0 + BK > full_hi || t0 < full_lo;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int key = t0 + j * 8 + tig * 2 + (e & 1);
          const int qp = qpos[e >> 1];
          const bool ok = key < T_ && (!causal || key <= qp) &&
                          (window <= 0 || key > qp - window);
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
      }
    group_sync(1 + group, kGroupThreads);  // K_j consumed
    if (t0 + kGroups * BK < hi)
      stage_kv<HDP, BK>(ks, kb, ks_.s, t0 + kGroups * BK, lo, hi, hd, vec,
                        gtid, kGroupThreads);
    cp_async_commit();
    softmax_step<NT, DT>(s, o, m, l);
    cp_async_wait<1>();  // V_j has landed
    group_sync(1 + group, kGroupThreads);
    pv_tile<HDP, BK>(o, s, vs, lane);
    group_sync(1 + group, kGroupThreads);  // V_j consumed
  }
  cp_async_wait<0>();

  // group 1 hands (o, m, l) to group 0 through shared memory (the Q and
  // K/V tiles are consumed): thread t of group 1 holds the same rows and
  // columns as thread t of group 0
  static_assert((DT * 4 + 4) * kGroupThreads * sizeof(float) <= C::SMEM,
                "the hand-over must fit the tiles");
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_u4);
  const int slot = warp * 32 + lane;
  if (group == 1) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(j * 4 + e) * kGroupThreads + slot] = o[j][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      red[(DT * 4 + i) * kGroupThreads + slot] = m[i];
      red[(DT * 4 + 2 + i) * kGroupThreads + slot] = l[i];
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = red[(DT * 4 + i) * kGroupThreads + slot];
    const float l1 = red[(DT * 4 + 2 + i) * kGroupThreads + slot];
    const float mx = fmaxf(m[i], m1);
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    const float a0 = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_safe);
    const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - m_safe);
    l[i] = l[i] * a0 + l1 * a1;
    if constexpr (LSE) m[i] = mx;
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e)
        o[j][e] = o[j][e] * a0 +
                  red[(j * 4 + e) * kGroupThreads + slot] * a1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int pr = r0 + warp * 16 + gid + 8 * i;
    if (pr >= R) continue;
    if constexpr (LSE) {
      if (tig == 0)  // base 2 -> natural log
        lse[((size_t)b * G * gridDim.x + kvh * G + pr % G) * S + pr / G] =
            li > 0.f ? (m[i] + log2f(li)) * 0.6931471805599453f : -INFINITY;
    }
    const float inv = 1.f / fmaxf(li, 1e-30f);
    bf16* ob = out + (size_t)b * os_.b + (size_t)(kvh * G + pr % G) * os_.h +
               (size_t)(pr / G) * os_.s;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + tig * 2;
      if (d < hd) ob[d] = __float2bfloat16(o[j][2 * i] * inv);
      if (d + 1 < hd) ob[d + 1] = __float2bfloat16(o[j][2 * i + 1] * inv);
    }
  }
}

template <int HDP, bool LSE>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int Hq, int Hkv, int S,
                       int T_, int hd, Strides qs_, Strides ks_, Strides vs_,
                       Strides os_, int causal, int window, int vec,
                       cudaStream_t stream) {
  using C = MmaCfg<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HDP, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const int tiles = (S * G + kMmaRows - 1) / kMmaRows;
  if (tiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, tiles);
  flash_mma_kernel<HDP, LSE><<<grid, kMmaThreads, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, T_, hd,
      G, qs_, ks_, vs_, os_, causal, window, vec,
      1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Hq, int Hkv, int S,
                        int T_, int hd, Strides qs_, Strides ks_, Strides vs_,
                        Strides os_, int causal, int window, int vec,
                        cudaStream_t stream) {
#define FLASH_MMA(HDP_)                                                   \
  case HDP_:                                                              \
    return lse ? launch_mma<HDP_, true>(q, k, v, out, lse, B, Hq, Hkv, S,  \
                                        T_, hd, qs_, ks_, vs_, os_, causal, \
                                        window, vec, stream)                \
               : launch_mma<HDP_, false>(q, k, v, out, lse, B, Hq, Hkv, S, \
                                         T_, hd, qs_, ks_, vs_, os_, causal,\
                                         window, vec, stream)
  switch ((hd + 63) / 64 * 64) {
    FLASH_MMA(64);
    FLASH_MMA(128);
    FLASH_MMA(192);
    FLASH_MMA(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_MMA
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// lse: null, or (B, Hq, S) f32 contiguous for the rows' log-sum-exp.
// Strides are in elements; dtype: 0 = float32, 1 = bfloat16 (q, k, v and
// out alike); causal: 0 or 1; window: 0 for none; vec: 1 when every q, k
// and v row starts 16-byte aligned and hd fills whole 16-byte loads.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Hq, int Hkv, int S, int T, int hd, int q_sb, int q_sh,
    int q_ss, int k_sb, int k_sh, int k_st, int v_sb, int v_sh, int v_st,
    int o_sb, int o_sh, int o_ss, int causal, int window, int vec, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_st},
      vs_{v_sb, v_sh, v_st}, os_{o_sb, o_sh, o_ss};
  float* lse_ = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)launch_f32(q, k, v, out, lse_, B, Hq, Hkv, S, T, hd, qs_,
                           ks_, vs_, os_, causal, window, vec, st);
  if (dtype == 1)
    return (int)launch_bf16(q, k, v, out, lse_, B, Hq, Hkv, S, T, hd, qs_,
                            ks_, vs_, os_, causal, window, vec, st);
  return (int)cudaErrorInvalidValue;
}
