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
// Layouts: q / out (B, Hq, S, hd), k / v (B, Hkv, T, hd), each read
// through element strides of its batch, head and position axes with the
// head-dim stride 1. So the model's (B, S, H, hd) tensors (k and v are
// non-contiguous slices of one projection) and the reference's
// (B, H, S, hd) layout are both read without a copy. Inputs are f32 or
// bf16; hd <= 256, any S, T >= 1 (no multiple-of-tile gate).
//
// Design. The TPU grid swept the KV blocks as a sequential grid axis
// over VMEM accumulators. Here one CTA takes one (batch row, q head,
// 64-query tile) and loops over 64-position K/V tiles itself, loading
// only the tiles that intersect the tile's causal / window band. The
// query tile and each K/V tile are staged in shared memory as f32 (head
// dim zero-padded to a multiple of 32), in 16-byte loads where the rows
// are aligned. Each warp owns 16 query rows (8 at hd > 128). Scores:
// lane t takes key t of a 32-key chunk and dots it with the warp's rows (float4 reads: K row per lane, padded to avoid
// bank conflicts; Q rows as broadcasts). The online softmax (running
// max, denominator, rescaled accumulator) stays in f32 registers; the
// chunk's probabilities go through shared memory to the PV product,
// where the lanes split the head dim.
//
// Bound on an H100 SXM. At the qwen3-4b prefill shape (Hq 32, Hkv 8, hd
// 128, S = T = 300, bf16) the causal work is 4 * Hq * S * T * hd / 2
// = 0.74 GFLOP against 6.1 MB of q, k, v and out: 0.0007 ms at the bf16
// tensor-core peak, 0.0018 ms at 3.35 TB/s, so the bound is bytes; on
// CUDA cores in f32 (67 TFLOP/s) the same work takes 0.011 ms at best.
// What this first design leaves on the table: the dots run on CUDA
// cores (no mma / wgmma), the K/V staging is synchronous (no cp.async /
// TMA double buffering, so loads do not overlap the math), and the G
// query heads of one KV head each load the same K/V tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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

// One 16-byte load of `src` (4 f32 or 8 bf16), widened to f32 at `dst`.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) =
      __ldg(reinterpret_cast<const float4*>(src));
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
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

template <typename T, int HDP>
__global__ void __launch_bounds__(Cfg<HDP>::WARPS * 32)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
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
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) ob[(size_t)row * os_.s + d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int Hq, int Hkv, int S, int T_, int hd,
                      Strides qs_, Strides ks_, Strides vs_, Strides os_,
                      int causal, int window, int vec, cudaStream_t stream) {
  using C = Cfg<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  const dim3 block(C::WARPS * 32);
  flash_kernel<T, HDP><<<grid, block, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_, hd, Hq / Hkv,
      qs_, ks_, vs_, os_, causal, window, vec, 1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Hq, int Hkv, int S, int T_, int hd,
                   Strides qs_, Strides ks_, Strides vs_, Strides os_,
                   int causal, int window, int vec, cudaStream_t stream) {
#define FLASH_HD(HDP_)                                                     \
  case HDP_:                                                               \
    return launch_hd<T, HDP_>(q, k, v, out, B, Hq, Hkv, S, T_, hd, qs_,    \
                              ks_, vs_, os_, causal, window, vec, stream)
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

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// Strides are in elements; dtype: 0 = float32, 1 = bfloat16 (q, k, v and
// out alike); causal: 0 or 1; window: 0 for none; vec: 1 when every q, k
// and v row starts 16-byte aligned and hd fills whole 16-byte loads.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int S, int T, int hd, int q_sb, int q_sh, int q_ss, int k_sb,
    int k_sh, int k_st, int v_sb, int v_sh, int v_st, int o_sb, int o_sh,
    int o_ss, int causal, int window, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_st},
      vs_{v_sb, v_sh, v_st}, os_{o_sb, o_sh, o_ss};
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, B, Hq, Hkv, S, T, hd, qs_, ks_,
                              vs_, os_, causal, window, vec, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, T, hd,
                                      qs_, ks_, vs_, os_, causal, window,
                                      vec, st);
  return (int)cudaErrorInvalidValue;
}
