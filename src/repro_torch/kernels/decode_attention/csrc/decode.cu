// Single-token GQA decode attention against a stripe cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention/kernel.py:29, pallas_call at
// :105) and computes the same function, with one valid length per row
// where the reference takes one for the batch: query head h of row b
// attends to the positions [max(0, n - window), min(n, T)) of KV head
// h / G (G = Hq / Hkv), n = n_valid[b]. It writes out (B, Hq, hd) in q's
// dtype and lse (B, Hq) in f32 exactly as the reference's `_write` does:
// out = acc / max(l, 1e-30), lse = m_safe + log(max(l, 1e-30)), so a row
// with n = 0 gives out 0 and lse log(1e-30). The lse lets partials over
// sequence shards merge (flash-decoding).
//
// Layouts: q (B, Hq, hd) and k / v (B, Hkv, T, hd) read through element
// strides with the head-dim stride 1, so the model's (B, T, Hkv, hd)
// stripe is read in place (transposed view, no copy); out and lse are
// contiguous. Inputs are f32 or bf16; hd <= 256; G <= 32.
//
// Design. As the TPU kernel's (G, hd) tile does, one CTA takes one
// (batch row, KV head) and all G query heads of the group, one warp
// each, so each K/V tile is loaded once for G heads. The CTA loops over
// 64-position tiles of the row's valid range only, staged in shared
// memory as f32 (head dim zero-padded to a multiple of 32), in 16-byte
// loads where the rows are aligned. Scores: lane t dots key t of a
// 32-key chunk with its warp's query (float4 reads, K rows padded
// against bank conflicts). Online softmax in f32 registers; PV with the
// lanes splitting the head dim.
//
// Bound on an H100 SXM: the bytes of the valid K/V, read once, over
// 3.35 TB/s. At hymba-1.5b's decode (Hkv 5, hd 64, bf16, ~130 valid
// positions per row) that is 8 * 130 * 5 * 64 * 2 * 2 = 1.3 MB per layer
// and step, at 2 * G = 10 flops per byte: memory-bound. What this first
// design leaves on the table: only B * Hkv CTAs (40 at hymba's decode)
// with no split over T inside the kernel (flash-decoding across CTAs),
// synchronous K/V staging (no cp.async / TMA double buffering), CUDA-core
// dots.
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

constexpr int kBK = 64;     // key positions per staged K/V tile
constexpr int kChunk = 32;  // keys scored at once, one per lane

template <int HDP>
struct Cfg {
  static constexpr int EPL = HDP / 32;  // head dims per lane in PV
  static constexpr int KLD = HDP + 4;   // padded K row, in floats
  static size_t smem(int G) {
    return sizeof(float) * ((size_t)G * HDP + (size_t)kBK * KLD +
                            (size_t)kBK * HDP);
  }
};

template <typename T, int HDP>
__global__ void decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ n_valid,
                              T* __restrict__ out, float* __restrict__ lse,
                              int Hq, int T_, int hd, int q_sb, int q_sh,
                              int k_sb, int k_sh, int k_st, int v_sb,
                              int v_sh, int v_st, int window, int vec,
                              float scale) {
  constexpr int EPL = Cfg<HDP>::EPL;
  constexpr int KLD = Cfg<HDP>::KLD;
  extern __shared__ float4 smem4[];
  const int G = blockDim.x / 32;
  float* qs = reinterpret_cast<float*>(smem4);  // (G, HDP)
  float* ks = qs + G * HDP;                      // (kBK, KLD)
  float* vs = ks + kBK * KLD;                    // (kBK, HDP)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h = kvh * G + warp;
  const T* kb = k + (size_t)b * k_sb + (size_t)kvh * k_sh;
  const T* vb = v + (size_t)b * v_sb + (size_t)kvh * v_sh;

  stage<T, HDP>(qs, HDP, q + (size_t)b * q_sb + (size_t)kvh * G * q_sh, q_sh,
                0, 0, G, G, hd, vec);

  const int n = n_valid[b];
  const int hi = max(0, min(n, T_));
  const int lo = window > 0 ? max(0, n - window) : 0;

  float m = -INFINITY;  // running max of the scores seen
  float l = 0.f;        // running softmax denominator
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // the query is staged / the last tile is done
    // positions outside [lo, hi) are zero: never read past the valid
    // range (a stripe's tail may hold anything)
    stage<T, HDP>(ks, KLD, kb, k_st, t0, lo, hi, kBK, hd, vec);
    stage<T, HDP>(vs, HDP, vb, v_st, t0, lo, hi, kBK, hd, vec);
    __syncthreads();
    for (int c = 0; c < kBK && t0 + c < hi; c += kChunk) {
      const int kpos = t0 + c + lane;
      const float4* krow =
          reinterpret_cast<const float4*>(ks + (c + lane) * KLD);
      const float4* qrow = reinterpret_cast<const float4*>(qs + warp * HDP);
      float s = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < HDP / 4; ++d4) {
        const float4 kk = krow[d4];
        const float4 qq = qrow[d4];
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      const bool ok = kpos >= lo && kpos < hi;
      const float sc = ok ? s * scale : -INFINITY;
      const float m_new = fmaxf(m, warp_max(sc));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = sc == -INFINITY ? 0.f : expf(sc - m_safe);
      const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
      m = m_new;
#pragma unroll 4
      for (int t = 0; t < kChunk; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const float* vrow = vs + (c + t) * HDP;
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          acc[i] = fmaf(pt, vrow[lane + 32 * i], acc[i]);
      }
    }
  }
  const float m_safe = m == -INFINITY ? 0.f : m;
  const float ls = fmaxf(l, 1e-30f);
  const size_t row = (size_t)b * Hq + h;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[row * hd + d] = from_f32<T>(acc[i] / ls);
  }
  if (lane == 0) lse[row] = m_safe + logf(ls);
}

template <typename T, int HDP>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* n_valid, void* out, float* lse, int B,
                      int Hq, int Hkv, int T_, int hd, int q_sb, int q_sh,
                      int k_sb, int k_sh, int k_st, int v_sb, int v_sh,
                      int v_st, int window, int vec, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = Cfg<HDP>::smem(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  const dim3 block(32 * G);
  decode_kernel<T, HDP><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), n_valid, static_cast<T*>(out), lse, Hq, T_,
      hd, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, window, vec,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* n_valid, void* out, float* lse, int B, int Hq,
                   int Hkv, int T_, int hd, int q_sb, int q_sh, int k_sb,
                   int k_sh, int k_st, int v_sb, int v_sh, int v_st,
                   int window, int vec, cudaStream_t stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > 32) return cudaErrorInvalidValue;
#define DECODE_HD(HDP_)                                                  \
  case HDP_:                                                             \
    return launch_hd<T, HDP_>(q, k, v, n_valid, out, lse, B, Hq, Hkv, T_, \
                              hd, q_sb, q_sh, k_sb, k_sh, k_st, v_sb,    \
                              v_sh, v_st, window, vec, stream)
  switch ((hd + 31) / 32 * 32) {
    DECODE_HD(32);
    DECODE_HD(64);
    DECODE_HD(96);
    DECODE_HD(128);
    DECODE_HD(160);
    DECODE_HD(192);
    DECODE_HD(224);
    DECODE_HD(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_HD
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// Strides are in elements; n_valid is (B,) int32 on the device; dtype:
// 0 = float32, 1 = bfloat16 (q, k, v and out alike); window: 0 for none;
// vec: 1 when every q, k and v row starts 16-byte aligned and hd fills
// whole 16-byte loads.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const int* n_valid,
    void* out, float* lse, int B, int Hq, int Hkv, int T, int hd, int q_sb,
    int q_sh, int k_sb, int k_sh, int k_st, int v_sb, int v_sh, int v_st,
    int window, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, n_valid, out, lse, B, Hq, Hkv, T, hd,
                              q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                              window, vec, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, n_valid, out, lse, B, Hq, Hkv,
                                      T, hd, q_sb, q_sh, k_sb, k_sh, k_st,
                                      v_sb, v_sh, v_st, window, vec, st);
  return (int)cudaErrorInvalidValue;
}
