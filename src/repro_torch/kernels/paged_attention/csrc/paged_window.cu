// Paged-window GQA attention for Hopper (sm_90a), q_len >= 1.
//
// Replaces the TPU kernel `_paged_window_kernel`
// (src/repro/kernels/paged_attention/kernel.py:148, pallas_call at :239)
// and computes the same function: window query w of batch row b attends
// to cache positions [0, base[b] + w] of the row's paged KV, read in
// place through its block table; an optional sliding window clips the
// low side at base[b] + w + 1 - window. Outputs out (B,S,Hq,hd) in q's
// dtype and lse (B,S,Hq) in f32. Inputs are f32 or bf16; every sum is
// taken in f32.
//
// Layouts (all contiguous): q (B,S,Hq,hd); pool_k / pool_v
// (num_blocks, bs, Hkv, hd); block_table (B, max_blocks) int32;
// base_lens (B,) int32. Query head h reads KV head h / G, G = Hq / Hkv.
//
// Design. The TPU grid swept every max_blocks table entry as a
// sequential grid axis over VMEM accumulators. Here one CTA takes one
// (b, kv head, tile of the R = S*G query rows of that head); it loads
// its own block ids from the table and loops only over the blocks its
// rows can see, ceil((base[b] + last window position + 1) / bs) of them
// (from the sliding window's low edge, if any). The table tail points at
// scratch block 0 and is masked anyway, so skipping it is safe. Each K/V
// block is staged in shared memory as f32 by the whole CTA; one warp
// handles one query row: lanes split hd, a warp-shuffle dot gives each
// score, and the online softmax (running max, denominator, rescaled
// accumulator) stays in f32 registers. The write-out is acc / l and
// lse = m + log(l).
//
// Bound on an H100 SXM: the bytes of K/V the rows can see, read once,
// over 3.35 TB/s. At the serving decode shape (qwen3-4b: Hkv 8, hd 128,
// bf16) that is 2 * 8 * 128 * 2 = 4 KB of K/V per cached token per
// layer, against 2 * G = 8 flops per byte, so the kernel is memory-bound.
// What this first design leaves on the table: the K/V staging is a
// synchronous element-wise copy (no cp.async / TMA double buffering, so
// loads do not overlap the math), the dots run on CUDA cores (no mma /
// wgmma), a CTA rereads a block for every row tile of the same head, and
// at decode (S = 1) only B * Hkv CTAs exist with no split over the KV
// length to fill the 132 SMs.
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

constexpr int kMaxWarps = 8;

template <typename T, int HD>
__global__ void paged_window_kernel(const T* __restrict__ q,
                                    const T* __restrict__ pool_k,
                                    const T* __restrict__ pool_v,
                                    const int* __restrict__ table,
                                    const int* __restrict__ base_lens,
                                    T* __restrict__ out,
                                    float* __restrict__ lse, int S, int Hq,
                                    int Hkv, int bs, int max_blocks,
                                    int window, float scale) {
  constexpr int EPL = HD / 32;  // head-dim elements per lane
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, HD) staged K block
  float* vs = smem + bs * HD;  // (bs, HD) staged V block

  const int G = Hq / Hkv;
  const int R = S * G;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * warps;
  const int r = r0 + warp;  // this warp's query row: window pos r / G
  const bool active = r < R;
  const int r_last = min(r0 + warps, R) - 1;

  const int base = base_lens[b];
  const int kv_len = max_blocks * bs;
  // cache range any row of this CTA can see: [lo, hi)
  const int hi = min(base + r_last / G + 1, kv_len);
  const int lo = window > 0 ? max(base + r0 / G + 1 - window, 0) : 0;
  const int j_lo = lo / bs;
  const int j_hi = hi > 0 ? (hi + bs - 1) / bs : 0;

  const int w = active ? r / G : 0;
  const int head = kvh * G + (active ? r % G : 0);
  const int n_valid = base + w + 1;  // positions [0, n_valid) are causal
  const size_t row_off = ((size_t)b * S + w) * Hq + head;

  float qv[EPL], acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    qv[i] = active ? to_f32(q[row_off * HD + lane + 32 * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;  // running max of the scores seen
  float l = 0.f;        // running softmax denominator

  const int* trow = table + (size_t)b * max_blocks;
  for (int j = j_lo; j < j_hi; ++j) {
    const size_t phys = (size_t)trow[j];
    __syncthreads();  // every warp is done with the previous block
    for (int e = threadIdx.x; e < bs * HD; e += blockDim.x) {
      const int t = e / HD;
      const int d = e - t * HD;
      const size_t src = ((phys * bs + t) * Hkv + kvh) * HD + d;
      ks[e] = to_f32(pool_k[src]);
      vs[e] = to_f32(pool_v[src]);
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < bs; c += 32) {
      const int nt = min(32, bs - c);
      // lane t keeps the masked score of key c + t
      float my_s = -INFINITY;
      for (int t = 0; t < nt; ++t) {
        const float* krow = ks + (c + t) * HD;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) part += qv[i] * krow[lane + 32 * i];
        const float sc = warp_sum(part) * scale;
        const int kpos = j * bs + c + t;
        const bool ok =
            kpos < n_valid && (window <= 0 || kpos >= n_valid - window);
        if (lane == t) my_s = ok ? sc : -INFINITY;
      }
      const float m_new = fmaxf(m, warp_max(my_s));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = my_s == -INFINITY ? 0.f : expf(my_s - m_safe);
      const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
      for (int t = 0; t < nt; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const float* vrow = vs + (c + t) * HD;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] += pt * vrow[lane + 32 * i];
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float m_safe = m == -INFINITY ? 0.f : m;
  const float ls = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    out[row_off * HD + lane + 32 * i] = from_f32<T>(acc[i] / ls);
  if (lane == 0) lse[row_off] = m_safe + logf(ls);
}

template <typename T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* table, const int* base_lens, void* out,
                   float* lse, int B, int S, int Hq, int Hkv, int hd, int bs,
                   int max_blocks, int window, cudaStream_t stream) {
  const int R = S * (Hq / Hkv);
  const int warps = R < kMaxWarps ? R : kMaxWarps;
  const dim3 grid((R + warps - 1) / warps, Hkv, B);
  const dim3 block(32 * warps);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  const float scale = 1.0f / sqrtf((float)hd);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(pool_k);
  const T* vt = static_cast<const T*>(pool_v);
  T* ot = static_cast<T*>(out);
#define PW_LAUNCH(HD_)                                                   \
  paged_window_kernel<T, HD_><<<grid, block, smem, stream>>>(            \
      qt, kt, vt, table, base_lens, ot, lse, S, Hq, Hkv, bs, max_blocks, \
      window, scale)
  switch (hd) {
    case 32: PW_LAUNCH(32); break;
    case 64: PW_LAUNCH(64); break;
    case 128: PW_LAUNCH(128); break;
    case 256: PW_LAUNCH(256); break;
    default: return cudaErrorInvalidValue;
  }
#undef PW_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// dtype: 0 = float32, 1 = bfloat16 (q, pool_k, pool_v and out alike).
extern "C" int paged_window_attention(
    const void* q, const void* pool_k, const void* pool_v, const int* table,
    const int* base_lens, void* out, float* lse, int B, int S, int Hq,
    int Hkv, int hd, int bs, int max_blocks, int window, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, pool_k, pool_v, table, base_lens, out, lse,
                              B, S, Hq, Hkv, hd, bs, max_blocks, window, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, pool_k, pool_v, table, base_lens,
                                      out, lse, B, S, Hq, Hkv, hd, bs,
                                      max_blocks, window, st);
  return (int)cudaErrorInvalidValue;
}
