// Single-token GQA decode attention against a stripe cache, for Hopper
// (sm_90a): split-KV (flash-decoding) with the merge inside the kernel.
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
// sequence shards merge (`sharded_decode_attention`).
//
// Layouts: q (B, Hq, hd) and k / v (B, Hkv, T, hd) read through element
// strides with the head-dim stride 1, so the model's (B, T, Hkv, hd)
// stripe is read in place (transposed view, no copy); out and lse are
// contiguous. Inputs are f32 or bf16; hd <= 256; G <= 32.
//
// Bound on an H100 SXM: the bytes of the valid K/V, read once, over
// 3.35 TB/s; at 2 * G flops per byte (bf16) the function is far below
// the tensor cores' ridge, so it is memory-bound. At the serves' decode
// (B 8; qwen3-4b Hkv 8, hd 128, ~150 valid positions per row; hymba-1.5b
// Hkv 5, hd 64, ~100) that is 2.5 MB and 0.8 MB per layer and step:
// about 0.0012 and 0.0003 ms. Such a call is short and runs one or two
// CTAs per SM, so nothing hides a warp's latencies: what costs is the
// chain of dependent steps in each CTA (its first loads, its scores,
// softmax and PV, the merge) and how many launches a call takes.
//
// Design.
// - Split-KV across CTAs. The host plan (`kernel.py::plan`, a function of
//   shapes only: n_valid is never read on the host) cuts [0, T) into
//   splits of `split_len` positions (64 at T <= 2048: 16 splits over the
//   serves' 1024-position stripes; at most 32 splits, so the merge takes
//   one lane per split). The grid is (Hkv x groups of heads, B,
//   splits), split-major, so the splits that hold work dispatch first;
//   a CTA reads n_valid and the window on the device and exits at once
//   when its split lies wholly outside the row's [lo, hi). At the serves' lengths that gives
//   85 (hymba) and ~160 (qwen3-4b) working CTAs where the first design
//   had 40 and 64, each walking its whole row. (Longer splits measured
//   slower at hymba's decode: each CTA's dependent chain grows.)
// - One CTA takes all G query heads of its KV head, a warp each, so a
//   staged K/V tile serves G heads; the warp's head is fixed, so no
//   shuffle sits under a branch on the head count (such a branch costs
//   a reconvergence barrier per shuffle, which dominated PV in a first
//   version). The launch bound is 8 warps: at G > 8 the heads go to
//   ceil(G / 8) CTAs of ceil(G / groups) heads each, which stage the
//   same K/V tiles. Of the registry's configurations only nemotron-4-340b
//   (G 12) has G > 8; the served stripes have G 4 (qwen3-4b) and 5
//   (hymba-1.5b). K/V stay in q's dtype in shared memory (bf16 stays
//   bf16: half the first design's f32 staging) and arrive by 16-byte
//   `cp.async`, only the positions of the CTA's range, one 64-position
//   tile at a time. The query rows are copied the same way before
//   n_valid is read, so the two loads overlap. V rows outside the range
//   are zeroed, so a stripe tail holding NaN cannot reach PV through
//   0 * NaN; K rows there are never read unmasked. Rows that are not
//   16-byte aligned keep element-wise loads (`vec` 0).
// - Lane t owns key t of a 32-key chunk and dots it with its warp's
//   query head; the online softmax runs in f32; PV has the lanes split the head dim, the
//   chunk's probabilities broadcast by shuffles, 8 keys in flight. CUDA
//   cores, not `mma.sync`: at one query per head a 16-row MMA tile would
//   waste 16 - G of its rows.
// - The merge is inside the kernel. A row whose range lies in one split
//   is written directly by that split's CTA. Otherwise each visible
//   split writes its f32 partial (out normalised, lse) to scratch the
//   wrapper allocates once per device and stream; then the CTA counts
//   itself in on a device counter per (b, CTA of heads) (a CTA barrier,
//   one thread's release fence and `atomicAdd`). The CTA that counts last
//   merges the row's visible splits with the closed-form LSE combine
//   (`ref.py::merge_partials`) and resets the counter to 0 for the next
//   call. A call is one launch: no memset, no second merge kernel.
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

// One 16-byte chunk of a shared K row, widened to f32.
__device__ __forceinline__ void chunk_f32(const float* k, float (&f)[4]) {
  const float4 c = *reinterpret_cast<const float4*>(k);
  f[0] = c.x, f[1] = c.y, f[2] = c.z, f[3] = c.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* k,
                                          float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x, f[2 * i + 1] = p.y;
  }
}

// EPL consecutive elements of a shared V row (the lane's head dims),
// widened to f32, in the widest loads their alignment allows.
template <int EPL>
__device__ __forceinline__ void row_f32(const float* v, float (&f)[EPL]) {
  if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int d = 0; d < EPL; d += 4) {
      const float4 c = *reinterpret_cast<const float4*>(v + d);
      f[d] = c.x, f[d + 1] = c.y, f[d + 2] = c.z, f[d + 3] = c.w;
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int d = 0; d < EPL; d += 2) {
      const float2 c = *reinterpret_cast<const float2*>(v + d);
      f[d] = c.x, f[d + 1] = c.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < EPL; ++d) f[d] = v[d];
  }
}
template <int EPL>
__device__ __forceinline__ void row_f32(const __nv_bfloat16* v,
                                        float (&f)[EPL]) {
  if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int d = 0; d < EPL; d += 2) {
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(v + d));
      f[d] = c.x, f[d + 1] = c.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < EPL; ++d) f[d] = __bfloat162float(v[d]);
  }
}

constexpr int kTile = 64;     // key positions per staged K / V tile
constexpr int kMaxWarps = 8;  // warps per CTA, one query head each

// The query heads of a CTA: G split evenly over ceil(G / 8) CTAs
// (kernel.py::plan mirrors it).
inline int heads_per_cta(int G) {
  const int groups = (G + kMaxWarps - 1) / kMaxWarps;
  return (G + groups - 1) / groups;
}

template <typename T, int HDP>
struct Layout {
  static constexpr int EV = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int CPR = HDP / EV;       // copies per padded row
  static constexpr int LD = HDP + EV;        // shared row, one chunk of pad
  static constexpr int EPL = HDP / 32;       // head dims per lane in PV
};

// The CTA's query rows in f32 and as copied (q's dtype), then a K and a
// V tile (kernel.py::smem_bytes mirrors it).
template <typename T, int HDP>
size_t smem_bytes(int heads) {
  return (sizeof(float) + sizeof(T)) * (size_t)heads * HDP +
         sizeof(T) * 2 * (size_t)kTile * Layout<T, HDP>::LD;
}

// blockIdx.x is (KV head, group of heads); warp w takes head h0 + w of
// the KV head's G. In the last group a warp past its heads computes on
// the group's last head and writes nothing, so every shuffle runs with
// the whole warp.
template <typename T, int HDP>
__global__ void __launch_bounds__(32 * kMaxWarps)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ n_valid, T* __restrict__ out,
                        float* __restrict__ lse, float* part_o,
                        float* part_lse, int* counters, int Hq, int Hkv,
                        int T_, int hd, int q_sb, int q_sh, int k_sb,
                        int k_sh, int k_st, int v_sb, int v_sh, int v_st,
                        int window, int vec, int split_len, int n_splits,
                        float scale) {
  using L = Layout<T, HDP>;
  constexpr int EV = L::EV, CPR = L::CPR, LD = L::LD, EPL = L::EPL;
  extern __shared__ uint4 smem_u4[];
  __shared__ int merge_here;
  const int G = Hq / Hkv;
  const int warps = blockDim.x / 32;
  const int groups = (G + warps - 1) / warps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvh = blockIdx.x / groups;
  const int h0 = blockIdx.x % groups * warps;  // first head of the CTA
  const int nh = min(warps, G - h0);           // heads of the CTA
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const size_t row0 = (size_t)b * Hq + (size_t)kvh * G + h0;

  float* qs = reinterpret_cast<float*>(smem_u4);  // (nh, HDP) f32
  T* qraw = reinterpret_cast<T*>(qs + warps * HDP);  // (nh, HDP) copied
  T* ks = qraw + warps * HDP;                        // (kTile, LD)
  T* vs = ks + kTile * LD;                           // (kTile, LD)
  const T* qb = q + (size_t)b * q_sb + ((size_t)kvh * G + h0) * q_sh;
  if (vec) {  // the query rows are in flight while n_valid is read
    for (int e = threadIdx.x; e < nh * CPR; e += blockDim.x) {
      const int i = e / CPR;
      const int c = e - i * CPR;
      const bool ok = c * EV < hd;
      cp_async16(qraw + i * HDP + c * EV,
                 ok ? qb + (size_t)i * q_sh + c * EV : qb, ok);
    }
  }
  cp_async_commit();

  // the row's range and the splits that hold a position of it
  const int n = n_valid[b];
  const int hi = max(0, min(n, T_));
  const int lo = window > 0 ? max(0, n - window) : 0;
  const int s_first = lo / split_len;
  const int s_end = hi > lo ? (hi - 1) / split_len + 1 : s_first;
  const int n_vis = s_end - s_first;
  if (n_vis == 0 || split < s_first || split >= s_end) {
    cp_async_wait<0>();  // no copy may outlive the CTA's shared memory
    if (n_vis > 0 || split != 0) return;
    // the row sees nothing: split 0 writes out 0
    for (int e = threadIdx.x; e < nh * hd; e += blockDim.x)
      out[row0 * hd + e] = from_f32<T>(0.f);
    for (int e = threadIdx.x; e < nh; e += blockDim.x)
      lse[row0 + e] = logf(1e-30f);
    return;
  }
  const int s_lo = split * split_len;
  const int clo = max(lo, s_lo);              // this CTA's positions:
  const int chi = min(hi, s_lo + split_len);  // [clo, chi), never empty

  const T* kb = k + (size_t)b * k_sb + (size_t)kvh * k_sh;
  const T* vb = v + (size_t)b * v_sb + (size_t)kvh * v_sh;
  // copy tile positions [first, first + kTile) of K and V: only the
  // positions in [clo, chi) are read (head dims past hd zero-filled);
  // the other V rows are zeroed, so p = 0 never meets a NaN there, and
  // the other K rows are left as they are (their scores are masked)
  auto stage = [&](int first) {
    if (vec) {
      const int r0 = max(clo - first, 0);
      const int nr = min(chi - first, kTile) - r0;
#pragma unroll 4
      for (int e = threadIdx.x; e < nr * CPR; e += blockDim.x) {
        const int t = r0 + e / CPR;
        const int c = e % CPR;
        const bool ok = c * EV < hd;
        // in-tensor offsets fit 32 bits (the wrapper checks the span)
        const int p = first + t;
        cp_async16(ks + t * LD + c * EV, ok ? kb + p * k_st + c * EV : kb,
                   ok);
        cp_async16(vs + t * LD + c * EV, ok ? vb + p * v_st + c * EV : vb,
                   ok);
      }
      for (int e = threadIdx.x; e < (kTile - nr) * CPR; e += blockDim.x) {
        const int t0 = e / CPR;
        const int t = t0 < r0 ? t0 : t0 + nr;
        *reinterpret_cast<uint4*>(vs + t * LD + (e % CPR) * EV) =
            make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int e = threadIdx.x; e < 2 * kTile * HDP; e += blockDim.x) {
        const int kv = e >= kTile * HDP;
        const int rem = e - kv * kTile * HDP;
        const int t = rem / HDP;
        const int d = rem - t * HDP;
        const int p = first + t;
        const bool ok = p >= clo && p < chi && d < hd;
        (kv ? vs : ks)[t * LD + d] =
            ok ? (kv ? vb : kb)[(size_t)p * (kv ? v_st : k_st) + d]
               : from_f32<T>(0.f);
      }
    }
  };

  int t0 = s_lo + (clo - s_lo) / kTile * kTile;
  stage(t0);
  cp_async_commit();
  // the query rows as f32 while the first tile is in flight; a thread
  // widens the chunks it copied itself (its wait covers only those)
  cp_async_wait<1>();
  if (vec) {
    for (int e = threadIdx.x; e < nh * CPR; e += blockDim.x) {
      const int i = e / CPR;
      const int c = e - i * CPR;
#pragma unroll
      for (int j = 0; j < EV; ++j)
        qs[i * HDP + c * EV + j] = to_f32(qraw[i * HDP + c * EV + j]);
    }
  } else {
    for (int e = threadIdx.x; e < nh * HDP; e += blockDim.x) {
      const int i = e / HDP;
      const int d = e - i * HDP;
      qs[e] = d < hd ? to_f32(qb[(size_t)i * q_sh + d]) : 0.f;
    }
  }

  const float* qh = qs + min(warp, nh - 1) * HDP;  // this warp's head
  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int d = 0; d < EPL; ++d) acc[d] = 0.f;

  for (; t0 < chi; t0 += kTile) {
    cp_async_wait<0>();
    __syncthreads();  // the tile (and the f32 query rows) are written
    for (int c0 = 0; c0 < kTile; c0 += 32) {
      const int kpos0 = t0 + c0;
      if (kpos0 >= chi || kpos0 + 32 <= clo) continue;
      const int kpos = kpos0 + lane;
      // the score of this lane's key
      float s = 0.f;
      const T* krow = ks + (c0 + lane) * LD;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        float kf[EV];
        chunk_f32(krow + c * EV, kf);
        const float* qc = qh + c * EV;
#pragma unroll
        for (int j = 0; j < EV; j += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qc + j);
          s = fmaf(qq.x, kf[j], s);
          s = fmaf(qq.y, kf[j + 1], s);
          s = fmaf(qq.z, kf[j + 2], s);
          s = fmaf(qq.w, kf[j + 3], s);
        }
      }
      const bool ok = kpos >= clo && kpos < chi;
      const float sc = ok ? s * scale : -INFINITY;
      const float m_new = fmaxf(m, warp_max(sc));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = sc == -INFINITY ? 0.f : expf(sc - m_safe);
      const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int d = 0; d < EPL; ++d) acc[d] *= alpha;
      // all 32 keys of the chunk, 8 in flight: a key outside [clo, chi)
      // has p = 0 and a zero-filled V row
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        float vf[EPL];
        row_f32<EPL>(vs + (c0 + j) * LD + lane * EPL, vf);
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int d = 0; d < EPL; ++d) acc[d] = fmaf(pj, vf[d], acc[d]);
      }
    }
    __syncthreads();  // the tile is consumed before it is refilled
    if (t0 + kTile < chi) {
      stage(t0 + kTile);
      cp_async_commit();
    }
  }

  // this split's result for the warp's head: out normalised and its lse
  if (warp < nh) {
    const size_t row = row0 + warp;
    const float ls = fmaxf(l, 1e-30f);
    const float row_lse = (m == -INFINITY ? 0.f : m) + logf(ls);
    if (n_vis == 1) {  // the row's only split: the result is final
#pragma unroll
      for (int d = 0; d < EPL; ++d) {
        const int dd = lane * EPL + d;
        if (dd < hd) out[row * hd + dd] = from_f32<T>(acc[d] / ls);
      }
      if (lane == 0) lse[row] = row_lse;
    } else {
      const size_t prow = row * n_splits + split;
#pragma unroll
      for (int d = 0; d < EPL; ++d) {
        const int dd = lane * EPL + d;
        if (dd < hd) part_o[prow * hd + dd] = acc[d] / ls;
      }
      if (lane == 0) part_lse[prow] = row_lse;
    }
  }
  if (n_vis == 1) return;

  // count this split in; the last of the row's visible splits merges.
  // The barrier orders the CTA's partial stores before thread 0's
  // release fence and count (as CUTLASS's inter-CTA barrier does); the
  // last CTA's acquire fence and barrier order its reads after them.
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + (size_t)b * gridDim.x + blockIdx.x;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    merge_here = atomicAdd(cnt, 1) == n_vis - 1;
    if (merge_here) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      *cnt = 0;  // every visible split has counted
    }
  }
  __syncthreads();
  if (!merge_here || warp >= nh) return;
  const size_t row = row0 + warp;  // n_vis <= n_splits <= 32
  // lane s holds split s_first + s: its lse, then its weight
  const float ls =
      lane < n_vis ? __ldcg(part_lse + row * n_splits + s_first + lane)
                   : -INFINITY;
  const float mx = warp_max(ls);
  const float w = lane < n_vis ? expf(ls - mx) : 0.f;
  const float den = warp_sum(w);
  const float* po = part_o + (row * n_splits + s_first) * hd;
  float o[EPL];
#pragma unroll
  for (int d = 0; d < EPL; ++d) o[d] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_vis; ++s) {
    const float ws = __shfl_sync(0xffffffffu, w, s);
#pragma unroll
    for (int d = 0; d < EPL; ++d) {
      const int dd = lane * EPL + d;
      if (dd < hd) o[d] = fmaf(ws, __ldcg(po + (size_t)s * hd + dd), o[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < EPL; ++d) {
    const int dd = lane * EPL + d;
    if (dd < hd) out[row * hd + dd] = from_f32<T>(o[d] / den);
  }
  if (lane == 0) lse[row] = mx + logf(den);
}

template <typename T, int HDP>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* n_valid, void* out, float* lse,
                      float* part_o, float* part_lse, int* counters, int B,
                      int Hq, int Hkv, int T_, int hd, int q_sb, int q_sh,
                      int k_sb, int k_sh, int k_st, int v_sb, int v_sh,
                      int v_st, int window, int vec, int split_len,
                      int n_splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int heads = heads_per_cta(G);
  const int groups = (G + heads - 1) / heads;
  const size_t smem = smem_bytes<T, HDP>(heads);
  if (smem > 48 * 1024) {  // above the default: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(Hkv * groups, B, n_splits);
  decode_split_kernel<T, HDP><<<grid, 32 * heads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), n_valid, static_cast<T*>(out), lse, part_o,
      part_lse, counters, Hq, Hkv, T_, hd, q_sb, q_sh, k_sb, k_sh, k_st,
      v_sb, v_sh, v_st, window, vec, split_len, n_splits,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* n_valid, void* out, float* lse, float* part_o,
                   float* part_lse, int* counters, int B, int Hq, int Hkv,
                   int T_, int hd, int q_sb, int q_sh, int k_sb, int k_sh,
                   int k_st, int v_sb, int v_sh, int v_st, int window,
                   int vec, int split_len, int n_splits,
                   cudaStream_t stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > 32 || split_len <= 0 ||
      split_len % kTile || n_splits < 1 || n_splits > 32 ||
      (long long)split_len * n_splits < T_ ||
      (n_splits > 1 && !(part_o && part_lse && counters)))
    return cudaErrorInvalidValue;
#define DECODE_HD(HDP_)                                                     \
  case HDP_:                                                                \
    return launch_hd<T, HDP_>(q, k, v, n_valid, out, lse, part_o, part_lse, \
                              counters, B, Hq, Hkv, T_, hd, q_sb, q_sh,     \
                              k_sb, k_sh, k_st, v_sb, v_sh, v_st, window,   \
                              vec, split_len, n_splits, stream)
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
// whole 16-byte copies. split_len and n_splits come from the host plan;
// with n_splits > 1, part_o (B, Hq, n_splits, hd) and part_lse (B, Hq,
// n_splits) are f32 scratch and counters (B, Hkv * groups of heads)
// int32 are 0 on entry (and left 0 by the kernel).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const int* n_valid,
    void* out, float* lse, float* part_o, float* part_lse, int* counters,
    int B, int Hq, int Hkv, int T, int hd, int q_sb, int q_sh, int k_sb,
    int k_sh, int k_st, int v_sb, int v_sh, int v_st, int window, int vec,
    int split_len, int n_splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, n_valid, out, lse, part_o, part_lse,
                              counters, B, Hq, Hkv, T, hd, q_sb, q_sh, k_sb,
                              k_sh, k_st, v_sb, v_sh, v_st, window, vec,
                              split_len, n_splits, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        q, k, v, n_valid, out, lse, part_o, part_lse, counters, B, Hq, Hkv,
        T, hd, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, window, vec,
        split_len, n_splits, st);
  return (int)cudaErrorInvalidValue;
}
