// Backward pass of the blocked GQA attention in flash.cu, for Hopper
// (sm_90a).
//
// Replaces: nothing on the TPU side has a backward. The reference
// trains through XLA's attention (src/repro/models/attention.py:106-132)
// and its Pallas forward `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:24) is used for serving
// only; this is the gradient of that function, which `jax.grad` of the
// reference takes through XLA. Inputs: q (B, Hq, S, hd), k / v (B, Hkv,
// T, hd), the forward's out (B, Hq, S, hd) and its per-row log-sum-exp
// lse (B, Hq, S) f32, and dout (B, Hq, S, hd). Outputs dq, dk, dv in the
// inputs' dtype (f32 or bf16). The masks are the forward's: query i of
// head h sits at absolute position T - S + i and sees key j of KV head
// h / G when j <= T - S + i (causal) and j > T - S + i - window (a
// sliding window). A row that sees no key (lse = -inf, out = 0) gets a
// zero gradient and adds nothing to dk / dv.
//
// Arithmetic: P = exp(s * scale - lse) recomputed from the saved LSE, D
// = rowsum(dO * O), dP = dO V^T, dS = P * (dP - D); dQ = scale * dS K,
// dK = scale * dS^T Q, dV = P^T dO, dk / dv summed over the G query
// heads of a KV head. Every sum, the exponentials, D and dS are f32.
//
// Two launches a call, no atomic adds into a result, so every run gives
// the same bits:
//   1. dQ: one CTA per (batch row, q head, query tile), the tiles that
//      see the most keys launched first. It computes D and writes it to a
//      scratch (B, Hq, S) for launch 2, then walks the key tiles its rows
//      can see (the causal / window band), recomputing S and dP a tile at
//      a time and accumulating dQ in registers.
//   2. dK / dV: CTAs over the work list the host plans from the shapes
//      (backward.py::plan). A key tile's items are the (query head of its
//      group, query tile) pairs that can see it; a CTA takes a run of at
//      most `chunk` of them, accumulating dK and dV in registers, the
//      longest runs launched first, so under a causal mask the tiles that
//      see every query no longer set the launch's length. A tile split
//      over several runs has each write an f32 partial; the run that
//      counts in last on the tile's counter adds them in run order.
// Why two launches: one pass that also adds dQ across key tiles would
// need atomic adds in a varying order (or a semaphore-ordered add); the
// cost is the S and dP products again in launch 1, 14 * hd flops a
// visible (query, key) pair and query head issued against 10.
//
// Two routes, chosen by dtype and head dim (neither is a fallback of the
// other):
//   bf16, hd <= 128 (every config's attention but nemotron's hd 192):
//      warpgroup MMA (kernels/include/wgmma.cuh). One warpgroup a CTA,
//      64 query rows in dQ (key tiles of 64), 64 keys in dK / dV (items
//      of 32 queries). S and dP (S^T and dP^T in dK / dV) read both
//      operands from 128-byte-swizzled tiles in shared memory; dQ, dV and
//      dK take dS, P^T or dS^T from registers, f32 rounded to bf16 as the
//      A operand (as the forward rounds P before PV), and K, dO or Q as
//      an MN-major B operand from the same tiles, so nothing is
//      transposed. cp.async stages a tile ahead of the products (K / V
//      in two stages in dQ; Q / dO, lse and D in three in dK / dV, whose
//      S^T and dP^T run under the last item's dV and dK); rows that are
//      not 16-byte aligned are staged element by element into the same
//      layout, a choice made from the inputs before the launch. A tile
//      inside the masks' band skips them; a row past S or that sees no
//      key gets P = 0 from an lse of +inf (dQ) or adds zeros (dK / dV).
//      The results go out through shared memory in 16-byte stores. hd is
//      zero-padded to 64 or 128.
//   f32, and bf16 at hd > 128: CUDA cores, 256 threads as 16 x 16, each
//      thread a register block of the (rows x keys) score tiles and of
//      the (rows x head dims) accumulators; tiles are staged element by
//      element into f32 shared memory with an odd row pitch (hd padded
//      to a multiple of 64, + 1), so the threads' column and row walks
//      are free of bank conflicts. TF32 would keep three digits, which
//      the f32 callers' 1e-4 tolerance does not allow. One CTA per key
//      tile in dK / dV (no plan).
//
// Layout: every operand is read through element strides of its batch,
// head and position axes with the head-dim stride 1, so the model's
// (B, S, H, hd) views need no copy; padded dims and rows past S / T are
// zero.
//
// Bound on an H100 SXM: at the qwen3-4b training shape (B 2, S = T =
// 1024, 32 / 8 heads of 128, causal) the backward does 10 * hd flops a
// visible (query, key) pair and query head, 43 GFLOP, against 84 MB of
// q, k, v, out, dout, dq, dk, dv and lse, so the bound is operations:
// 0.043 ms at the bf16 tensor-core peak, 0.64 ms at the f32 CUDA-core
// peak. Above it on the bf16 route: the 40 % more products issued (S and
// dP twice), one warpgroup's chain a CTA (the products of an item wait
// on its exponentials and the reverse; two CTAs an SM overlap them only
// in part), and K / V (Q / dO) read again from L2 for every query
// (key) tile. PERF.md has the times beside the bound and SDPA's
// backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "../../include/hopper.cuh"
#include "../../include/wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const bf16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int b, h, s;
};

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

template <int HDP>
struct Cfg {
  static constexpr int BQ = HDP <= 128 ? 64 : 32;  // query rows a tile
  static constexpr int BK = BQ;                    // key rows a tile
  static constexpr int LD = HDP + 1;   // f32 pitch of a Q / dO / K / V row
  static constexpr int PLD = BQ + 1;   // f32 pitch of a score tile row
  static constexpr int RQ = BQ / 16;   // query rows a thread holds
  static constexpr int RK = BK / 16;   // key rows a thread holds
  static constexpr int CD = HDP / 16;  // head dims a thread holds
  static constexpr size_t DQ_SMEM =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD + (size_t)BQ * PLD +
                       2 * BQ);
  static constexpr size_t DKV_SMEM =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD +
                       2 * (size_t)BK * PLD + 2 * BQ);
};

// Rows [first, first + nrows) of `src` (row stride `stride`) into `dst`
// as f32 at pitch HDP + 1: rows at or past `limit` and dims past hd are
// zero.
template <typename T, int HDP>
__device__ __forceinline__ void stage(float* dst, const T* src, int stride,
                                      int first, int limit, int nrows,
                                      int hd) {
  constexpr int LD = HDP + 1;
  for (int e = threadIdx.x; e < nrows * HDP; e += kThreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int p = first + r;
    dst[r * LD + d] =
        (p < limit && d < hd) ? ld_f32(src + (size_t)p * stride + d) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int key, int qpos, int causal,
                                        int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ launch 1
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ dsum, int S, int T_, int hd,
                        int G, Strides qs_, Strides ks_, Strides vs_,
                        Strides os_, Strides ds_, Strides dqs_, int causal,
                        int window, float scale) {
  using C = Cfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, PLD = C::PLD;
  constexpr int RQ = C::RQ, RK = C::RK, CD = C::CD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (BQ, LD)
  float* dOs = Qs + BQ * LD;                     // (BQ, LD)
  float* Ks = dOs + BQ * LD;                     // (BK, LD)
  float* Vs = Ks + BK * LD;                      // (BK, LD)
  float* dSs = Vs + BK * LD;                     // (BQ, PLD)
  float* Ls = dSs + BQ * PLD;                    // (BQ): lse
  float* Ds = Ls + BQ;                           // (BQ): D

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / G;
  const int off = T_ - S;  // absolute position of query 0
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
  const T* ob = o + (size_t)b * os_.b + (size_t)h * os_.h;
  const T* db = dout + (size_t)b * ds_.b + (size_t)h * ds_.h;
  const T* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const T* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;
  const size_t row_base = ((size_t)b * gridDim.y + h) * S;

  stage<T, HDP>(Qs, qb, qs_.s, q0, S, BQ, hd);
  stage<T, HDP>(dOs, db, ds_.s, q0, S, BQ, hd);
  // D = rowsum(dO * O), one warp a row; a row that sees no key keeps 0
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    float l = -INFINITY;
    if (row < S) {
      for (int d = lane; d < hd; d += 32)
        acc += ld_f32(ob + (size_t)row * os_.s + d) *
               ld_f32(db + (size_t)row * ds_.s + d);
      l = lse[row_base + row];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float dr = l == -INFINITY ? 0.f : acc;
      Ls[r] = l;
      Ds[r] = dr;
      if (row < S) dsum[row_base + row] = dr;
    }
  }

  // keys any row of this tile can see: [lo, hi)
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(T_, off + q_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + q0 - window + 1) : 0;

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  for (int t0 = (lo / BK) * BK; t0 < hi; t0 += BK) {
    __syncthreads();  // Q / dO / L / D staged; the last K / V consumed
    stage<T, HDP>(Ks, kb, ks_.s, t0, hi, BK, hd);
    stage<T, HDP>(Vs, vb, vs_.s, t0, hi, BK, hd);
    __syncthreads();
    // s = Q K^T and dP = dO V^T at rows ty + 16 i, keys tx + 16 j
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[RQ], dov[RQ], kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        dov[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
      const int qpos = off + q0 + r;
      const float l = Ls[r];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        const int key = t0 + c;
        const bool ok = q0 + r < S && key < T_ && l != -INFINITY &&
                        visible(key, qpos, causal, window);
        const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
        dSs[r * PLD + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    // dQ += dS K at rows ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dSs[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
  T* dqb = dq + (size_t)b * dqs_.b + (size_t)h * dqs_.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int d = tx + 16 * j;
      if (d < hd)
        dqb[(size_t)row * dqs_.s + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// ------------------------------------------------------------ launch 2
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const T* __restrict__ dout, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int T_, int hd, int G,
                          Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                          Strides dks_, Strides dvs_, int causal, int window,
                          float scale) {
  using C = Cfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, PLD = C::PLD;
  constexpr int RQ = C::RQ, RK = C::RK, CD = C::CD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (BK, LD)
  float* Vs = Ks + BK * LD;                      // (BK, LD)
  float* Qs = Vs + BK * LD;                      // (BQ, LD)
  float* dOs = Qs + BQ * LD;                     // (BQ, LD)
  float* Ps = dOs + BQ * LD;                     // (BK, PLD): P^T
  float* dSs = Ps + BK * PLD;                    // (BK, PLD): dS^T
  float* Ls = dSs + BK * PLD;                    // (BQ): lse
  float* Ds = Ls + BQ;                           // (BQ): D

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int k1 = min(k0 + BK, T_);  // keys [k0, k1)
  const int Hq = gridDim.y * G;
  const int off = T_ - S;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const T* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;

  stage<T, HDP>(Ks, kb, ks_.s, k0, T_, BK, hd);
  stage<T, HDP>(Vs, vb, vs_.s, k0, T_, BK, hd);

  // query rows that can see a key of this tile: [i_lo, i_hi)
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(S, k1 - 1 + window - off) : S;

  float adk[RK][CD], adv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; g < G && i_lo < i_hi; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
    const T* db = dout + (size_t)b * ds_.b + (size_t)h * ds_.h;
    const size_t row_base = ((size_t)b * Hq + h) * S;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // K / V staged; the last Q / dO / P / dS consumed
      stage<T, HDP>(Qs, qb, qs_.s, q0, S, BQ, hd);
      stage<T, HDP>(dOs, db, ds_.s, q0, S, BQ, hd);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int row = q0 + r;
        Ls[r] = row < S ? lse[row_base + row] : -INFINITY;
        Ds[r] = row < S ? dsum[row_base + row] : 0.f;
      }
      __syncthreads();
      // s^T = K Q^T and dP^T = V dO^T at keys ty + 16 i, rows tx + 16 j
      float s[RK][RQ], dp[RK][RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDP; ++d) {
        float kv[RK], vv[RK], qv[RQ], dov[RQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          dov[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int c = ty + 16 * i;
        const int key = k0 + c;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int r = tx + 16 * j;
          const float l = Ls[r];
          const bool ok = q0 + r < S && key < T_ && l != -INFINITY &&
                          visible(key, off + q0 + r, causal, window);
          const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
          Ps[c * PLD + r] = p;
          dSs[c * PLD + r] = p * (dp[i][j] - Ds[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q at keys ty + 16 i, dims tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RK], sv[RK], dor[CD], qr[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Ps[(ty + 16 * i) * PLD + r];
          sv[i] = dSs[(ty + 16 * i) * PLD + r];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          dor[j] = dOs[r * LD + tx + 16 * j];
          qr[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) {
            adv[i][j] = fmaf(pv[i], dor[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qr[j], adk[i][j]);
          }
      }
    }
  }
  T* dkb = dk + (size_t)b * dks_.b + (size_t)kvh * dks_.h;
  T* dvb = dv + (size_t)b * dvs_.b + (size_t)kvh * dvs_.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= T_) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int d = tx + 16 * j;
      if (d >= hd) continue;
      dkb[(size_t)key * dks_.s + d] = from_f32<T>(adk[i][j] * scale);
      dvb[(size_t)key * dvs_.s + d] = from_f32<T>(adv[i][j]);
    }
  }
}

// ------------------------------------------- bf16 tensor-core route
// bf16 at hd <= 128. One warpgroup (128 threads) a CTA; every product is
// a wgmma (kernels/include/wgmma.cuh) on bf16 tiles in the 128-byte
// swizzled layout in shared memory, which cp.async fills one tile ahead
// of the products (16-byte copies with zero fill; element by element for
// rows that are not 16-byte aligned, into the same layout). The
// probabilities, D and dS are f32 in registers and are rounded to bf16
// only as the A operand of the dV, dK and dQ products, as the forward
// rounds P before PV; hd is zero-padded to 64 or 128.
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int HDP>
struct WgCfg {
  static constexpr int BQ = 64;   // dQ: query rows a CTA
  static constexpr int BK = 64;   // dQ: keys a tile; dK / dV: keys a CTA
  static constexpr int BQ2 = 32;  // dK / dV: queries an item
  static constexpr int NS = 2;    // dQ: K / V stages
  static constexpr int NS2 = 3;   // dK / dV: Q / dO stages
  static constexpr int T64 = 64 * HDP;  // bf16 of a 64-row tile
  static constexpr int T32 = 32 * HDP;
  // + 1024: the tiles start 1024-byte aligned (wgmma.cuh). dQ: Q, dO,
  // then NS stages of K and V (the second holds O first); dK / dV: K, V,
  // then NS2 stages of Q, dO, lse and D
  static constexpr size_t DQ_SMEM =
      1024 + sizeof(bf16) * (2 + 2 * NS) * T64 + sizeof(float) * 2 * BQ;
  static constexpr size_t DKV_SMEM =
      1024 + sizeof(bf16) * (2 * T64 + 2 * NS2 * T32) +
      sizeof(float) * 2 * NS2 * BQ2;
};

__device__ __forceinline__ bf16* align1024(uint8_t* p) {
  return reinterpret_cast<bf16*>(p + ((1024 - (hopper::smem_addr(p) & 1023)) &
                                      1023));
}

// Rows [first, first + R) of `src` (row stride `stride`) into the wgmma
// tile `dst` by the CTA's 128 threads: rows at or past `limit` and dims
// past hd are zero. With `vec` (16-byte aligned rows, hd % 8 == 0) every
// 16-byte chunk is one cp.async (the caller commits and waits); else
// element by element.
template <int HDP, int R>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int stride, int first, int limit,
                                           int hd, bool vec) {
  if (vec) {  // thread t: chunk t % CPR of rows t / CPR + m * RS
    constexpr int CPR = HDP / 8, RS = kWgThreads / CPR;
    const int c = threadIdx.x % CPR;
    const int r0 = threadIdx.x / CPR;
    const bool cok = c * 8 < hd;
    const bf16* sp = src + (size_t)(first + r0) * stride + c * 8;
#pragma unroll
    for (int m = 0; m < R / RS; ++m) {
      const bool ok = cok && first + r0 + m * RS < limit;
      hopper::cp_async16(dst + wg::tile_off<R>(r0 + m * RS, c),
                         ok ? sp + (size_t)m * RS * stride : src, ok);
    }
    return;
  }
  // thread t: dim t % HDP of rows t / HDP + m * RS
  constexpr int RS = kWgThreads / HDP;
  const int d = threadIdx.x % HDP;
  const int r0 = threadIdx.x / HDP;
#pragma unroll 8
  for (int m = 0; m < R / RS; ++m) {
    const int r = r0 + m * RS;
    const int p = first + r;
    dst[wg::tile_off<R>(r, d >> 3) + (d & 7)] =
        (p < limit && d < hd) ? src[(size_t)p * stride + d]
                              : __float2bfloat16(0.f);
  }
}

// Entries [first, first + n) of a row of S f32 values (lse or D) into
// `dst` by cp.async; entries at or past S are 0 (their rows are masked).
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int first, int n, int S) {
  for (int r = threadIdx.x; r < n; r += kWgThreads) {
    const bool ok = first + r < S;
    hopper::cp_async4(dst + r, ok ? src + first + r : src, ok);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// f32 column pairs (8 j + 2 tig, + 1) of two accumulator rows, packed as
// the bf16 A fragments of the k-steps of a product over those columns.
template <int KS, int N>
__device__ __forceinline__ void pack_a(unsigned (&a)[KS][4],
                                       const float (&d)[N]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = hopper::pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Rows [row0, row0 + 64) of a bf16 output (row stride `stride`) from a
// warpgroup's m64 accumulator d times mul, through `tmp` (64 x (HDP + 8)
// bf16 in shared memory) so that with `vec` every thread writes whole
// 16-byte chunks: rows < limit and dims < hd. Ends with the CTA barrier
// after its reads of tmp.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* out, int stride, int row0,
                                           int limit, int hd, bool vec,
                                           const float (&d)[HDP / 2],
                                           float mul, bf16* tmp) {
  constexpr int P = HDP + 8;  // 16-byte rows, conflict-free pair stores
  const int lane = threadIdx.x % 32;
  const int rw = threadIdx.x / 32 * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tmp + (rw + 8 * i) * P + j * 8 +
                                         (lane & 3) * 2) =
          __floats2bfloat162_rn(d[4 * j + 2 * i] * mul,
                                d[4 * j + 2 * i + 1] * mul);
  __syncthreads();
  if (vec) {
    constexpr int CPR = HDP / 8;
#pragma unroll
    for (int m = 0; m < 64 * CPR / kWgThreads; ++m) {
      const int e = threadIdx.x + m * kWgThreads;
      const int r = e / CPR;
      const int c = e % CPR;
      if (row0 + r < limit && c * 8 < hd)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * stride +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(tmp + r * P + c * 8);
    }
  } else {
#pragma unroll 8
    for (int m = 0; m < 64 * HDP / kWgThreads; ++m) {
      const int e = threadIdx.x + m * kWgThreads;
      const int r = e / HDP;
      const int c = e % HDP;
      if (row0 + r < limit && c < hd)
        out[(size_t)(row0 + r) * stride + c] = tmp[r * P + c];
    }
  }
  __syncthreads();
}

// dS = P (dP - D) of a dQ tile (keys key0 + 8 j (+ 1) for rows qpos[i]),
// packed as the A fragments of dQ += dS K. MASK: keys past T and the
// causal / window masks.
template <bool MASK, int N, int KS>
__device__ __forceinline__ void dq_ds(unsigned (&a)[KS][4],
                                      const float (&s)[N],
                                      const float (&dp)[N],
                                      const float (&l)[2],
                                      const float (&dr)[2], int key0,
                                      const int (&qpos)[2], int T_,
                                      int causal, int window,
                                      float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = key0 + j * 8 + c;
        const bool ok =
            !MASK || (key < T_ && visible(key, qpos[i], causal, window));
        const float p =
            ok ? exp2f(s[4 * j + 2 * i + c] * scale_log2 - l[i]) : 0.f;
        ds[c] = p * (dp[4 * j + 2 * i + c] - dr[i]);
      }
      a[j >> 1][(j & 1) * 2 + i] = hopper::pack_bf16(ds[0], ds[1]);
    }
}

// Launch 1: dQ (and D) for the 64 query rows of one (batch row, q head,
// query tile); the key tiles its rows see, two stages of K / V.
template <int HDP>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dq_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const float* __restrict__ lse,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    float* __restrict__ dsum, int S, int T_, int hd, int G,
                    Strides qs_, Strides ks_, Strides vs_, Strides os_,
                    Strides ds_, Strides dqs_, int causal, int window,
                    int vec, float scale) {
  using C = WgCfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, T64 = C::T64;
  constexpr int KS = HDP / 16;  // k-steps over the head dims
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = align1024(smem_raw);
  bf16* dOs = Qs + T64;
  bf16* KVs = dOs + T64;  // stage s: K at KVs + 2 s T64, V after it
  float* L2 = reinterpret_cast<float*>(KVs + 2 * NS * T64);  // lse log2(e)
  float* Ds = L2 + BQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // causal: the last query tiles see the most keys and launch first
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int kvh = h / G;
  const int off = T_ - S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bf16* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
  const bf16* ob = o + (size_t)b * os_.b + (size_t)h * os_.h;
  const bf16* db = dout + (size_t)b * ds_.b + (size_t)h * ds_.h;
  const bf16* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const bf16* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;
  const size_t row_base = ((size_t)b * gridDim.x + h) * S;

  // keys any row of this tile can see: [lo, hi), in n_kt tiles
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(T_, off + q_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int t_first = (lo / BK) * BK;
  const int n_kt = hi > t_first ? (hi - t_first + BK - 1) / BK : 0;

  // Q, dO and O (into the second stage, which the loop fills only after D
  // is taken from it), then the first K / V tile, which loads under D
  bf16* Os = KVs + 2 * T64;
  stage_tile<HDP, BQ>(Qs, qb, qs_.s, q0, S, hd, vec);
  stage_tile<HDP, BQ>(dOs, db, ds_.s, q0, S, hd, vec);
  stage_tile<HDP, BQ>(Os, ob, os_.s, q0, S, hd, vec);
  hopper::cp_async_commit();
  if (n_kt > 0) {
    stage_tile<HDP, BK>(KVs, kb, ks_.s, t_first, hi, hd, vec);
    stage_tile<HDP, BK>(KVs + T64, vb, vs_.s, t_first, hi, hd, vec);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<1>();
  __syncthreads();
  // D = rowsum(dO * O) from the staged tiles, two threads a row (the
  // padded dims are zero); a row past S or that sees no key keeps 0
  {
    constexpr int CPR = HDP / 8;
    const int rr = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const int row = q0 + rr;
    float acc = 0.f;
#pragma unroll
    for (int c = half * (CPR / 2); c < (half + 1) * (CPR / 2); ++c) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          Os + wg::tile_off<BQ>(rr, c));
      const uint4 dv = *reinterpret_cast<const uint4*>(
          dOs + wg::tile_off<BQ>(rr, c));
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 a = __bfloat1622float2(o2[p]);
        const float2 g = __bfloat1622float2(d2[p]);
        acc = fmaf(a.x, g.x, acc);
        acc = fmaf(a.y, g.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float l = row < S ? lse[row_base + row] : -INFINITY;
      const float dr = l == -INFINITY ? 0.f : acc;
      L2[rr] = l == -INFINITY ? INFINITY : l * kLog2e;  // P = 0 there
      Ds[rr] = dr;
      if (row < S) dsum[row_base + row] = dr;
    }
  }
  __syncthreads();  // O read: the second stage is free
  const float scale_log2 = scale * kLog2e;
  // this thread's two accumulator rows: tile rows r[i], positions qpos[i]
  int r[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = warp * 16 + gid + 8 * i;
    qpos[i] = off + q0 + r[i];
  }
  float acc[HDP / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = dp[j] = 0.f;
  unsigned a[BK / 16][4];  // dS as the A operand of dQ += dS K
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[kk][c] = 0u;
  float l_r[2], d_r[2];  // this thread's rows' lse log2(e) and D

  for (int it = 0; it < n_kt; ++it) {
    const int t0 = t_first + it * BK;
    const bf16* Ks = KVs + (it % NS) * 2 * T64;
    const bf16* Vs = Ks + T64;
    if (it + 1 < n_kt) {  // the next K / V tile loads under these products
      bf16* nk = KVs + ((it + 1) % NS) * 2 * T64;
      stage_tile<HDP, BK>(nk, kb, ks_.s, t0 + BK, hi, hd, vec);
      stage_tile<HDP, BK>(nk + T64, vb, vs_.s, t0 + BK, hi, hd, vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    wg::fence_proxy_async();
    __syncthreads();  // this tile (and Q / dO / L2 / D) staged
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_r[i] = L2[r[i]];
        d_r[i] = Ds[r[i]];
      }
    }
    // S = Q K^T, dP = dO V^T
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss<BK>(s, wg::desc_k<BQ>(Qs, kk), wg::desc_k<BK>(Ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss<BK>(dp, wg::desc_k<BQ>(dOs, kk), wg::desc_k<BK>(Vs, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::keep(s);
    wg::keep(dp);
    // dS = P (dP - D), packed as the A operand of dQ += dS K (s and dp
    // stay written by the products alone). A row past S or that sees no
    // key has l_r = +inf, so P = 0 there; a tile inside the masks' band
    // (every key < T and seen by every row) skips the key masks.
    if (t0 + BK <= T_ && (!causal || t0 + BK - 1 <= off + q0) &&
        (window <= 0 || t0 > off + q0 + BQ - 1 - window))
      dq_ds<false>(a, s, dp, l_r, d_r, t0 + tig * 2, qpos, T_, causal,
                   window, scale_log2);
    else
      dq_ds<true>(a, s, dp, l_r, d_r, t0 + tig * 2, qpos, T_, causal,
                  window, scale_log2);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::rs<HDP>(acc, a[kk], wg::desc_mn<BK>(Ks, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(a);
    __syncthreads();  // every warp's products done with this stage
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  __syncthreads();  // every warp's products done: the stages take dQ
  store_rows<HDP>(dq + (size_t)b * dqs_.b + (size_t)h * dqs_.h, dqs_.s, q0,
                  S, hd, vec, acc, scale, KVs);
}

// Launch 2: dK / dV for the 64 keys of one (batch row, KV head, key tile)
// over one entry of the host's plan (backward.py::plan): a run of the
// tile's items, item i being query tile qt_lo + i % n_q of query head g =
// i / n_q of the group, three stages of Q / dO. A tile whose items the
// plan splits over several CTAs has each write its f32 partial dK / dV
// to a slot of `part`; the CTA that counts in last on the tile's counter
// (which it resets) adds the partials in slot order and writes dk / dv.
template <int HDP>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dkdv_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const bf16* __restrict__ dout, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, const int4* __restrict__ plan,
                      float* __restrict__ part, int* __restrict__ counters,
                      int n_slots, int S, int T_, int hd, int G, int Hkv,
                      Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                      Strides dks_, Strides dvs_, int causal, int window,
                      int vec, float scale) {
  using C = WgCfg<HDP>;
  constexpr int BK = C::BK, BQ = C::BQ2, NS = C::NS2;
  constexpr int T64 = C::T64, T32 = C::T32;
  constexpr int KS = HDP / 16;  // k-steps over the head dims
  constexpr int QS = BQ / 16;   // k-steps over an item's queries
  constexpr int PART = 2 * BK * HDP;  // f32 of a slot: dK, then dV
  extern __shared__ uint8_t smem_raw[];
  __shared__ int merge_here;
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + T64;
  bf16* QDs = Vs + T64;  // stage s: Q at QDs + 2 s T32, dO after it
  float* LDs = reinterpret_cast<float*>(QDs + 2 * NS * T32);  // lse, D

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int4 e = plan[2 * blockIdx.y];  // key tile, items [y, z), splits
  const int4 f = plan[2 * blockIdx.y + 1];  // split, first slot
  const int kt = e.x;
  const int n_items = e.z - e.y;
  const int k0 = kt * BK;
  const int k1 = min(k0 + BK, T_);
  const int Hq = Hkv * G;
  const int off = T_ - S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bf16* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const bf16* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;

  // query rows that can see a key of this tile: [i_lo, i_hi), in n_q
  // tiles from qt_lo
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(S, k1 - 1 + window - off) : S;
  const int qt_lo = i_lo / BQ;
  const int n_q = i_lo < i_hi ? (i_hi + BQ - 1) / BQ - qt_lo : 0;

  // the next item to stage: query tile qt_lo + nq of head g of the group
  int g = n_q > 0 ? e.y / n_q : 0;
  int nq = e.y - g * n_q;
  auto stage_item = [&](int st) {
    const int q0 = (qt_lo + nq) * BQ;
    const int h = kvh * G + g;
    if (++nq == n_q) {
      nq = 0;
      ++g;
    }
    bf16* qd = QDs + st * 2 * T32;
    stage_tile<HDP, BQ>(qd, q + (size_t)b * qs_.b + (size_t)h * qs_.h,
                        qs_.s, q0, S, hd, vec);
    stage_tile<HDP, BQ>(qd + T32,
                        dout + (size_t)b * ds_.b + (size_t)h * ds_.h, ds_.s,
                        q0, S, hd, vec);
    const size_t row_base = ((size_t)b * Hq + h) * S;
    stage_rows(LDs + st * 2 * BQ, lse + row_base, q0, BQ, S);
    stage_rows(LDs + st * 2 * BQ + BQ, dsum + row_base, q0, BQ, S);
  };

  stage_tile<HDP, BK>(Ks, kb, ks_.s, k0, T_, hd, vec);
  stage_tile<HDP, BK>(Vs, vb, vs_.s, k0, T_, hd, vec);
  hopper::cp_async_commit();
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_items) stage_item(j);
    hopper::cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  // this thread's two accumulator rows: keys key[i]
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + gid + 8 * i;
  float adk[HDP / 2], adv[HDP / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) adk[j] = adv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.f;

  int cq = n_q > 0 ? e.y % n_q : 0;  // the computed item's query tile
  unsigned pa[QS][4], pd[QS][4];  // P^T and dS^T as A operands
#pragma unroll
  for (int kk = 0; kk < QS; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) pa[kk][c] = pd[kk][c] = 0u;
  for (int it = 0; it < n_items; ++it) {
    const int sg = it % NS;
    hopper::cp_async_wait<NS - 2>();
    wg::fence_proxy_async();
    __syncthreads();  // item it (and K / V) staged
    const int q0 = (qt_lo + cq) * BQ;
    if (++cq == n_q) cq = 0;
    const bf16* Qs = QDs + sg * 2 * T32;
    const bf16* dOs = Qs + T32;
    const float* Ls = LDs + sg * 2 * BQ;
    const float* Dsm = Ls + BQ;
    // S^T = K Q^T, then dP^T = V dO^T (under the last item's dV and dK)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss<BQ>(st, wg::desc_k<BK>(Ks, kk), wg::desc_k<BQ>(Qs, kk), kk);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss<BQ>(dpt, wg::desc_k<BK>(Vs, kk), wg::desc_k<BQ>(dOs, kk), kk);
    wg::commit();
    // the last item's dV and dK are done on every warp: its stage takes
    // item it + NS - 1
    wg::wait<2>();
    wg::keep(pa);
    wg::keep(pd);
    __syncthreads();
    if (it + NS - 1 < n_items) stage_item((it + NS - 1) % NS);
    hopper::cp_async_commit();
    wg::wait<1>();
    wg::keep(st);
    // P^T, then dV += P^T dO (under dP^T). Rows past S (zero Q, dO and
    // D) add nothing whatever their P; an item inside the masks' band
    // (every key < T and seen by every row) skips the masks.
    float lq[BQ / 8][2], dq2[BQ / 8][2];  // the thread's rows' lse, D
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lq[j][c] = Ls[j * 8 + tig * 2 + c] * kLog2e;
        dq2[j][c] = Dsm[j * 8 + tig * 2 + c];
      }
    if (k0 + BK <= T_ && (!causal || k0 + BK - 1 <= off + q0) &&
        (window <= 0 || k0 > off + q0 + BQ - 1 - window)) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          st[4 * j + c] =
              exp2f(st[4 * j + c] * scale_log2 - lq[j][c & 1]);
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rq = j * 8 + tig * 2 + (c & 1);
          const int kq = key[c >> 1];
          const bool ok = q0 + rq < S && kq < T_ &&
                          lq[j][c & 1] != -INFINITY &&
                          visible(kq, off + q0 + rq, causal, window);
          st[4 * j + c] =
              ok ? exp2f(st[4 * j + c] * scale_log2 - lq[j][c & 1]) : 0.f;
        }
    }
    pack_a(pa, st);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < QS; ++kk)
      wg::rs<HDP>(adv, pa[kk], wg::desc_mn<BQ>(dOs, kk), 1);
    wg::commit();
    wg::wait<1>();
    wg::keep(dpt);
    // dS^T = P^T (dP^T - D), then dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        st[4 * j + c] *= dpt[4 * j + c] - dq2[j][c & 1];
    pack_a(pd, st);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < QS; ++kk)
      wg::rs<HDP>(adk, pd[kk], wg::desc_mn<BQ>(Qs, kk), 1);
    wg::commit();
  }
  wg::wait<0>();
  wg::keep(adv);
  wg::keep(adk);
  wg::keep(pa);
  wg::keep(pd);
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  bf16* dkb = dk + (size_t)b * dks_.b + (size_t)kvh * dks_.h;
  bf16* dvb = dv + (size_t)b * dvs_.b + (size_t)kvh * dvs_.h;
  if (e.w == 1) {  // the tile's only CTA
    __syncthreads();  // every warp's products done: the stages take dK, dV
    store_rows<HDP>(dkb, dks_.s, k0, T_, hd, vec, adk, scale, QDs);
    store_rows<HDP>(dvb, dvs_.s, k0, T_, hd, vec, adv, 1.f,
                    QDs + 64 * (HDP + 8));
    return;
  }
  float* slots = part + ((size_t)bh * n_slots + f.y) * PART;
  float* mine = slots + (size_t)f.x * PART;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + gid + 8 * i;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = j * 8 + tig * 2;
      *reinterpret_cast<float2*>(mine + row * HDP + d) =
          make_float2(adk[4 * j + 2 * i], adk[4 * j + 2 * i + 1]);
      *reinterpret_cast<float2*>(mine + BK * HDP + row * HDP + d) =
          make_float2(adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
    }
  }
  // count this split in; the last of the tile's splits adds them. The
  // barrier orders the CTA's partial stores before thread 0's release
  // fence and count; the last CTA's acquire fence and barrier order its
  // reads after them (as decode.cu's merge).
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + (size_t)bh * ((T_ + BK - 1) / BK) + kt;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    merge_here = atomicAdd(cnt, 1) == e.w - 1;
    if (merge_here) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      *cnt = 0;  // every split has counted
    }
  }
  __syncthreads();
  if (!merge_here) return;
  // the sum in slot order, a half slot at a time: each thread's XN float4
  // of dK and of dV, the loads of a slot all in flight together
  constexpr int XN = BK * HDP / 8 / kWgThreads;
  const float4* s4 = reinterpret_cast<const float4*>(slots);
  for (int half = 0; half < 2; ++half) {
    const int x0 = threadIdx.x + half * XN * kWgThreads;
    float4 sk[XN], sv[XN];
#pragma unroll
    for (int x = 0; x < XN; ++x) {
      sk[x] = __ldcg(s4 + x0 + x * kWgThreads);
      sv[x] = __ldcg(s4 + BK * HDP / 4 + x0 + x * kWgThreads);
    }
    for (int sp = 1; sp < e.w; ++sp) {
      const float4* p4 = s4 + (size_t)sp * (PART / 4) + x0;
      float4 a4[XN], c4[XN];
#pragma unroll
      for (int x = 0; x < XN; ++x) {
        a4[x] = __ldcg(p4 + x * kWgThreads);
        c4[x] = __ldcg(p4 + BK * HDP / 4 + x * kWgThreads);
      }
#pragma unroll
      for (int x = 0; x < XN; ++x) {
        add4(sk[x], a4[x]);
        add4(sv[x], c4[x]);
      }
    }
#pragma unroll
    for (int x = 0; x < XN; ++x) {
      const int row = (x0 + x * kWgThreads) / (HDP / 4);
      const int d0 = (x0 + x * kWgThreads) % (HDP / 4) * 4;
      const int kr = k0 + row;
      if (kr >= T_ || d0 >= hd) continue;
      const float ks4[4] = {sk[x].x, sk[x].y, sk[x].z, sk[x].w};
      const float vs4[4] = {sv[x].x, sv[x].y, sv[x].z, sv[x].w};
      if (vec) {  // 4 dims in one 8-byte store (hd % 8 == 0)
        __nv_bfloat162 o[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          o[c] = __floats2bfloat162_rn(ks4[2 * c] * scale,
                                       ks4[2 * c + 1] * scale);
          o[2 + c] = __floats2bfloat162_rn(vs4[2 * c], vs4[2 * c + 1]);
        }
        *reinterpret_cast<uint2*>(dkb + (size_t)kr * dks_.s + d0) =
            *reinterpret_cast<const uint2*>(o);
        *reinterpret_cast<uint2*>(dvb + (size_t)kr * dvs_.s + d0) =
            *reinterpret_cast<const uint2*>(o + 2);
        continue;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (d0 + c >= hd) continue;
        dkb[(size_t)kr * dks_.s + d0 + c] = __float2bfloat16(ks4[c] * scale);
        dvb[(size_t)kr * dvs_.s + d0 + c] = __float2bfloat16(vs4[c]);
      }
    }
  }
}

template <int HDP>
cudaError_t launch_wg(const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dout,
                      void* dq, void* dk, void* dv, float* dsum,
                      const int* plan, int n_entries, float* part,
                      int n_slots, int* counters, int B, int Hq, int Hkv,
                      int S, int T_, int hd, Strides qs_, Strides ks_,
                      Strides vs_, Strides os_, Strides ds_, Strides dqs_,
                      Strides dks_, Strides dvs_, int causal, int window,
                      int vec, cudaStream_t stream) {
  using C = WgCfg<HDP>;
  const float scale = 1.0f / sqrtf((float)hd);
  const int G = Hq / Hkv;
  const int n_qt = (S + C::BQ - 1) / C::BQ;
  if (!plan || n_entries <= 0 || n_entries > 65535 || n_qt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wg<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wg<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* d_ = static_cast<const bf16*>(dout);
  flash_bwd_dq_wg<HDP><<<dim3(Hq, B, n_qt), kWgThreads, C::DQ_SMEM, stream>>>(
      q_, k_, v_, static_cast<const bf16*>(o), lse, d_,
      static_cast<bf16*>(dq), dsum, S, T_, hd, G, qs_, ks_, vs_, os_, ds_,
      dqs_, causal, window, vec, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wg<HDP>
      <<<dim3(B * Hkv, n_entries), kWgThreads, C::DKV_SMEM, stream>>>(
          q_, k_, v_, lse, dsum, d_, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), reinterpret_cast<const int4*>(plan), part,
          counters, n_slots, S, T_, hd, G, Hkv, qs_, ks_, vs_, ds_, dks_,
          dvs_, causal, window, vec, scale);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dout,
                      void* dq, void* dk, void* dv, float* dsum, int B,
                      int Hq, int Hkv, int S, int T_, int hd, Strides qs_,
                      Strides ks_, Strides vs_, Strides os_, Strides ds_,
                      Strides dqs_, Strides dks_, Strides dvs_, int causal,
                      int window, cudaStream_t stream) {
  using C = Cfg<HDP>;
  const float scale = 1.0f / sqrtf((float)hd);
  const int G = Hq / Hkv;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* d_ = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, HDP>
      <<<dim3((S + C::BQ - 1) / C::BQ, Hq, B), kThreads, C::DQ_SMEM,
         stream>>>(q_, k_, v_, static_cast<const T*>(o), lse, d_,
                   static_cast<T*>(dq), dsum, S, T_, hd, G, qs_, ks_, vs_,
                   os_, ds_, dqs_, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HDP>
      <<<dim3((T_ + C::BK - 1) / C::BK, Hkv, B), kThreads, C::DKV_SMEM,
         stream>>>(q_, k_, v_, lse, dsum, d_, static_cast<T*>(dk),
                   static_cast<T*>(dv), S, T_, hd, G, qs_, ks_, vs_, ds_,
                   dks_, dvs_, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* dsum, int B, int Hq, int Hkv, int S,
                   int T_, int hd, Strides qs_, Strides ks_, Strides vs_,
                   Strides os_, Strides ds_, Strides dqs_, Strides dks_,
                   Strides dvs_, int causal, int window,
                   cudaStream_t stream) {
#define FLASH_BWD(HDP_)                                                     \
  return launch_hd<T, HDP_>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, Hq,  \
                            Hkv, S, T_, hd, qs_, ks_, vs_, os_, ds_, dqs_,   \
                            dks_, dvs_, causal, window, stream)
  // bf16 at hd <= 128 takes the tensor-core kernels: no CUDA-core
  // instantiation of it exists
  if constexpr (std::is_same<T, float>::value) {
    if (hd <= 64) FLASH_BWD(64);
    if (hd <= 128) FLASH_BWD(128);
  }
  if (hd > 128 && hd <= 192) FLASH_BWD(192);
  if (hd > 192 && hd <= 256) FLASH_BWD(256);
#undef FLASH_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` (dQ, then dK / dV) and returns the first
// cudaError_t (0 = both queued). Strides are in elements, (batch, head,
// position) of q, k, v, out, dout, dq, dk, dv in that order; lse and the
// scratch dsum are (B, Hq, S) f32 contiguous. dtype: 0 = float32, 1 =
// bfloat16 (every tensor but lse / dsum); causal: 0 or 1; window: 0 for
// none; vec: 1 when every row of the eight tensors starts 16-byte
// aligned and hd fills whole 16-byte loads (the tensor-core route's
// cp.async staging and 16-byte stores). bf16 at hd <= 128 takes the
// tensor-core kernels and needs the dK / dV plan (n_entries x 8 int32:
// key tile, first item, end item, splits, split, first slot, 0, 0;
// backward.py::plan), f32 scratch of B * Hkv * n_slots slots of 2 x 64 x
// HDP and int32 counters, B * Hkv * ceil(T / 64), all 0, which the
// kernel leaves at 0; the rest take the CUDA-core kernels and ignore
// those four.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, const void* plan, void* part, void* counters, int B, int Hq,
    int Hkv, int S, int T, int hd, int q_sb, int q_sh, int q_ss, int k_sb,
    int k_sh, int k_st, int v_sb, int v_sh, int v_st, int o_sb, int o_sh,
    int o_ss, int d_sb, int d_sh, int d_ss, int dq_sb, int dq_sh, int dq_ss,
    int dk_sb, int dk_sh, int dk_st, int dv_sb, int dv_sh, int dv_st,
    int causal, int window, int vec, int dtype, int n_entries, int n_slots,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_st},
      vs_{v_sb, v_sh, v_st}, os_{o_sb, o_sh, o_ss}, ds_{d_sb, d_sh, d_ss},
      dqs_{dq_sb, dq_sh, dq_ss}, dks_{dk_sb, dk_sh, dk_st},
      dvs_{dv_sb, dv_sh, dv_st};
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, out, l, dout, dq, dk, dv, ds, B, Hq,
                              Hkv, S, T, hd, qs_, ks_, vs_, os_, ds_, dqs_,
                              dks_, dvs_, causal, window, st);
#define FLASH_BWD_WG(HDP_)                                                  \
  return (int)launch_wg<HDP_>(                                             \
      q, k, v, out, l, dout, dq, dk, dv, ds, static_cast<const int*>(plan), \
      n_entries, static_cast<float*>(part), n_slots,                       \
      static_cast<int*>(counters), B, Hq, Hkv, S, T, hd, qs_, ks_, vs_,    \
      os_, ds_, dqs_, dks_, dvs_, causal, window, vec, st)
  if (dtype == 1 && hd <= 64) FLASH_BWD_WG(64);
  if (dtype == 1 && hd <= 128) FLASH_BWD_WG(128);
#undef FLASH_BWD_WG
  if (dtype == 1)
    return (int)launch<bf16>(q, k, v, out, l, dout, dq, dk, dv, ds, B, Hq,
                             Hkv, S, T, hd, qs_, ks_, vs_, os_, ds_, dqs_,
                             dks_, dvs_, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
