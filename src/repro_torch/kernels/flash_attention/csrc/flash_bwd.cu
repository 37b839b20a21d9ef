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
// Two launches, no atomics, so every run gives the same bits:
//   1. dQ: one CTA per (batch row, q head, query tile). It stages its Q
//      and dO tiles, computes D and writes it to a scratch (B, Hq, S) for
//      launch 2, then walks the key tiles its rows can see (the causal /
//      window band), recomputing S and dP a tile at a time and
//      accumulating dQ in registers.
//   2. dK / dV: one CTA per (batch row, KV head, key tile). It stages its
//      K and V tiles once and loops over the G query heads of its group
//      and the query tiles that can see the tile, skipping fully masked
//      ones, accumulating dK and dV in registers until the one store.
//
// Two instantiations of each, chosen by dtype and head dim (neither is a
// fallback of the other):
//   bf16, hd <= 128 (every config's attention but nemotron's hd 192):
//      tensor cores. Four warps a CTA, 16 rows each (64 queries in dQ,
//      64 keys in dK / dV, which walk 32-query tiles). Tiles are bf16 in
//      shared memory, XOR-swizzled in 16-byte chunks and filled by
//      cp.async as in the forward; the five products are mma.sync
//      m16n8k16 fed by ldmatrix (kernels/include/hopper.cuh: S and dP
//      by `qk_tile`, dV, dK and dQ by `pv_tile` with the f32 P or dS in
//      registers rounded to bf16 as their A operand, as the forward
//      rounds P before PV). hd is zero-padded to 64 or 128.
//   f32, and bf16 at hd > 128: CUDA cores, 256 threads as 16 x 16, each
//      thread a register block of the (rows x keys) score tiles and of
//      the (rows x head dims) accumulators; tiles are staged element by
//      element into f32 shared memory with an odd row pitch (hd padded
//      to a multiple of 64, + 1), so the threads' column and row walks
//      are free of bank conflicts. TF32 would keep three digits, which
//      the f32 callers' 1e-4 tolerance does not allow.
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
// peak. Both routes issue two more products than that minimum (dQ's
// launch recomputes S and dP), stage every tile before they compute on
// it (no copy overlaps a product) and re-read K / V per q head in dQ, so
// they sit well above the bound; `wgmma` tiles fed by TMA, and one pass
// that accumulates dQ across key tiles, are the next steps. PERF.md has
// their times beside the bound and SDPA's backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "../../include/hopper.cuh"

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
// For bf16 at hd <= 128 the five products run as mma.sync m16n8k16 (bf16
// operands, f32 accumulate) on XOR-swizzled bf16 tiles in shared memory
// (the forward's layout and helpers, kernels/include/hopper.cuh); the
// probabilities, D and dS are f32 in registers and are rounded to bf16
// only as operands of the dV, dK and dQ products, as the forward rounds
// P before PV. Four warps a CTA, 16 rows each.
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int HDP>
struct MmaCfg {
  static constexpr int CPR = HDP / 8;  // 16-byte chunks a row
  static constexpr int BQ = 64;        // dQ: query rows a CTA
  static constexpr int BK = 64;        // dQ: keys a tile; dK / dV: keys a CTA
  static constexpr int BQ2 = 32;       // dK / dV: queries a tile
  static constexpr size_t TILE = (size_t)64 * HDP;  // bf16 of a 64-row tile
  static constexpr size_t SMEM = sizeof(bf16) * 4 * TILE +
                                 sizeof(float) * 2 * 64;
};

// Rows [first, first + ROWS) of `src` (row stride `stride`) into a
// swizzled bf16 tile by the CTA's 128 threads: rows at or past `limit`
// and dims past hd are zero. With `vec` (16-byte aligned rows, hd % 8 ==
// 0) every 16-byte chunk is one cp.async (the caller commits and
// waits); else element by element.
template <int HDP, int ROWS>
__device__ __forceinline__ void stage_swz(bf16* dst, const bf16* src,
                                          int stride, int first, int limit,
                                          int hd, bool vec) {
  constexpr int CPR = HDP / 8;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * CPR; e += kMmaThreads) {
      const int r = e / CPR;
      const int c = e - r * CPR;
      const int p = first + r;
      const bool ok = p < limit && c * 8 < hd;
      hopper::cp_async16(dst + hopper::swz(r, c, CPR),
                         ok ? src + (size_t)p * stride + c * 8 : src, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < ROWS * HDP; e += kMmaThreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int p = first + r;
    dst[hopper::swz(r, d / 8, CPR) + (d & 7)] =
        (p < limit && d < hd) ? src[(size_t)p * stride + d]
                              : __float2bfloat16(0.f);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const float* __restrict__ lse,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     float* __restrict__ dsum, int S, int T_, int hd, int G,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     Strides ds_, Strides dqs_, int causal, int window,
                     int vec, float scale) {
  using C = MmaCfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = BK / 8, DT = HDP / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + C::TILE;
  bf16* Ks = dOs + C::TILE;
  bf16* Vs = Ks + C::TILE;
  float* L2 = reinterpret_cast<float*>(Vs + C::TILE);  // lse * log2(e)
  float* Ds = L2 + 64;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
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
  const size_t row_base = ((size_t)b * gridDim.y + h) * S;

  stage_swz<HDP, BQ>(Qs, qb, qs_.s, q0, S, hd, vec);
  stage_swz<HDP, BQ>(dOs, db, ds_.s, q0, S, hd, vec);
  hopper::cp_async_commit();
  for (int r = warp; r < BQ; r += kMmaThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    float l = -INFINITY;
    if (row < S) {
      for (int d = lane; d < hd; d += 32)
        acc += __bfloat162float(ob[(size_t)row * os_.s + d]) *
               __bfloat162float(db[(size_t)row * ds_.s + d]);
      l = lse[row_base + row];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float dr = l == -INFINITY ? 0.f : acc;
      L2[r] = l * kLog2e;
      Ds[r] = dr;
      if (row < S) dsum[row_base + row] = dr;
    }
  }
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(T_, off + q_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const float scale_log2 = scale * kLog2e;
  // this thread's two accumulator rows: tile rows r[i], positions qpos[i]
  int r[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = warp * 16 + gid + 8 * i;
    qpos[i] = off + q0 + r[i];
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t0 = (lo / BK) * BK; t0 < hi; t0 += BK) {
    __syncthreads();  // the last K / V consumed
    stage_swz<HDP, BK>(Ks, kb, ks_.s, t0, hi, hd, vec);
    stage_swz<HDP, BK>(Vs, vb, vs_.s, t0, hi, hd, vec);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    hopper::qk_tile<HDP, BK>(s, Qs, warp * 16, Ks, lane);
    hopper::qk_tile<HDP, BK>(dp, dOs, warp * 16, Vs, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = t0 + j * 8 + tig * 2 + (e & 1);
        const float l = L2[r[i]];
        const bool ok = q0 + r[i] < S && key < T_ && l != -INFINITY &&
                        visible(key, qpos[i], causal, window);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - l) : 0.f;
        s[j][e] = p * (dp[j][e] - Ds[r[i]]);  // dS
      }
    hopper::pv_tile<HDP, BK>(acc, s, Ks, lane);  // dQ += dS K
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  bf16* dqb = dq + (size_t)b * dqs_.b + (size_t)h * dqs_.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r[i];
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + tig * 2;
      if (d < hd)
        dqb[(size_t)row * dqs_.s + d] = __float2bfloat16(acc[j][2 * i] * scale);
      if (d + 1 < hd)
        dqb[(size_t)row * dqs_.s + d + 1] =
            __float2bfloat16(acc[j][2 * i + 1] * scale);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_mma(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const bf16* __restrict__ dout, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int S, int T_, int hd, int G,
                       Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                       Strides dks_, Strides dvs_, int causal, int window,
                       int vec, float scale) {
  using C = MmaCfg<HDP>;
  constexpr int BK = C::BK, BQ = C::BQ2, NT = BQ / 8, DT = HDP / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + C::TILE;
  bf16* Qs = Vs + C::TILE;
  bf16* dOs = Qs + C::TILE;
  float* L2 = reinterpret_cast<float*>(dOs + C::TILE);
  float* Ds = L2 + 64;

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int k1 = min(k0 + BK, T_);
  const int Hq = gridDim.y * G;
  const int off = T_ - S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const bf16* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const bf16* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;

  stage_swz<HDP, BK>(Ks, kb, ks_.s, k0, T_, hd, vec);
  stage_swz<HDP, BK>(Vs, vb, vs_.s, k0, T_, hd, vec);
  hopper::cp_async_commit();

  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(S, k1 - 1 + window - off) : S;
  const float scale_log2 = scale * kLog2e;
  // this thread's two accumulator rows: keys key[i]
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + gid + 8 * i;
  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int g = 0; g < G && i_lo < i_hi; ++g) {
    const int h = kvh * G + g;
    const bf16* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
    const bf16* db = dout + (size_t)b * ds_.b + (size_t)h * ds_.h;
    const size_t row_base = ((size_t)b * Hq + h) * S;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // the last Q / dO / L / D consumed
      stage_swz<HDP, BQ>(Qs, qb, qs_.s, q0, S, hd, vec);
      stage_swz<HDP, BQ>(dOs, db, ds_.s, q0, S, hd, vec);
      hopper::cp_async_commit();
      for (int rr = threadIdx.x; rr < BQ; rr += kMmaThreads) {
        const int row = q0 + rr;
        L2[rr] = row < S ? lse[row_base + row] * kLog2e : -INFINITY;
        Ds[rr] = row < S ? dsum[row_base + row] : 0.f;
      }
      hopper::cp_async_wait<0>();
      __syncthreads();
      // P^T (keys x queries), then dV += P^T dO
      float p[NT][4], dp[NT][4];
      hopper::qk_tile<HDP, BQ>(p, Ks, warp * 16, Qs, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rq = j * 8 + tig * 2 + (e & 1);
          const float l = L2[rq];
          const bool ok = q0 + rq < S && key[e >> 1] < T_ &&
                          l != -INFINITY &&
                          visible(key[e >> 1], off + q0 + rq, causal, window);
          p[j][e] = ok ? exp2f(p[j][e] * scale_log2 - l) : 0.f;
        }
      hopper::pv_tile<HDP, BQ>(adv, p, dOs, lane);
      // dP^T = V dO^T, dS^T = P^T (dP^T - D), then dK += dS^T Q
      hopper::qk_tile<HDP, BQ>(dp, Vs, warp * 16, dOs, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] *= dp[j][e] - Ds[j * 8 + tig * 2 + (e & 1)];
      hopper::pv_tile<HDP, BQ>(adk, p, Qs, lane);
    }
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  bf16* dkb = dk + (size_t)b * dks_.b + (size_t)kvh * dks_.h;
  bf16* dvb = dv + (size_t)b * dvs_.b + (size_t)kvh * dvs_.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T_) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = j * 8 + tig * 2 + c;
        if (d >= hd) continue;
        dkb[(size_t)key[i] * dks_.s + d] =
            __float2bfloat16(adk[j][2 * i + c] * scale);
        dvb[(size_t)key[i] * dvs_.s + d] = __float2bfloat16(adv[j][2 * i + c]);
      }
  }
}

template <int HDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* dsum, int B,
                       int Hq, int Hkv, int S, int T_, int hd, Strides qs_,
                       Strides ks_, Strides vs_, Strides os_, Strides ds_,
                       Strides dqs_, Strides dks_, Strides dvs_, int causal,
                       int window, int vec, cudaStream_t stream) {
  using C = MmaCfg<HDP>;
  const float scale = 1.0f / sqrtf((float)hd);
  const int G = Hq / Hkv;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* d_ = static_cast<const bf16*>(dout);
  flash_bwd_dq_mma<HDP>
      <<<dim3((S + C::BQ - 1) / C::BQ, Hq, B), kMmaThreads, C::SMEM,
         stream>>>(q_, k_, v_, static_cast<const bf16*>(o), lse, d_,
                   static_cast<bf16*>(dq), dsum, S, T_, hd, G, qs_, ks_,
                   vs_, os_, ds_, dqs_, causal, window, vec, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<HDP>
      <<<dim3((T_ + C::BK - 1) / C::BK, Hkv, B), kMmaThreads, C::SMEM,
         stream>>>(q_, k_, v_, lse, dsum, d_, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), S, T_, hd, G, qs_, ks_, vs_,
                   ds_, dks_, dvs_, causal, window, vec, scale);
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
// none; vec: 1 when every q, k, v and dout row starts 16-byte aligned and
// hd fills whole 16-byte loads (the tensor-core route's cp.async
// staging). bf16 at hd <= 128 takes the tensor-core kernels, the rest the
// CUDA-core ones.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int Hq, int Hkv, int S, int T, int hd, int q_sb,
    int q_sh, int q_ss, int k_sb, int k_sh, int k_st, int v_sb, int v_sh,
    int v_st, int o_sb, int o_sh, int o_ss, int d_sb, int d_sh, int d_ss,
    int dq_sb, int dq_sh, int dq_ss, int dk_sb, int dk_sh, int dk_st,
    int dv_sb, int dv_sh, int dv_st, int causal, int window, int vec,
    int dtype, void* stream) {
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
  if (dtype == 1 && hd <= 64)
    return (int)launch_mma<64>(q, k, v, out, l, dout, dq, dk, dv, ds, B, Hq,
                               Hkv, S, T, hd, qs_, ks_, vs_, os_, ds_, dqs_,
                               dks_, dvs_, causal, window, vec, st);
  if (dtype == 1 && hd <= 128)
    return (int)launch_mma<128>(q, k, v, out, l, dout, dq, dk, dv, ds, B,
                                Hq, Hkv, S, T, hd, qs_, ks_, vs_, os_, ds_,
                                dqs_, dks_, dvs_, causal, window, vec, st);
  if (dtype == 1)
    return (int)launch<bf16>(q, k, v, out, l, dout, dq, dk, dv, ds, B, Hq,
                             Hkv, S, T, hd, qs_, ks_, vs_, os_, ds_, dqs_,
                             dks_, dvs_, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
