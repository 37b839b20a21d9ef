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
//   1. dQ: one CTA per (q head, batch row, query tile), the tiles that
//      see the most keys launched first. It computes D and writes it to a
//      scratch (B, Hq, S) for launch 2, then walks the key tiles its rows
//      can see (the causal / window band), recomputing S and dP a tile at
//      a time and accumulating dQ in registers.
//   2. dK / dV: CTAs over the work list the host plans from the shapes
//      (backward.py::plan), on both routes. A key tile's items are the
//      (query head of its group, 32-query tile) pairs that can see it; a
//      CTA takes a run of at most `chunk` of them, accumulating dK and dV
//      in registers, the longest runs launched first, so under a causal
//      mask the tiles that see every query no longer set the launch's
//      length. A tile split over several runs has each write an f32
//      partial; the run that counts in last on the tile's counter adds
//      them in run order.
// Why two launches: one pass that also adds dQ across key tiles would
// need atomic adds in a varying order (or a semaphore-ordered add); the
// cost is the S and dP products again in launch 1, 14 * hd flops a
// visible (query, key) pair and query head issued against 10.
//
// Two routes, one for each dtype (neither is a fallback of the other; a
// call that neither takes returns cudaErrorInvalidValue):
//   bf16, hd <= 256: warpgroup MMA (kernels/include/wgmma.cuh). Operand
//      tiles are bf16 in shared memory in the 128-byte swizzle, a row
//      being HDP / 64 swizzle atoms of 64 elements (HDP = hd padded to
//      64, 128, 192 or 256). S and dP (S^T and dP^T in dK / dV) read both
//      operands from those tiles; dQ, dV and dK take dS, P^T or dS^T from
//      registers, f32 rounded to bf16 as the A operand (as the forward
//      rounds P before PV), and K, dO or Q as an MN-major B operand from
//      the same tiles, so nothing is transposed. cp.async stages a tile
//      ahead of the products (K / V in two stages in dQ; Q / dO, lse and
//      D in three in dK / dV); rows that are not 16-byte aligned are
//      staged element by element into the same layout, a choice made
//      from the inputs before the launch. A tile inside the masks' band
//      skips them; a row past S or that sees no key gets P = 0 from an
//      lse of +inf (dQ) or adds zeros (dK / dV). Results go out through
//      shared memory in 16-byte stores.
//      dQ: one warpgroup per 64 query rows; key tiles of 64 at HDP 64 /
//      128 and of 32 at HDP 192 / 256, where S and dP take 16 + 16
//      registers a thread beside the 96 / 128 of the dQ accumulator.
//      dK / dV over a 64-key tile. At HDP 64 / 128 one warpgroup holds dK
//      and dV (HDP registers a thread), items of 32 queries, and runs an
//      item's S^T and dP^T under the last item's dV and dK. At HDP 192 /
//      256 that would be 192 / 256 accumulator registers a thread, so a
//      CTA has two warpgroups (256 threads, one CTA an SM): warpgroup 0
//      owns dK, warpgroup 1 dV (96 / 128 registers a thread). For each
//      item warpgroup 0 computes S^T = K Q^T and P^T, warpgroup 1 dP^T =
//      V dO^T; they trade P^T (bf16 A fragments) and dP^T (f32) through
//      shared memory in the accumulators' own layout, and then warpgroup
//      0 forms dS^T and adds dK += dS^T Q while warpgroup 1 adds dV +=
//      P^T dO. Items are 64 queries at HDP 192 (S^T and dP^T 32 registers
//      a thread, P^T 16, up to 232 a thread in all: K and V are read once
//      per 64 queries and the products are m64n64) and 32 at HDP 256
//      (16 and 8 beside the 128 of the accumulator). Every product is
//      issued once, by one warpgroup, over all of hd: no partial is
//      summed across warpgroups, so the bits do not depend on timing.
//   f32: CUDA cores. TF32 keeps three decimal digits, which the f32
//      callers' contract does not allow (1e-4 of the largest gradient in
//      chip_smoke's 13a and the card tests, each leaf of 13c / 13f's
//      train gradients within 1e-4), so every product is an f32 FMA.
//      Tiles are staged row-major at a pitch of HDP + 4 floats by 16-byte
//      cp.async into two stages (the next K / V tile in dQ, the next Q /
//      dO items in dK / dV arrive under the current products; element by
//      element where rows are not 16-byte aligned). Every product reads
//      shared memory in float4 loads: along hd in S / dP (S^T / dP^T) and
//      for the B operand of dQ, dK and dV; along the 4 rows a thread owns
//      for its dS / P^T / dS^T operand, which the score threads write as
//      float4. At the pitch of HDP + 4 floats eight consecutive rows fall
//      in eight distinct 16-byte bank groups, and the threads of a
//      quarter warp read either distinct consecutive rows or one address,
//      so the loads are free of bank conflicts. Half the threads compute
//      S (S^T), half dP (dP^T), a register block of 4 rows x 8 keys
//      (queries) a thread at HDP 64 / 128 and of 4 x 4 at HDP 192 / 256,
//      whose 32-row tiles are what two stages of f32 tiles leave room for
//      in 227 KB; the dP threads then form dS (dS^T) from P, and every
//      thread adds 4 rows x 8 (HDP 64 / 128) or 12 / 16 (HDP 192 / 256)
//      dims of dQ, or of both dK and dV. dQ: query tiles of 64 (32 at HDP
//      192 / 256), key tiles of 32 (64 at HDP 128). dK / dV: key tiles of
//      64 (32 at HDP 192 / 256), planned as bf16, items of 32 queries.
//      At HDP 128 a CTA has 8 warps in both launches (dQ 64-key tiles;
//      dK / dV two items a step, P^T and dS^T sharing one buffer), so
//      the one CTA that 221 KB of f32 tiles leave an SM still has two
//      warps a scheduler; elsewhere 4 warps (two CTAs an SM at HDP 64).
//
// Layout: every operand is read through element strides of its batch,
// head and position axes with the head-dim stride 1, so the model's
// (B, S, H, hd) views need no copy; padded dims and rows past S / T are
// zero.
//
// Bound on an H100 SXM: the backward does 10 * hd flops a visible
// (query, key) pair and query head. At the qwen3-4b training shape (B 2,
// S = T = 1024, 32 / 8 heads of 128, causal) that is 43 GFLOP against 84
// MB of q, k, v, out, dout, dq, dk, dv and lse: operations, 0.043 ms at
// the bf16 tensor-core peak, 0.64 ms at the f32 CUDA-core peak. At
// nemotron-4-340b's attention (B 1, S = T = 4096, 96 / 8 heads of 192,
// causal, bf16) it is 1.55 TFLOP against 656 MB: 1.564 ms of operations
// (bytes would allow 0.196 ms). Above it on the bf16 route: the 40 %
// more products issued (S and dP twice), the products of an item waiting
// on its exponentials and the reverse, and K / V (Q / dO) read again from
// L2 for every query (key) tile. PERF.md has the times beside the bound
// and SDPA's backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"
#include "../../include/wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  int b, h, s;
};

constexpr int kWgThreads = 128;  // a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int key, int qpos, int causal,
                                        int window) {
  return (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x[0..3] * mul to p[0..n) (n >= 4 with vec: one 16-byte f32 or 8-byte
// bf16 store).
__device__ __forceinline__ void put4(float* p, const float (&x)[4],
                                     float mul, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n) p[c] = x[c] * mul;
}
__device__ __forceinline__ void put4(bf16* p, const float (&x)[4],
                                     float mul, int n, bool vec) {
  if (vec) {
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(x[0] * mul, x[1] * mul),
                           __floats2bfloat162_rn(x[2] * mul, x[3] * mul)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(o);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n) p[c] = __float2bfloat16(x[c] * mul);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// ---------------------------------------- split key tiles (both routes)
// Counts this CTA's split of a key tile in on the tile's counter; true
// for the CTA that counts in last, which resets it to 0. The barrier
// orders the CTA's partial stores before thread 0's release fence and
// count; the last CTA's acquire fence and barrier order its reads after
// them (as decode.cu's merge).
__device__ __forceinline__ bool count_in(int* cnt, int splits) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last = atomicAdd(cnt, 1) == splits - 1;
    if (last) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      *cnt = 0;  // every split has counted
    }
  }
  __syncthreads();
  return last;
}

// The sum of a key tile's `splits` f32 partial slots (each dK then dV,
// [key][dim] at HDP) in slot order, by the CTA's NT threads, a half slot
// at a time (each thread's XN float4 of dK and of dV, the loads of a slot
// all in flight together), written to dk (times scale) and dv: keys < T,
// dims < hd.
template <typename T, int BK, int HDP, int NT>
__device__ __forceinline__ void merge_slots(const float* slots, int splits,
                                            T* dkb, int dk_s, T* dvb,
                                            int dv_s, int k0, int T_,
                                            int hd, bool vec, float scale) {
  constexpr int XN = BK * HDP / 8 / NT;
  constexpr int PART = 2 * BK * HDP;
  const float4* s4 = reinterpret_cast<const float4*>(slots);
  for (int half = 0; half < 2; ++half) {
    const int x0 = threadIdx.x + half * XN * NT;
    float4 sk[XN], sv[XN];
#pragma unroll
    for (int x = 0; x < XN; ++x) {
      sk[x] = __ldcg(s4 + x0 + x * NT);
      sv[x] = __ldcg(s4 + BK * HDP / 4 + x0 + x * NT);
    }
    for (int sp = 1; sp < splits; ++sp) {
      const float4* p4 = s4 + (size_t)sp * (PART / 4) + x0;
      float4 a4[XN], c4[XN];
#pragma unroll
      for (int x = 0; x < XN; ++x) {
        a4[x] = __ldcg(p4 + x * NT);
        c4[x] = __ldcg(p4 + BK * HDP / 4 + x * NT);
      }
#pragma unroll
      for (int x = 0; x < XN; ++x) {
        add4(sk[x], a4[x]);
        add4(sv[x], c4[x]);
      }
    }
#pragma unroll
    for (int x = 0; x < XN; ++x) {
      const int row = (x0 + x * NT) / (HDP / 4);
      const int d0 = (x0 + x * NT) % (HDP / 4) * 4;
      const int kr = k0 + row;
      if (kr >= T_ || d0 >= hd) continue;
      const float ks4[4] = {sk[x].x, sk[x].y, sk[x].z, sk[x].w};
      const float vs4[4] = {sv[x].x, sv[x].y, sv[x].z, sv[x].w};
      put4(dkb + (size_t)kr * dk_s + d0, ks4, scale, hd - d0, vec);
      put4(dvb + (size_t)kr * dv_s + d0, vs4, 1.f, hd - d0, vec);
    }
  }
}

// ------------------------------------------------ f32 CUDA-core route
constexpr int kF32Threads = 128;

template <int HDP>
struct F32Cfg {
  static constexpr int LD = HDP + 4;                // f32 pitch of a row
  static constexpr int BQ = HDP <= 128 ? 64 : 32;   // dQ: query rows a CTA
  static constexpr int BKQ = HDP == 128 ? 64 : 32;  // dQ: keys a tile
  // dQ: threads a CTA (8 warps where its tiles fill the SM's shared
  // memory, so one CTA an SM still has two warps a scheduler)
  static constexpr int NTQ = HDP == 128 ? 256 : kF32Threads;
  static constexpr int BK = HDP <= 128 ? 64 : 32;   // dK / dV: keys a CTA
  static constexpr int BQ2 = 32;                    // dK / dV: queries an item
  // dK / dV: items a step (two at HDP 128: 8 warps, as dQ) and threads
  static constexpr int IT = HDP == 128 ? 2 : 1;
  static constexpr int NTK = IT * kF32Threads;
  static constexpr int QR = IT * BQ2;  // query rows a step
  // dQ: Q, dO, two stages of K and V, P / dS (BKQ, BQ + 4), lse, D
  static constexpr size_t DQ_SMEM =
      sizeof(float) * ((size_t)(2 * BQ + 4 * BKQ) * LD +
                       (size_t)BKQ * (BQ + 4) + 2 * BQ);
  // dK / dV: K, V, two stages of Q, dO, lse and D, P^T and dS^T (QR, BK
  // + 4; one buffer at two items a step, dS^T taking P^T's place)
  static constexpr size_t DKV_SMEM =
      sizeof(float) * ((size_t)(2 * BK + 4 * QR) * LD +
                       (IT == 2 ? 1 : 2) * (size_t)QR * (BK + 4) + 4 * QR);
};

// Rows [first, first + R) of `src` (row stride `stride`) into `dst` at
// pitch HDP + 4 by the CTA's NT threads: rows at or past `limit` and
// dims past hd are zero. With `vec` (16-byte aligned rows, hd % 4 == 0)
// every 16-byte chunk is one cp.async (the caller commits and waits);
// else element by element.
template <int HDP, int R, int NT>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int stride, int first, int limit,
                                          int hd, bool vec) {
  constexpr int LD = HDP + 4, CPR = HDP / 4;
  if (vec) {
#pragma unroll
    for (int m = 0; m < R * CPR / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      const int r = e / CPR, c = e % CPR;
      const bool ok = c * 4 < hd && first + r < limit;
      hopper::cp_async16(dst + r * LD + c * 4,
                         ok ? src + (size_t)(first + r) * stride + c * 4
                            : src,
                         ok);
    }
    return;
  }
#pragma unroll 8
  for (int m = 0; m < R * HDP / NT; ++m) {
    const int e = threadIdx.x + m * NT;
    const int r = e / HDP, d = e % HDP;
    const int p = first + r;
    dst[r * LD + d] =
        (p < limit && d < hd) ? src[(size_t)p * stride + d] : 0.f;
  }
}

// Entries [first, first + n) of a row of S f32 values (lse or D) into
// `dst` by cp.async, NT threads; entries at or past S are 0 (their rows
// are masked).
template <int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int first, int n, int S) {
  for (int r = threadIdx.x; r < n; r += NT) {
    const bool ok = first + r < S;
    hopper::cp_async4(dst + r, ok ? src + first + r : src, ok);
  }
}

// A score tile, M rows by N columns, of one of the H-thread halves of
// the CTA (t in [0, H)): acc[i][j] = sum_d A[4 rg + i][d] Bm[cg + NCG
// j][d] over the HDP dims of two f32 tiles at pitch HDP + 4, in float4
// steps along d; rg = t / NCG, cg = t % NCG, NCG = 4 H / M column
// groups, NC = M N / 4 H columns a thread. A quarter warp reads 2 rows
// of A (4 apart) and 4 rows of Bm (NCG 4), or one row of A and 8
// consecutive rows of Bm (NCG 8): distinct bank groups or one address.
// U float4 steps are unrolled: U operand sets in registers at once.
template <int M, int N, int HDP, int H, int U>
__device__ __forceinline__ void score_tile(float (&acc)[4][M * N / 4 / H],
                                           const float* A, const float* Bm,
                                           int t) {
  constexpr int LD = HDP + 4, NCG = 4 * H / M, NC = M * N / 4 / H;
  const int rg = t / NCG, cg = t % NCG;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  const float* a = A + 4 * rg * LD;
  const float* b = Bm + cg * LD;
#pragma unroll U
  for (int d = 0; d < HDP; d += 4) {
    float4 av[4], bv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * LD + d);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * NCG * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// Writes a score thread's block (rows 4 rg + i, columns cg + NCG j) as
// W[column][4 rg .. 4 rg + 3], float4 a column, W at pitch M + 4.
template <int M, int N, int H>
__device__ __forceinline__ void put_scores(float* W,
                                           const float (&v)[4][M * N / 4 / H],
                                           int t) {
  constexpr int NCG = 4 * H / M, NC = M * N / 4 / H;
  const int rg = t / NCG, cg = t % NCG;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    *reinterpret_cast<float4*>(W + (cg + NCG * j) * (M + 4) + 4 * rg) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

template <int M, int N, int H>
__device__ __forceinline__ void get_scores(float (&v)[4][M * N / 4 / H],
                                           const float* W, int t) {
  constexpr int NCG = 4 * H / M, NC = M * N / 4 / H;
  const int rg = t / NCG, cg = t % NCG;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float4 w = *reinterpret_cast<const float4*>(
        W + (cg + NCG * j) * (M + 4) + 4 * rg);
    v[0][j] = w.x;
    v[1][j] = w.y;
    v[2][j] = w.z;
    v[3][j] = w.w;
  }
}

// A gradient product over the CTA's NT threads: acc[i][4 j + c] += sum_k
// W[k][4 rg + i] X[k][4 (dg + NDG j) + c] over k < K, W (K, M + 4) and X
// (K, HDP + 4) f32 in shared memory; rg = t / NDG, dg = t % NDG, NDG =
// 4 NT / M dim groups (8 or 16: a quarter warp reads one float4 of W and
// 8 consecutive float4 of a row of X), CD = HDP M / 4 NT dims a thread.
template <int M, int K, int HDP, int NT>
__device__ __forceinline__ void grad_tile(
    float (&acc)[4][HDP * M / 4 / NT], const float* W, const float* X) {
  constexpr int LD = HDP + 4, NDG = 4 * NT / M, CD = HDP * M / 4 / NT;
  const int t = threadIdx.x;
  const int rg = t / NDG, dg = t % NDG;
  const float* w = W + 4 * rg;
  const float* x = X + 4 * dg;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k * (M + 4));
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int j = 0; j < CD / 4; ++j) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + k * LD + 4 * NDG * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * j] = fmaf(wr[i], xv.x, acc[i][4 * j]);
        acc[i][4 * j + 1] = fmaf(wr[i], xv.y, acc[i][4 * j + 1]);
        acc[i][4 * j + 2] = fmaf(wr[i], xv.z, acc[i][4 * j + 2]);
        acc[i][4 * j + 3] = fmaf(wr[i], xv.w, acc[i][4 * j + 3]);
      }
    }
  }
}

// Rows row0 + 4 rg + i of a gradient thread's block (times mul) to `out`
// (f32, row stride `stride`): rows < limit, dims < hd.
template <int M, int HDP, int NT>
__device__ __forceinline__ void put_grad(
    float* out, int stride, int row0, int limit, int hd, bool vec,
    const float (&acc)[4][HDP * M / 4 / NT], float mul) {
  constexpr int NDG = 4 * NT / M, CD = HDP * M / 4 / NT;
  const int rg = threadIdx.x / NDG, dg = threadIdx.x % NDG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * rg + i;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < CD / 4; ++j) {
      const int d0 = 4 * (dg + NDG * j);
      if (d0 >= hd) continue;
      const float x[4] = {acc[i][4 * j], acc[i][4 * j + 1],
                          acc[i][4 * j + 2], acc[i][4 * j + 3]};
      put4(out + (size_t)row * stride + d0, x, mul, hd - d0, vec);
    }
  }
}

// Launch 1, f32: dQ (and D) for the BQ query rows of one (q head, batch
// row, query tile); the key tiles its rows see, two stages of K / V.
template <int HDP>
__global__ void __launch_bounds__(F32Cfg<HDP>::NTQ)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout, float* __restrict__ dq,
                     float* __restrict__ dsum, int S, int T_, int hd, int G,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_,
                     Strides ds_, Strides dqs_, int causal, int window,
                     int vec, float scale) {
  using C = F32Cfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BKQ, LD = C::LD, NT = C::NTQ;
  constexpr int H = NT / 2;  // threads of S, and of dP
  constexpr int NCG = 4 * H / BQ, NC = BQ * BK / 4 / H;
  constexpr int CD = HDP * BQ / 4 / NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (BQ, LD)
  float* dOs = Qs + BQ * LD;                     // (BQ, LD)
  float* KVs = dOs + BQ * LD;  // stage s: K at KVs + 2 s BK LD, V after it
  float* Ws = KVs + 4 * BK * LD;  // P, then dS: (BK, BQ + 4)
  float* Ls = Ws + BK * (BQ + 4);  // (BQ): lse
  float* Ds = Ls + BQ;             // (BQ): D

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // causal: the last query tiles see the most keys and launch first
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int kvh = h / G;
  const int off = T_ - S;  // absolute position of query 0
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* qb = q + (size_t)b * qs_.b + (size_t)h * qs_.h;
  const float* ob = o + (size_t)b * os_.b + (size_t)h * os_.h;
  const float* db = dout + (size_t)b * ds_.b + (size_t)h * ds_.h;
  const float* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const float* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;
  const size_t row_base = ((size_t)b * gridDim.x + h) * S;

  // keys any row of this tile can see: [lo, hi), in n_kt tiles
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(T_, off + q_last + 1) : T_;
  const int lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int t_first = (lo / BK) * BK;
  const int n_kt = hi > t_first ? (hi - t_first + BK - 1) / BK : 0;

  stage_f32<HDP, BQ, NT>(Qs, qb, qs_.s, q0, S, hd, vec);
  stage_f32<HDP, BQ, NT>(dOs, db, ds_.s, q0, S, hd, vec);
  if (n_kt > 0) {
    stage_f32<HDP, BK, NT>(KVs, kb, ks_.s, t_first, hi, hd, vec);
    stage_f32<HDP, BK, NT>(KVs + BK * LD, vb, vs_.s, t_first, hi, hd, vec);
  }
  hopper::cp_async_commit();
  // D = rowsum(dO * O), one warp a row; a row that sees no key keeps 0
  for (int r = warp; r < BQ; r += NT / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    float l = -INFINITY;
    if (row < S) {
      for (int d = lane; d < hd; d += 32)
        acc += ob[(size_t)row * os_.s + d] * db[(size_t)row * ds_.s + d];
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

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  const int st = tid % H;  // the thread's place in its score half
  const int rg = st / NCG, cg = st % NCG;

  for (int it = 0; it < n_kt; ++it) {
    const int t0 = t_first + it * BK;
    const float* Ks = KVs + (it & 1) * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    if (it + 1 < n_kt) {  // the next K / V tile loads under these products
      float* nk = KVs + ((it + 1) & 1) * 2 * BK * LD;
      stage_f32<HDP, BK, NT>(nk, kb, ks_.s, t0 + BK, hi, hd, vec);
      stage_f32<HDP, BK, NT>(nk + BK * LD, vb, vs_.s, t0 + BK, hi, hd, vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // this tile (and Q / dO / L / D) staged
    float sc[4][NC];
    if (tid < H) {
      // S = Q K^T, then P (0 where masked, past S or T, or keyless)
      score_tile<BQ, BK, HDP, H, 2>(sc, Qs, Ks, st);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        const float l = Ls[r];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int key = t0 + cg + NCG * j;
          const bool ok = q0 + r < S && key < T_ && l != -INFINITY &&
                          visible(key, off + q0 + r, causal, window);
          sc[i][j] = ok ? expf(sc[i][j] * scale - l) : 0.f;
        }
      }
      put_scores<BQ, BK, H>(Ws, sc, st);
    } else {
      score_tile<BQ, BK, HDP, H, 2>(sc, dOs, Vs, st);  // dP = dO V^T
    }
    __syncthreads();
    if (tid >= H) {  // dS = P (dP - D), in place of P
      float p[4][NC];
      get_scores<BQ, BK, H>(p, Ws, st);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dr = Ds[4 * rg + i];
#pragma unroll
        for (int j = 0; j < NC; ++j) sc[i][j] = p[i][j] * (sc[i][j] - dr);
      }
      put_scores<BQ, BK, H>(Ws, sc, st);
    }
    __syncthreads();
    grad_tile<BQ, BK, HDP, NT>(acc, Ws, Ks);  // dQ += dS K
    __syncthreads();  // every thread done with this stage and Ws
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  put_grad<BQ, HDP, NT>(dq + (size_t)b * dqs_.b + (size_t)h * dqs_.h, dqs_.s,
                        q0, S, hd, vec, acc, scale);
}

// Launch 2, f32: dK / dV for the BK keys of one (batch row, KV head, key
// tile) over one entry of the host's plan (backward.py::plan): a run of
// the tile's items, item i being query tile qt_lo + i % n_q (32 queries)
// of query head g = i / n_q of the group, IT items a step (a missing
// last one staged as zeros and masked), two stages of Q / dO. Per item
// of a step two warps compute S^T and two dP^T; every thread then adds 4
// keys x CD dims of dV and of dK over the step's queries. A split tile
// is summed from f32 partials as on the bf16 route.
template <int HDP>
__global__ void __launch_bounds__(F32Cfg<HDP>::NTK)
    flash_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const float* __restrict__ dout, float* __restrict__ dk,
                       float* __restrict__ dv, const int4* __restrict__ plan,
                       float* __restrict__ part, int* __restrict__ counters,
                       int n_slots, int S, int T_, int hd, int G, int Hkv,
                       Strides qs_, Strides ks_, Strides vs_, Strides ds_,
                       Strides dks_, Strides dvs_, int causal, int window,
                       int vec, float scale) {
  using C = F32Cfg<HDP>;
  constexpr int BK = C::BK, BQ = C::BQ2, LD = C::LD, IT = C::IT;
  constexpr int QR = C::QR, NT = C::NTK;
  constexpr int H = 64;  // threads of one item's S^T, and of its dP^T
  constexpr int NCG = 4 * H / BK, NC = BK * BQ / 4 / H;
  constexpr int CD = HDP * BK / 4 / NT;
  constexpr int WP = BK + 4;  // pitch of P^T / dS^T rows
  constexpr int PART = 2 * BK * HDP;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (BK, LD)
  float* Vs = Ks + BK * LD;                      // (BK, LD)
  float* QDs = Vs + BK * LD;  // stage s: Q at QDs + 2 s QR LD, dO after it
  float* Ps = QDs + 4 * QR * LD;                 // P^T as (QR, WP)
  float* dSs = IT == 2 ? Ps : Ps + QR * WP;      // dS^T as (QR, WP)
  float* LDs = dSs + QR * WP;  // stage s: lse at LDs + 2 s QR, D after it

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int4 e = plan[2 * blockIdx.y];      // key tile, items [y, z), splits
  const int4 f = plan[2 * blockIdx.y + 1];  // split, first slot
  const int kt = e.x;
  const int n_items = e.z - e.y;
  const int n_steps = (n_items + IT - 1) / IT;
  const int k0 = kt * BK;
  const int k1 = min(k0 + BK, T_);
  const int Hq = Hkv * G;
  const int off = T_ - S;
  const int tid = threadIdx.x;
  const float* kb = k + (size_t)b * ks_.b + (size_t)kvh * ks_.h;
  const float* vb = v + (size_t)b * vs_.b + (size_t)kvh * vs_.h;

  // query rows that can see a key of this tile: [i_lo, i_hi), in n_q
  // tiles from qt_lo
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window > 0 ? min(S, k1 - 1 + window - off) : S;
  const int qt_lo = i_lo / BQ;
  const int n_q = i_lo < i_hi ? (i_hi + BQ - 1) / BQ - qt_lo : 0;

  // the next item to stage: query tile qt_lo + nq of head g of the group
  int g = n_q > 0 ? e.y / n_q : 0;
  int nq = e.y - g * n_q;
  int staged = 0;
  auto stage_step = [&](int sg) {
#pragma unroll
    for (int a = 0; a < IT; ++a) {
      float* qd = QDs + sg * 2 * QR * LD + a * BQ * LD;
      float* ld = LDs + sg * 2 * QR + a * BQ;
      if constexpr (IT > 1) {
        if (staged++ >= n_items) {  // no item: zeros
          stage_f32<HDP, BQ, NT>(qd, q, 0, 0, 0, hd, vec);
          stage_f32<HDP, BQ, NT>(qd + QR * LD, q, 0, 0, 0, hd, vec);
          stage_rows<NT>(ld, lse, 0, BQ, 0);
          stage_rows<NT>(ld + QR, lse, 0, BQ, 0);
          continue;
        }
      }
      const int q0 = (qt_lo + nq) * BQ;
      const int h = kvh * G + g;
      if (++nq == n_q) {
        nq = 0;
        ++g;
      }
      stage_f32<HDP, BQ, NT>(qd, q + (size_t)b * qs_.b + (size_t)h * qs_.h,
                             qs_.s, q0, S, hd, vec);
      stage_f32<HDP, BQ, NT>(qd + QR * LD,
                             dout + (size_t)b * ds_.b + (size_t)h * ds_.h,
                             ds_.s, q0, S, hd, vec);
      const size_t row_base = ((size_t)b * Hq + h) * S;
      stage_rows<NT>(ld, lse + row_base, q0, BQ, S);
      stage_rows<NT>(ld + QR, dsum + row_base, q0, BQ, S);
    }
  };

  stage_f32<HDP, BK, NT>(Ks, kb, ks_.s, k0, T_, hd, vec);
  stage_f32<HDP, BK, NT>(Vs, vb, vs_.s, k0, T_, hd, vec);
  if (n_steps > 0) stage_step(0);
  hopper::cp_async_commit();

  float adk[4][CD], adv[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) adk[i][j] = adv[i][j] = 0.f;
  // this thread's item of a step, and its product: 0 S^T, 1 dP^T
  const int my = tid / (2 * H);
  const int role = (tid / H) & 1;
  const int st = tid % H;  // its place among the product's threads
  const int rg = st / NCG, cg = st % NCG;
  int cq = n_q > 0 ? e.y % n_q : 0;  // the computed item's query tile

  for (int it = 0; it < n_steps; ++it) {
    const int sg = it & 1;
    if (it + 1 < n_steps) stage_step(sg ^ 1);  // under these products
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // step it (and K / V) staged
    int q0 = S;  // this thread's item's first query (S: no item, masked)
#pragma unroll
    for (int a = 0; a < IT; ++a) {
      if (it * IT + a >= n_items) break;
      if (a == my) q0 = (qt_lo + cq) * BQ;
      if (++cq == n_q) cq = 0;
    }
    const float* Qs = QDs + sg * 2 * QR * LD;
    const float* dOs = Qs + QR * LD;
    const float* Ls = LDs + sg * 2 * QR + my * BQ;
    const float* Dsm = Ls + QR;
    float* Pm = Ps + my * BQ * WP;    // this item's P^T rows
    float* dSm = dSs + my * BQ * WP;  // and dS^T rows
    float sc[4][NC];
    if (role == 0) {
      // S^T = K Q^T, then P^T (0 where masked, past S or T, or keyless)
      score_tile<BK, BQ, HDP, H, IT>(sc, Ks, Qs + my * BQ * LD, st);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int r = cg + NCG * j;
        const float l = Ls[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * rg + i;
          const bool ok = q0 + r < S && key < T_ && l != -INFINITY &&
                          visible(key, off + q0 + r, causal, window);
          sc[i][j] = ok ? expf(sc[i][j] * scale - l) : 0.f;
        }
      }
      put_scores<BK, BQ, H>(Pm, sc, st);
    } else {  // dP^T = V dO^T
      score_tile<BK, BQ, HDP, H, IT>(sc, Vs, dOs + my * BQ * LD, st);
    }
    __syncthreads();
    if (role == 1) {  // dS^T = P^T (dP^T - D)
      float p[4][NC];
      get_scores<BK, BQ, H>(p, Pm, st);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float dr = Dsm[cg + NCG * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = p[i][j] * (sc[i][j] - dr);
      }
      if constexpr (IT == 1) put_scores<BK, BQ, H>(dSm, sc, st);
    }
    if constexpr (IT == 1) {
      __syncthreads();
      grad_tile<BK, QR, HDP, NT>(adv, Ps, dOs);  // dV += P^T dO
      grad_tile<BK, QR, HDP, NT>(adk, dSs, Qs);  // dK += dS^T Q
    } else {
      grad_tile<BK, QR, HDP, NT>(adv, Ps, dOs);  // dV += P^T dO
      __syncthreads();  // P^T read: dS^T takes its place
      if (role == 1) put_scores<BK, BQ, H>(dSm, sc, st);
      __syncthreads();
      grad_tile<BK, QR, HDP, NT>(adk, dSs, Qs);  // dK += dS^T Q
    }
    __syncthreads();  // every thread done with this stage, Ps and dSs
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  float* dkb = dk + (size_t)b * dks_.b + (size_t)kvh * dks_.h;
  float* dvb = dv + (size_t)b * dvs_.b + (size_t)kvh * dvs_.h;
  if (e.w == 1) {  // the tile's only CTA
    put_grad<BK, HDP, NT>(dkb, dks_.s, k0, T_, hd, vec, adk, scale);
    put_grad<BK, HDP, NT>(dvb, dvs_.s, k0, T_, hd, vec, adv, 1.f);
    return;
  }
  float* slots = part + ((size_t)bh * n_slots + f.y) * PART;
  float* mine = slots + (size_t)f.x * PART;
  put_grad<BK, HDP, NT>(mine, HDP, 0, BK, HDP, true, adk, 1.f);
  put_grad<BK, HDP, NT>(mine + BK * HDP, HDP, 0, BK, HDP, true, adv, 1.f);
  if (!count_in(counters + (size_t)bh * ((T_ + BK - 1) / BK) + kt, e.w))
    return;
  merge_slots<float, BK, HDP, NT>(slots, e.w, dkb, dks_.s, dvb, dvs_.s, k0,
                                  T_, hd, vec, scale);
}

template <int HDP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* dsum,
                       const int* plan, int n_entries, float* part,
                       int n_slots, int* counters, int B, int Hq, int Hkv,
                       int S, int T_, int hd, Strides qs_, Strides ks_,
                       Strides vs_, Strides os_, Strides ds_, Strides dqs_,
                       Strides dks_, Strides dvs_, int causal, int window,
                       int vec, cudaStream_t stream) {
  using C = F32Cfg<HDP>;
  static_assert(C::DQ_SMEM <= 232448 && C::DKV_SMEM <= 232448,
                "shared memory of a CTA");
  const float scale = 1.0f / sqrtf((float)hd);
  const int G = Hq / Hkv;
  const int n_qt = (S + C::BQ - 1) / C::BQ;
  if (!plan || n_entries <= 0 || n_entries > 65535 || n_qt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* d_ = static_cast<const float*>(dout);
  flash_bwd_dq_f32<HDP>
      <<<dim3(Hq, B, n_qt), C::NTQ, C::DQ_SMEM, stream>>>(
          q_, k_, v_, static_cast<const float*>(o), lse, d_,
          static_cast<float*>(dq), dsum, S, T_, hd, G, qs_, ks_, vs_, os_,
          ds_, dqs_, causal, window, vec, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32<HDP>
      <<<dim3(B * Hkv, n_entries), C::NTK, C::DKV_SMEM, stream>>>(
          q_, k_, v_, lse, dsum, d_, static_cast<float*>(dk),
          static_cast<float*>(dv), reinterpret_cast<const int4*>(plan), part,
          counters, n_slots, S, T_, hd, G, Hkv, qs_, ks_, vs_, ds_, dks_,
          dvs_, causal, window, vec, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 tensor-core route
// Every product is a wgmma (kernels/include/wgmma.cuh) on bf16 tiles in
// the 128-byte swizzled layout in shared memory, which cp.async fills
// one tile ahead of the products (16-byte copies with zero fill; element
// by element for rows that are not 16-byte aligned, into the same
// layout). The probabilities, D and dS are f32 in registers and are
// rounded to bf16 only as the A operand of the dV, dK and dQ products,
// as the forward rounds P before PV; hd is zero-padded to HDP.
template <int HDP>
struct WgCfg {
  static constexpr bool WIDE = HDP > 128;  // dK / dV on two warpgroups
  static constexpr int BQ = 64;            // dQ: query rows a CTA
  static constexpr int BK = WIDE ? 32 : 64;  // dQ: keys a tile
  static constexpr int BKV = 64;   // dK / dV: keys a CTA
  // dK / dV: queries an item; 64 at HDP 192, where the registers allow
  // it, so K and V are read once per 64 queries and the products are
  // m64n64 (at HDP 256 S^T, P^T and dP^T of 64 queries would not fit
  // beside the 128 accumulator registers)
  static constexpr int BQ2 = HDP == 192 ? 64 : 32;
  static constexpr int NS = 2;     // dQ: K / V stages
  static constexpr int NS2 = 3;    // dK / dV: Q / dO stages
  static constexpr int NT2 = WIDE ? 2 * kWgThreads : kWgThreads;
  static constexpr int T64 = 64 * HDP;  // bf16 of a 64-row tile
  static constexpr int TQ = BQ2 * HDP;  // bf16 of an item's Q or dO
  static constexpr int TB = BK * HDP;   // bf16 of a dQ K or V tile
  // dK / dV at HDP 192 / 256: warpgroup 0's P^T (BQ2 / 4 words a
  // thread) and warpgroup 1's dP^T (BQ2 / 2 f32 a thread)
  static constexpr size_t XCH =
      WIDE ? (BQ2 / 4 + BQ2 / 2) * 4 * kWgThreads : 0;
  // + 1024: the tiles start 1024-byte aligned (wgmma.cuh). dQ: Q, dO,
  // then NS stages of K and V (the second holds O first); dK / dV: K, V,
  // then NS2 stages of Q, dO, lse and D, then the exchange
  static constexpr size_t DQ_SMEM =
      1024 + sizeof(bf16) * (2 * T64 + 2 * NS * TB) + sizeof(float) * 2 * BQ;
  static constexpr size_t DKV_SMEM =
      1024 + sizeof(bf16) * (2 * T64 + 2 * NS2 * TQ) +
      sizeof(float) * 2 * NS2 * BQ2 + XCH;
  static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448,
                "shared memory of a CTA");
};

__device__ __forceinline__ bf16* align1024(uint8_t* p) {
  return reinterpret_cast<bf16*>(p + ((1024 - (hopper::smem_addr(p) & 1023)) &
                                      1023));
}

// Rows [first, first + R) of `src` (row stride `stride`) into the wgmma
// tile `dst` by the CTA's NT threads: rows at or past `limit` and dims
// past hd are zero. With `vec` (16-byte aligned rows, hd % 8 == 0) every
// 16-byte chunk is one cp.async (the caller commits and waits); else
// element by element.
template <int HDP, int R, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int stride, int first, int limit,
                                           int hd, bool vec) {
  constexpr int CPR = HDP / 8;
  if (vec) {
    if constexpr (NT % CPR == 0) {  // thread t: chunk t % CPR of rows
      constexpr int RS = NT / CPR;  // t / CPR + m * RS
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
    } else {  // chunk e = t + m NT: row e / CPR, chunk e % CPR
#pragma unroll
      for (int m = 0; m < R * CPR / NT; ++m) {
        const int e = threadIdx.x + m * NT;
        const int r = e / CPR, c = e % CPR;
        const bool ok = c * 8 < hd && first + r < limit;
        hopper::cp_async16(dst + wg::tile_off<R>(r, c),
                           ok ? src + (size_t)(first + r) * stride + c * 8
                              : src,
                           ok);
      }
    }
    return;
  }
#pragma unroll 8
  for (int m = 0; m < R * HDP / NT; ++m) {  // element e = t + m NT
    const int e = threadIdx.x + m * NT;
    const int r = e / HDP, d = e % HDP;
    const int p = first + r;
    dst[wg::tile_off<R>(r, d >> 3) + (d & 7)] =
        (p < limit && d < hd) ? src[(size_t)p * stride + d]
                              : __float2bfloat16(0.f);
  }
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

// A warpgroup's m64 accumulator d times mul into `tmp` (64 x (HDP + 8)
// bf16 in shared memory: 16-byte rows, conflict-free pair stores); t is
// the thread's index in its warpgroup.
template <int HDP>
__device__ __forceinline__ void acc_to_tmp(bf16* tmp, const float (&d)[HDP / 2],
                                           float mul, int t) {
  constexpr int P = HDP + 8;
  const int lane = t % 32;
  const int rw = t / 32 * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tmp + (rw + 8 * i) * P + j * 8 +
                                         (lane & 3) * 2) =
          __floats2bfloat162_rn(d[4 * j + 2 * i] * mul,
                                d[4 * j + 2 * i + 1] * mul);
}

// Rows [row0, row0 + 64) of a bf16 output (row stride `stride`) from
// `tmp` (as acc_to_tmp wrote it) by the CTA's NT threads, with `vec`
// whole 16-byte chunks a thread: rows < limit and dims < hd.
template <int HDP, int NT>
__device__ __forceinline__ void tmp_to_out(bf16* out, int stride, int row0,
                                           int limit, int hd, bool vec,
                                           const bf16* tmp) {
  constexpr int P = HDP + 8;
  if (vec) {
    constexpr int CPR = HDP / 8;
#pragma unroll
    for (int m = 0; m < 64 * CPR / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      const int r = e / CPR;
      const int c = e % CPR;
      if (row0 + r < limit && c * 8 < hd)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * stride +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(tmp + r * P + c * 8);
    }
  } else {
#pragma unroll 8
    for (int m = 0; m < 64 * HDP / NT; ++m) {
      const int e = threadIdx.x + m * NT;
      const int r = e / HDP;
      const int c = e % HDP;
      if (row0 + r < limit && c < hd)
        out[(size_t)(row0 + r) * stride + c] = tmp[r * P + c];
    }
  }
}

// A warpgroup's m64 accumulator (HDP columns) as rows [0, 64) of an f32
// partial slot [row][dim] at HDP; t is the thread's index in its
// warpgroup.
template <int HDP>
__device__ __forceinline__ void acc_to_slot(float* slot,
                                            const float (&d)[HDP / 2],
                                            int t) {
  const int lane = t % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t / 32 * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
      *reinterpret_cast<float2*>(slot + row * HDP + j * 8 + (lane & 3) * 2) =
          make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
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

// P^T of a dK / dV item in place of S^T in `st` (keys key[0], key[1] of
// the thread's two rows, queries 8 j + 2 tig (+ 1) from q0, whose lse
// log2(e) are lq): 0 where masked, past S or T, or keyless. An item
// inside the masks' band (every key < T and seen by every row) skips the
// masks.
template <int BQ>
__device__ __forceinline__ void item_p(float (&st)[BQ / 2],
                                       const float (&lq)[BQ / 8][2],
                                       const int (&key)[2], int k0, int q0,
                                       int off, int S, int T_, int causal,
                                       int window, int tig,
                                       float scale_log2) {
  if (k0 + 64 <= T_ && (!causal || k0 + 63 <= off + q0) &&
      (window <= 0 || k0 > off + q0 + BQ - 1 - window)) {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        st[4 * j + c] = exp2f(st[4 * j + c] * scale_log2 - lq[j][c & 1]);
    return;
  }
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rq = j * 8 + tig * 2 + (c & 1);
      const int kq = key[c >> 1];
      const bool ok = q0 + rq < S && kq < T_ && lq[j][c & 1] != -INFINITY &&
                      visible(kq, off + q0 + rq, causal, window);
      st[4 * j + c] =
          ok ? exp2f(st[4 * j + c] * scale_log2 - lq[j][c & 1]) : 0.f;
    }
}

// Launch 1: dQ (and D) for the 64 query rows of one (q head, batch row,
// query tile); the key tiles (BK keys) its rows see, two stages of K / V.
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
  constexpr int TB = C::TB;
  constexpr int KS = HDP / 16;  // k-steps over the head dims
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = align1024(smem_raw);
  bf16* dOs = Qs + T64;
  bf16* KVs = dOs + T64;  // stage s: K at KVs + 2 s TB, V after it
  float* L2 = reinterpret_cast<float*>(KVs + 2 * NS * TB);  // lse log2(e)
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

  // Q, dO and O (into the second stage, 2 x TB = one 64-row tile, which
  // the loop fills only after D is taken from it), then the first K / V
  // tile, which loads under D
  bf16* Os = KVs + 2 * TB;
  stage_tile<HDP, BQ, kWgThreads>(Qs, qb, qs_.s, q0, S, hd, vec);
  stage_tile<HDP, BQ, kWgThreads>(dOs, db, ds_.s, q0, S, hd, vec);
  stage_tile<HDP, BQ, kWgThreads>(Os, ob, os_.s, q0, S, hd, vec);
  hopper::cp_async_commit();
  if (n_kt > 0) {
    stage_tile<HDP, BK, kWgThreads>(KVs, kb, ks_.s, t_first, hi, hd, vec);
    stage_tile<HDP, BK, kWgThreads>(KVs + TB, vb, vs_.s, t_first, hi, hd,
                                    vec);
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
    const bf16* Ks = KVs + (it % NS) * 2 * TB;
    const bf16* Vs = Ks + TB;
    if (it + 1 < n_kt) {  // the next K / V tile loads under these products
      bf16* nk = KVs + ((it + 1) % NS) * 2 * TB;
      stage_tile<HDP, BK, kWgThreads>(nk, kb, ks_.s, t0 + BK, hi, hd, vec);
      stage_tile<HDP, BK, kWgThreads>(nk + TB, vb, vs_.s, t0 + BK, hi, hd,
                                      vec);
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
  acc_to_tmp<HDP>(KVs, acc, scale, threadIdx.x);
  __syncthreads();
  tmp_to_out<HDP, kWgThreads>(dq + (size_t)b * dqs_.b + (size_t)h * dqs_.h,
                              dqs_.s, q0, S, hd, vec, KVs);
}

// Launch 2 at HDP 64 / 128: dK / dV for the 64 keys of one (batch row, KV
// head, key tile) over one entry of the host's plan (backward.py::plan):
// a run of the tile's items, item i being query tile qt_lo + i % n_q of
// query head g = i / n_q of the group, three stages of Q / dO. A tile
// whose items the plan splits over several CTAs has each write its f32
// partial dK / dV to a slot of `part`; the CTA that counts in last on
// the tile's counter (which it resets) adds the partials in slot order
// and writes dk / dv.
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
  constexpr int BK = C::BKV, BQ = C::BQ2, NS = C::NS2;
  constexpr int T64 = C::T64, TQ = C::TQ;
  constexpr int KS = HDP / 16;  // k-steps over the head dims
  constexpr int QS = BQ / 16;   // k-steps over an item's queries
  constexpr int PART = 2 * BK * HDP;  // f32 of a slot: dK, then dV
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + T64;
  bf16* QDs = Vs + T64;  // stage s: Q at QDs + 2 s TQ, dO after it
  float* LDs = reinterpret_cast<float*>(QDs + 2 * NS * TQ);  // lse, D

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
    bf16* qd = QDs + st * 2 * TQ;
    stage_tile<HDP, BQ, kWgThreads>(
        qd, q + (size_t)b * qs_.b + (size_t)h * qs_.h, qs_.s, q0, S, hd,
        vec);
    stage_tile<HDP, BQ, kWgThreads>(
        qd + TQ, dout + (size_t)b * ds_.b + (size_t)h * ds_.h, ds_.s, q0, S,
        hd, vec);
    const size_t row_base = ((size_t)b * Hq + h) * S;
    stage_rows<kWgThreads>(LDs + st * 2 * BQ, lse + row_base, q0, BQ, S);
    stage_rows<kWgThreads>(LDs + st * 2 * BQ + BQ, dsum + row_base, q0, BQ,
                           S);
  };

  stage_tile<HDP, BK, kWgThreads>(Ks, kb, ks_.s, k0, T_, hd, vec);
  stage_tile<HDP, BK, kWgThreads>(Vs, vb, vs_.s, k0, T_, hd, vec);
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
    const bf16* Qs = QDs + sg * 2 * TQ;
    const bf16* dOs = Qs + TQ;
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
    // D) add nothing whatever their P.
    float lq[BQ / 8][2], dq2[BQ / 8][2];  // the thread's rows' lse, D
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lq[j][c] = Ls[j * 8 + tig * 2 + c] * kLog2e;
        dq2[j][c] = Dsm[j * 8 + tig * 2 + c];
      }
    item_p<BQ>(st, lq, key, k0, q0, off, S, T_, causal, window, tig,
               scale_log2);
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
    bf16* tk = QDs;
    bf16* tv = QDs + 64 * (HDP + 8);
    acc_to_tmp<HDP>(tk, adk, scale, threadIdx.x);
    acc_to_tmp<HDP>(tv, adv, 1.f, threadIdx.x);
    __syncthreads();
    tmp_to_out<HDP, kWgThreads>(dkb, dks_.s, k0, T_, hd, vec, tk);
    tmp_to_out<HDP, kWgThreads>(dvb, dvs_.s, k0, T_, hd, vec, tv);
    return;
  }
  float* slots = part + ((size_t)bh * n_slots + f.y) * PART;
  float* mine = slots + (size_t)f.x * PART;
  acc_to_slot<HDP>(mine, adk, threadIdx.x);
  acc_to_slot<HDP>(mine + BK * HDP, adv, threadIdx.x);
  if (!count_in(counters + (size_t)bh * ((T_ + BK - 1) / BK) + kt, e.w))
    return;
  merge_slots<bf16, BK, HDP, kWgThreads>(slots, e.w, dkb, dks_.s, dvb,
                                         dvs_.s, k0, T_, hd, vec, scale);
}

// Launch 2 at HDP 192 / 256: as flash_bwd_dkdv_wg, on two warpgroups.
// Warpgroup 0 computes S^T = K Q^T, P^T and dS^T and owns dK;
// warpgroup 1 computes dP^T = V dO^T and owns dV. Per item they trade
// P^T (bf16 A fragments) and dP^T (f32) through shared memory, each
// thread with the thread of the same index in the other warpgroup (the
// accumulators' layouts are the same), between two CTA barriers.
template <int HDP>
__global__ void __launch_bounds__(2 * kWgThreads, 1)
    flash_bwd_dkdv_wg2(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  constexpr int BK = C::BKV, BQ = C::BQ2, NS = C::NS2, NT = C::NT2;
  constexpr int T64 = C::T64, TQ = C::TQ;
  constexpr int KS = HDP / 16;  // k-steps over the head dims
  constexpr int QS = BQ / 16;   // k-steps over an item's queries
  constexpr int PART = 2 * BK * HDP;  // f32 of a slot: dK, then dV
  extern __shared__ uint8_t smem_raw[];
  bf16* Ks = align1024(smem_raw);
  bf16* Vs = Ks + T64;
  bf16* QDs = Vs + T64;  // stage s: Q at QDs + 2 s TQ, dO after it
  float* LDs = reinterpret_cast<float*>(QDs + 2 * NS * TQ);  // lse, D
  unsigned* xP = reinterpret_cast<unsigned*>(LDs + 2 * NS * BQ);
  float* xD = reinterpret_cast<float*>(xP + 4 * QS * kWgThreads);

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
  const int wgi = threadIdx.x / kWgThreads;  // 0: S^T, P^T, dK; 1: dP^T, dV
  const int t = threadIdx.x % kWgThreads;
  const int warp = t / 32;
  const int lane = t % 32;
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
  auto stage_item = [&](int sg) {
    const int q0 = (qt_lo + nq) * BQ;
    const int h = kvh * G + g;
    if (++nq == n_q) {
      nq = 0;
      ++g;
    }
    bf16* qd = QDs + sg * 2 * TQ;
    stage_tile<HDP, BQ, NT>(qd, q + (size_t)b * qs_.b + (size_t)h * qs_.h,
                            qs_.s, q0, S, hd, vec);
    stage_tile<HDP, BQ, NT>(qd + TQ,
                            dout + (size_t)b * ds_.b + (size_t)h * ds_.h,
                            ds_.s, q0, S, hd, vec);
    const size_t row_base = ((size_t)b * Hq + h) * S;
    stage_rows<NT>(LDs + sg * 2 * BQ, lse + row_base, q0, BQ, S);
    stage_rows<NT>(LDs + sg * 2 * BQ + BQ, dsum + row_base, q0, BQ, S);
  };

  stage_tile<HDP, BK, NT>(Ks, kb, ks_.s, k0, T_, hd, vec);
  stage_tile<HDP, BK, NT>(Vs, vb, vs_.s, k0, T_, hd, vec);
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
  // the same code for both warpgroups, on their own operands
  const bf16* A_s = wgi ? Vs : Ks;  // S^T / dP^T: K or V
  float acc[HDP / 2], sc[BQ / 2];   // dK or dV; S^T, P^T, dS^T or dP^T
#pragma unroll
  for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < BQ / 2; ++j) sc[j] = 0.f;
  unsigned fa[QS][4];  // dS^T (warpgroup 0) or P^T (1) as A operand
#pragma unroll
  for (int kk = 0; kk < QS; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) fa[kk][c] = 0u;

  int cq = n_q > 0 ? e.y % n_q : 0;  // the computed item's query tile
  for (int it = 0; it < n_items; ++it) {
    const int sg = it % NS;
    hopper::cp_async_wait<NS - 2>();
    wg::fence_proxy_async();
    // item it (and K / V) staged; both warpgroups' products of item it -
    // 1 are done, so its stage takes item it + NS - 1, and the other
    // warpgroup has read what this thread traded for item it - 1
    __syncthreads();
    if (it + NS - 1 < n_items) stage_item((it + NS - 1) % NS);
    hopper::cp_async_commit();
    const int q0 = (qt_lo + cq) * BQ;
    if (++cq == n_q) cq = 0;
    const bf16* Qs = QDs + sg * 2 * TQ;
    const bf16* dOs = Qs + TQ;
    const bf16* B_s = wgi ? dOs : Qs;  // S^T / dP^T: Q or dO
    const float* Ls = LDs + sg * 2 * BQ;
    const float* Dsm = Ls + BQ;
    // S^T = K Q^T (warpgroup 0), dP^T = V dO^T (warpgroup 1)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::ss<BQ>(sc, wg::desc_k<BK>(A_s, kk), wg::desc_k<BQ>(B_s, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::keep(sc);
    float dq2[BQ / 8][2];  // the thread's rows' D (warpgroup 0)
    if (wgi == 0) {
      float lq[BQ / 8][2];  // the thread's rows' lse log2(e)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          lq[j][c] = Ls[j * 8 + tig * 2 + c] * kLog2e;
          dq2[j][c] = Dsm[j * 8 + tig * 2 + c];
        }
      item_p<BQ>(sc, lq, key, k0, q0, off, S, T_, causal, window, tig,
                 scale_log2);
      pack_a(fa, sc);  // P^T for warpgroup 1
#pragma unroll
      for (int kk = 0; kk < QS; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xP[(kk * 4 + c) * kWgThreads + t] = fa[kk][c];
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) xD[j * kWgThreads + t] = sc[j];
    }
    __syncthreads();  // P^T and dP^T traded
    if (wgi == 0) {  // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[4 * j + c] *=
              xD[(4 * j + c) * kWgThreads + t] - dq2[j][c & 1];
      pack_a(fa, sc);
    } else {
#pragma unroll
      for (int kk = 0; kk < QS; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          fa[kk][c] = xP[(kk * 4 + c) * kWgThreads + t];
    }
    // dK += dS^T Q (warpgroup 0), dV += P^T dO (warpgroup 1)
    const bf16* X_s = wgi ? dOs : Qs;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < QS; ++kk)
      wg::rs<HDP>(acc, fa[kk], wg::desc_mn<BQ>(X_s, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::keep(acc);
    wg::keep(fa);
  }
  hopper::cp_async_wait<0>();  // no copy left in flight at exit
  bf16* dkb = dk + (size_t)b * dks_.b + (size_t)kvh * dks_.h;
  bf16* dvb = dv + (size_t)b * dvs_.b + (size_t)kvh * dvs_.h;
  if (e.w == 1) {  // the tile's only CTA
    __syncthreads();  // every warpgroup's products done: the stages free
    bf16* tk = QDs;
    bf16* tv = QDs + 64 * (HDP + 8);
    acc_to_tmp<HDP>(wgi ? tv : tk, acc, wgi ? 1.f : scale, t);
    __syncthreads();
    tmp_to_out<HDP, NT>(dkb, dks_.s, k0, T_, hd, vec, tk);
    tmp_to_out<HDP, NT>(dvb, dvs_.s, k0, T_, hd, vec, tv);
    return;
  }
  float* slots = part + ((size_t)bh * n_slots + f.y) * PART;
  acc_to_slot<HDP>(slots + (size_t)f.x * PART + wgi * BK * HDP, acc, t);
  if (!count_in(counters + (size_t)bh * ((T_ + BK - 1) / BK) + kt, e.w))
    return;
  merge_slots<bf16, BK, HDP, NT>(slots, e.w, dkb, dks_.s, dvb, dvs_.s, k0,
                                 T_, hd, vec, scale);
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
  auto dkdv = [] {  // only the route's kernel is instantiated
    if constexpr (C::WIDE)
      return flash_bwd_dkdv_wg2<HDP>;
    else
      return flash_bwd_dkdv_wg<HDP>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wg<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  dkdv<<<dim3(B * Hkv, n_entries), C::NT2, C::DKV_SMEM, stream>>>(
      q_, k_, v_, lse, dsum, d_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), reinterpret_cast<const int4*>(plan), part,
      counters, n_slots, S, T_, hd, G, Hkv, qs_, ks_, vs_, ds_, dks_, dvs_,
      causal, window, vec, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (dQ, then dK / dV) and returns the first
// cudaError_t (0 = both queued). Strides are in elements, (batch, head,
// position) of q, k, v, out, dout, dq, dk, dv in that order; lse and the
// scratch dsum are (B, Hq, S) f32 contiguous. dtype: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores), every tensor but lse / dsum;
// hd <= 256; causal: 0 or 1; window: 0 for none; vec: 1 when every row
// of the eight tensors starts 16-byte aligned and hd fills whole 16-byte
// loads (cp.async staging and 16-byte stores). Both routes take the dK /
// dV plan (n_entries x 8 int32: key tile, first item, end item, splits,
// split, first slot, 0, 0; backward.py::plan with the route's key tile,
// 64 or 32 for f32 at hd > 128, and item, 32 queries or 64 for bf16 at
// hd 129-192: backward.route), f32 scratch of B * Hkv * n_slots slots
// of 2 x key tile x HDP and int32 counters, B * Hkv * ceil(T / key
// tile), all 0, which the kernel leaves at 0.
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
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535 || hd < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs_{q_sb, q_sh, q_ss}, ks_{k_sb, k_sh, k_st},
      vs_{v_sb, v_sh, v_st}, os_{o_sb, o_sh, o_ss}, ds_{d_sb, d_sh, d_ss},
      dqs_{dq_sb, dq_sh, dq_ss}, dks_{dk_sb, dk_sh, dk_st},
      dvs_{dv_sb, dv_sh, dv_st};
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
#define FLASH_BWD(FN, HDP_)                                                 \
  return (int)FN<HDP_>(                                                    \
      q, k, v, out, l, dout, dq, dk, dv, ds, static_cast<const int*>(plan), \
      n_entries, static_cast<float*>(part), n_slots,                       \
      static_cast<int*>(counters), B, Hq, Hkv, S, T, hd, qs_, ks_, vs_,    \
      os_, ds_, dqs_, dks_, dvs_, causal, window, vec, st)
#define FLASH_BWD_HD(FN)               \
  if (hd <= 64) FLASH_BWD(FN, 64);     \
  if (hd <= 128) FLASH_BWD(FN, 128);   \
  if (hd <= 192) FLASH_BWD(FN, 192);   \
  if (hd <= 256) FLASH_BWD(FN, 256);
  if (dtype == 0) {
    FLASH_BWD_HD(launch_f32)
  } else if (dtype == 1) {
    FLASH_BWD_HD(launch_wg)
  }
#undef FLASH_BWD_HD
#undef FLASH_BWD
  return (int)cudaErrorInvalidValue;
}
