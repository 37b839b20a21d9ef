// Shared device helpers of the port's kernels: cp.async with zero fill
// (16 bytes for the attention kernels' K/V tiles and the scans' rows, 4
// bytes for the scans' unaligned rows), the scans' transpose-reduce of
// per-step partials over a group of lanes, the scan backwards' split
// cluster barrier and compile-time flag, and for the tensor-core attention
// kernels (flash_attention/csrc/flash.cu,
// paged_attention/csrc/paged_window.cu) ldmatrix, mma.sync m16n8k16
// (bf16 in, f32 accumulate) and the XOR-swizzled tile layout they read.
// A source that includes this header is rebuilt when it changes
// (kernels/_build.py hashes a source together with the headers it
// includes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace hopper {

using bf16 = __nv_bfloat16;

// Element offset of (row, 16-byte chunk) in a bf16 tile of `cpr` chunks
// per row (cpr a multiple of 8): the chunk index is XORed with row % 8,
// so the 8 rows one ldmatrix phase reads fall in 8 distinct bank groups.
__device__ __forceinline__ int swz(int row, int chunk, int cpr) {
  return (row * cpr + (chunk ^ (row & 7))) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok false nothing is read and the
// destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4-byte asynchronous copy (through L1), zero fill as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Barriers of the thread-block cluster, split so that a CTA can work
// between its arrival and its wait (release / acquire: shared-memory
// writes before the arrival are seen by peers after their wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A compile-time bool as a type: a generic lambda called with Flag<true>{}
// or Flag<false>{} compiles one body twice (say, with and without a
// bounds check) and picks one at run time.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Barrier `id` (1..15) over the `threads` threads of a warp group.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

// One round of the transpose-reduce below, O lanes apart over K values
// a lane: the lanes with bit O keep the upper half of each block of 2O
// values, the others the lower, and each adds its partner's copy of the
// half it keeps. A compile-time recursion, so every index is a constant
// and v stays in registers.
template <int O, int K, int TC>
struct ReduceRound {
  __device__ __forceinline__ static void run(float (&v)[TC], int g) {
    const bool up = (g & O) != 0;
#pragma unroll
    for (int s = 0; s < K; s += 2 * O)
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const float lo = v[s + i], hi = v[s + i + O];
        v[s / 2 + i] =
            (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
      }
    ReduceRound<O / 2, K / 2, TC>::run(v, g);
  }
};
template <int K, int TC>
struct ReduceRound<0, K, TC> {
  __device__ __forceinline__ static void run(float (&)[TC], int) {}
};

// Each of a group's L lanes (L a power of two: a selective-scan
// channel's, a WKV column pair's) holds one partial per step of a chunk
// in v; afterwards lane g holds in v[q] the group's sum for step
// q * W + g % W (W = min(L, K), q < K / W). While L > K the two halves
// of the group are first added (their lanes then hold the same sums).
template <int L, int K>
__device__ __forceinline__ void reduce_steps(float (&v)[K], int g) {
  if constexpr (L > K) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], L / 2);
    reduce_steps<L / 2, K>(v, g);
  } else {
    ReduceRound<L / 2, K, K>::run(v, g);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// One warp's S = Q K^T for its 16 rows of a swizzled Q tile (rows q_row0
// .. q_row0 + 15) against the BK keys of a swizzled K tile, HDP head dims.
template <int HDP, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4], const bf16* qs,
                                        int q_row0, const bf16* ks,
                                        int lane) {
  constexpr int CPR = HDP / 8;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    // every fragment of the k-step is loaded before its products, so the
    // ldmatrix latencies overlap
    unsigned a[4], b[BK / 16][4];
    ldsm_x4(a, qs + swz(q_row0 + (lane & 15), kk * 2 + (lane >> 4), CPR));
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      ldsm_x4(b[j], ks + swz(j * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 2 + ((lane >> 3) & 1), CPR));
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      mma16816(s[2 * j], a, b[j][0], b[j][1]);
      mma16816(s[2 * j + 1], a, b[j][2], b[j][3]);
    }
  }
}

// One warp's O += P V: P from its score registers (already
// probabilities) as bf16 A fragments, V a swizzled (BK, HDP) tile
// (HDP a multiple of 64).
template <int HDP, int BK>
__device__ __forceinline__ void pv_tile(float (&o)[HDP / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const bf16* vs, int lane) {
  constexpr int CPR = HDP / 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int d0 = 0; d0 < HDP / 16; d0 += 4) {  // 4 fragments ahead
      unsigned b[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ldsm_x4_t(b[u], vs + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 (d0 + u) * 2 + (lane >> 4), CPR));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma16816(o[2 * (d0 + u)], a, b[u][0], b[u][1]);
        mma16816(o[2 * (d0 + u) + 1], a, b[u][2], b[u][3]);
      }
    }
  }
}

// The online-softmax step of one warp's tile, in base 2: s holds scaled
// scores (-inf where masked) for rows gid (elements 0, 1) and gid + 8
// (2, 3); a quad shares a row. Turns s into probabilities, rescales o
// and the thread's partial row sums l, and updates the row maxima m.
template <int NT, int DT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&o)[DT][4], float (&m)[2],
                                             float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_safe);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][2 * i] - m_safe);  // exp2(-inf) = 0
      const float p1 = exp2f(s[j][2 * i + 1] - m_safe);
      s[j][2 * i] = p0;
      s[j][2 * i + 1] = p1;
      sum += p0 + p1;
    }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][2 * i] *= alpha;
      o[j][2 * i + 1] *= alpha;
    }
  }
}

}  // namespace hopper
