// Mamba selective-scan backward for Hopper (sm_90a): the gradient of
// ssm_scan.cu's function, f32, any T >= 1, any d_inner, state size N <=
// 64.
//
// Replaces no TPU kernel: the reference takes the gradient of
// `_ssm_kernel`'s function (src/repro/kernels/ssm_scan/kernel.py:36)
// through XLA's `lax.scan` (src/repro/models/ssm.py:34). Per batch row b
// and channel d, with a_t = exp(dt_t A), h_t the N-entry state after
// step t and g_t its gradient (g_T = C_T dy_T + dstate_out):
//     g_t = C_t dy_t + a_{t+1} g_{t+1}
//     dC_t[n] = sum_d dy_t[d] h_t[d][n]
//     dB_t[n] = sum_d g_t[d][n] dt_t[d] u_t[d]
//     du_t[d] = D[d] dy_t[d] + dt_t[d] sum_n g_t[d][n] B_t[n]
//     ddt_t[d] = sum_n g_t[d][n] (A[d][n] a_t h_{t-1}[d][n] + u_t[d] B_t[n])
//     dA[d][n] = sum_{b,t} g_t dt_t a_t h_{t-1}
//     dD[d] = sum_{b,t} dy_t[d] u_t[d]
// and dstate = a_1 g_1. Layouts (all contiguous f32): u, dt, dy, du, ddt
// (B, T, di); Bm, Cm, dB, dC (B, T, N); A, dA (di, N); D, dD (di,);
// state, dstate_out, dstate (B, di, N); ck (B, ceil(T / 8) - 1, di, N),
// the checkpoints ssm_scan.cu's training forward wrote: h_{8 c} for c =
// 1, 2, ...
//
// Bound on an H100 SXM at the train shape (hymba-1.5b: B 2, T 1024, di
// 3200, N 16): bytes. u, dt and dy read and du and ddt written are 131
// MB (0.039 ms); B, C and their gradients, the state and A add little;
// the operations, 23 an entry and step with the forward once, are 2.4
// GFLOP (0.036 ms at 67 TFLOP/s).
//
// Design.
// - Where h_{t-1} comes from. exp(dt A) underflows to exactly 0 at
//   hymba's A in [-16, -1], so no state is had by dividing. The training
//   forward (ops.SelectiveScan) writes the state every 8 steps; the
//   backward walks those 8-step chunks from the last to the first: it
//   runs a chunk forward from its checkpoint (staged with the chunk's
//   inputs), keeping a_t and h_{t-1} of each step in registers, then
//   walks it back. One exponential an entry and step, where the first
//   version took three.
// - Lanes as in ssm_scan.cu: a channel's N entries over L lanes, two a
//   lane (L the next power of two >= N / 2, at most 32; N 1 one entry), a
//   CTA of 128 threads over CH = 128 / L channels of one batch row (16 at
//   N 16): hymba's train shape runs 400 CTAs, 4 an SM (128 registers a
//   thread at most, so no instantiation spills), 12 warps an SM. A
//   variant with one entry a lane and twice the warps ran slower in
//   development runs: each lane then repeats the channel's loads and
//   products for half the work.
// - The sums. du and ddt sum over a channel's lanes: each lane keeps its
//   partial for each step of the chunk (16 values), and one
//   transpose-reduce over the channel's lanes a chunk (hopper::
//   reduce_steps) leaves each lane one sum or two; they reach device
//   memory in rows of the CTA's channels. dB and dC sum over d_inner:
//   each lane stores its step's partials to shared memory, the CTA adds
//   its channels in order, and clusters of 8 CTAs (consecutive channel
//   blocks; the grid padded to a multiple with CTAs that hold no channel)
//   add their partials every 8 chunks, after a cluster barrier, in rank
//   order through distributed shared memory (16-byte loads): one partial
//   per 128 channels reaches device memory (the first version: one per
//   16), and a second launch adds them over the clusters, and dA and dD
//   over b, in a fixed order. No atomics: two calls give the same bits.
// - Staging: B, C (N values) and u, dt, dy (the CTA's channels) of a
//   chunk and its starting state by 16-byte `cp.async` where rows allow
//   (4-byte otherwise) into a ring of two, the chunk before in flight
//   while one is walked; 44 KB of shared memory a CTA at N 16.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; CUDA events,
// L2 flushed): 0.3466 ms at the train shape, 8.7x the bound (the kernel
// 0.3290, the sums 0.0070 by the profiler); the training forward there
// 0.1522 ms against the serving call's 0.1389. Left on the table: 12
// warps an SM leave the chain's latencies exposed, and the cluster
// barrier is a GPU-wide fence. The first version (PR 23) ran the forward
// again first for its own 16-step checkpoints, recomputed each chunk with
// exp(dt A) again and recomputed it once more walking back, added dB / dC
// over a warp's channels with a butterfly every step and wrote one
// partial per 16 channels: 0.6094 ms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using hopper::cluster_arrive;
using hopper::cluster_wait;
using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::Flag;
using hopper::reduce_steps;

constexpr int kTC = 8;          // steps a chunk: ssm_scan.cu's kCk
constexpr int kBatch = 8;       // steps whose du / ddt sums reduce at once
constexpr int kGroup = 8;       // chunks whose dB / dC partials cross the
//                                 cluster at one barrier
constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;  // channel blocks whose dB / dC add on chip

// L lanes a channel, E entries a lane
template <int L, int E>
struct Geo {
  static constexpr int kL = L, kE = E;
  static constexpr int kCh = kThreads / L;  // channels a CTA
  static constexpr int kNp = L * E;         // padded state row
  // B, C (kNp a step) and u, dt, dy (kCh a step) of a chunk, and the
  // state at its start (kCh x kNp) (floats)
  static constexpr int kStage = kTC * (2 * kNp + 3 * kCh) + kCh * kNp;
  static constexpr int kPbs = kTC * kThreads * 2 * E;  // dB, dC of a lane
  static constexpr int kCb = kGroup * kTC * 2 * kNp;  // the CTA's, x2
  static constexpr int kDud = kTC * 2 * kCh;  // du, ddt sums
  static constexpr int kSmem = 4 * (2 * kStage + kPbs + 2 * kCb + kDud);
  static_assert(kSmem <= 227 * 1024, "shared memory past a CTA's limit");
};

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int L, int E>
__global__ void __launch_bounds__(kThreads, 4)
    ssm_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   const float* __restrict__ state,
                   const float* __restrict__ ck,
                   const float* __restrict__ dy,
                   const float* __restrict__ dstate_out,
                   float* __restrict__ du, float* __restrict__ ddt,
                   float* __restrict__ dstate, float* __restrict__ partB,
                   float* __restrict__ partC, float* __restrict__ dApart,
                   float* __restrict__ dDpart, int T, int di, int N,
                   int vec) {
  using Gm = Geo<L, E>;
  constexpr int NT = kThreads, CH = Gm::kCh, NP = Gm::kNp;
  constexpr int STAGE = Gm::kStage, CB = Gm::kCb;
  constexpr int W = L < 2 * kBatch ? L : 2 * kBatch;  // lanes a sum lands on
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* pbs = sm + 2 * STAGE;  // pbs[(tt * NT + tid) * 2E + {B, C} * E + e]
  // cb[par * CB + ((slot * kTC + tt) * 2 + {B, C}) * NP + n]
  float* cb = pbs + Gm::kPbs;
  float* dud = cb + 2 * CB;     // dud[(tt * 2 + {du, ddt}) * CH + c]

  cg::cluster_group cluster = cg::this_cluster();
  const int K = cluster.num_blocks(), rank = cluster.block_rank();
  const int G = gridDim.x / K, grp = blockIdx.x / K;  // cluster of the row
  const int cb_idx = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int d0 = cb_idx * CH;
  const int c = tid / L;  // channel in the CTA
  const int g = tid % L;  // lane in the channel's group
  const int d = d0 + c;
  const bool on = d < di;
  const int nck = (T + kTC - 1) / kTC;

  float a_[E];
  const size_t s_off = ((size_t)b * di + d) * N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int n = g * E + e;
    a_[e] = on && n < N ? A[(size_t)d * N + n] : 0.f;
  }

  // steps [ch * kTC, +nt) into stage `buf`: B, C (bs[tt * NP + n]) and
  // u, dt, dy (us[tt * CH + c]); entries past N and channels past di
  // zero. With `vec` (N and di multiples of 4, every row 16-byte aligned)
  // 16 bytes a copy, else 4.
  auto stage = [&](int buf, int ch) {
    // the thread's pieces, worked out anew each call: kept across the
    // chunk loop they would hold registers the walk needs
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    float* bs = sm + buf * STAGE;     // then cs (kTC * NP)
    float* us = bs + 2 * kTC * NP;    // then ds, ys (kTC * CH each)
    float* hs0 = us + 3 * kTC * CH;   // hs0[c * NP + n]
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    const size_t row = (size_t)b * T + t0;
    // the state at the chunk's start: the initial state, else a checkpoint
    const float* hsrc =
        (ch == 0 ? state : ck + ((size_t)b * (nck - 1) + ch - 1) * di * N) +
        ((size_t)(ch == 0 ? b : 0) * di + d0) * N;
    if (vec) {
      constexpr int QB = NP / 4;
      for (int p = tid; p < CH * QB; p += NT) {
        const int cc = p / QB, n = (p % QB) * 4;
        const bool ok = d0 + cc < di && n < N;
        cp_async16(hs0 + p * 4, hsrc + (ok ? cc * N + n : 0), ok);
      }
    } else {
      for (int p = tid; p < CH * NP; p += NT) {
        const int cc = p / NP, n = p % NP;
        const bool ok = d0 + cc < di && n < N;
        cp_async4(hs0 + p, hsrc + (ok ? cc * N + n : 0), ok);
      }
    }
    if (vec) {
      constexpr int QB = NP / 4, QU = CH / 4;  // 16-byte pieces of a step
      for (int p = tid; p < 2 * kTC * QB; p += NT) {
        const int a = p / (kTC * QB), q = p % (kTC * QB);
        const int tt = q / QB, n = (q % QB) * 4;
        const bool ok = tt < nt && n < N;
        cp_async16(bs + a * kTC * NP + q * 4,
                   (a ? Cm : Bm) + row * N + (ok ? tt * N + n : 0), ok);
      }
      for (int p = tid; p < 3 * kTC * QU; p += NT) {
        const int a = p / (kTC * QU), q = p % (kTC * QU);
        const int tt = q / QU, cc = d0 + (q % QU) * 4;
        const bool ok = tt < nt && cc < di;
        cp_async16(us + a * kTC * CH + q * 4,
                   (a == 0 ? u : a == 1 ? dt : dy) + row * di +
                       (ok ? tt * di + cc : 0),
                   ok);
      }
    } else {
      for (int p = tid; p < 2 * kTC * NP; p += NT) {
        const int a = p / (kTC * NP), q = p % (kTC * NP);
        const int tt = q / NP, n = q % NP;
        const bool ok = tt < nt && n < N;
        cp_async4(bs + p, (a ? Cm : Bm) + row * N + (ok ? tt * N + n : 0),
                  ok);
      }
      for (int p = tid; p < 3 * kTC * CH; p += NT) {
        const int a = p / (kTC * CH), q = p % (kTC * CH);
        const int tt = q / CH, cc = d0 + q % CH;
        const bool ok = tt < nt && cc < di;
        cp_async4(us + p,
                  (a == 0 ? u : a == 1 ? dt : dy) + row * di +
                      (ok ? tt * di + cc : 0),
                  ok);
      }
    }
  };
  auto load_entries = [&](const float* src, size_t off, float (&x)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int n = g * E + e;
      x[e] = on && n < N ? src[off + n] : 0.f;
    }
  };

  // the channel whose du this thread writes (NT is a multiple of CH), and
  // its D
  const int fc = tid % CH;
  const float D_f = d0 + fc < di ? D[d0 + fc] : 0.f;
  float gc[E], dA_acc[E], h[E];  // a_{t+1} g_{t+1}; dA; h
  float dD_acc = 0.f;
  load_entries(dstate_out, s_off, gc);
#pragma unroll
  for (int e = 0; e < E; ++e) dA_acc[e] = 0.f;
  // the group of chunks before (its first chunk pch, pn chunks): its
  // (slot, {B, C}, n)s at this CTA's slots (those rank mod K), the
  // cluster's partials added in rank order, one partial per cluster to
  // device memory
  int par = 0, pch = -1, pn = 0;
  auto cluster_pass = [&]() {
    const float* cbp = cb + (par ^ 1) * CB;
    constexpr int QB = NP >= 4 ? NP / 4 : 1;  // 16-byte pieces of a row
    constexpr int PW = NP >= 4 ? 4 : NP;      // floats a piece
    const int kind = (tid / QB) % 2, n = (tid % QB) * PW;
    if (n >= N) return;
    float* part = (kind ? partC : partB) + ((size_t)b * G + grp) * T * N;
    for (int sl = rank + K * (tid / (2 * QB)); sl < pn * kTC;
         sl += K * (NT / (2 * QB))) {
      const int t = (pch - sl / kTC) * kTC + sl % kTC;
      if (t >= T) continue;
      const float* src = cbp + (sl * 2 + kind) * NP + n;
      float a[PW];
      if constexpr (PW == 4) {
        float4 x[kMaxCluster];
#pragma unroll
        for (int q2 = 0; q2 < kMaxCluster; ++q2)
          x[q2] = q2 < K ? *cluster.map_shared_rank(
                               reinterpret_cast<const float4*>(src), q2)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        a[0] = x[0].x, a[1] = x[0].y, a[2] = x[0].z, a[3] = x[0].w;
#pragma unroll
        for (int q2 = 1; q2 < kMaxCluster; ++q2)
          if (q2 < K)
            a[0] += x[q2].x, a[1] += x[q2].y, a[2] += x[q2].z,
                a[3] += x[q2].w;
      } else {
#pragma unroll
        for (int e = 0; e < PW; ++e) {
          float x[kMaxCluster];
#pragma unroll
          for (int q2 = 0; q2 < kMaxCluster; ++q2)
            x[q2] = q2 < K ? *cluster.map_shared_rank(src + e, q2) : 0.f;
          a[e] = x[0];
#pragma unroll
          for (int q2 = 1; q2 < kMaxCluster; ++q2)
            if (q2 < K) a[e] += x[q2];
        }
      }
#pragma unroll
      for (int e = 0; e < PW; ++e)
        if (n + e < N) part[(size_t)t * N + n + e] = a[e];
    }
  };  stage(0, nck - 1);
  cp_async_commit();
  for (int ch = nck - 1, q = 0; ch >= 0; --ch, ++q) {
    const int buf = q & 1, slot = q % kGroup;
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is finished
    if (ch > 0) stage(buf ^ 1, ch - 1);
    cp_async_commit();
    const float* bs = sm + buf * STAGE;
    const float* cs = bs + kTC * NP;
    const float* us = cs + kTC * NP;
    const float* ds = us + kTC * CH;
    const float* ys = ds + kTC * CH;
    const float* hs0 = ys + kTC * CH;
#pragma unroll
    for (int e = 0; e < E; ++e) h[e] = hs0[c * NP + g * E + e];
    // forward over the chunk, a_t and h_{t-1} of each step kept, then back
    // over it. `full`: a whole chunk, no step to skip.
    auto walk = [&](auto full) {
      constexpr bool F = decltype(full)::value;
      float hs[kTC][E], as[kTC][E];
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) {
        if (F || tt < nt) {
          const float uv = us[tt * CH + c], dtv = ds[tt * CH + c];
          const float du_ = dtv * uv;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float a = expf(dtv * a_[e]);
            hs[tt][e] = h[e];
            as[tt][e] = a;
            h[e] = fmaf(a, h[e], du_ * bs[tt * NP + g * E + e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) hs[tt][e] = as[tt][e] = 0.f;
        }
      }
      // h is now the state after the chunk's last step; back over it, the
      // channel's du and ddt partials of each step batched, 8 steps a batch
#pragma unroll
      for (int hb = kTC / kBatch - 1; hb >= 0; --hb) {
        float vals[2 * kBatch];
#pragma unroll
        for (int k8 = kBatch - 1; k8 >= 0; --k8) {
          const int tt = hb * kBatch + k8;
          vals[k8] = vals[kBatch + k8] = 0.f;
          if (F || tt < nt) {
            const float uv = us[tt * CH + c], dtv = ds[tt * CH + c];
            const float yv = ys[tt * CH + c];
            const float du_ = dtv * uv;
            float su = 0.f, sdt = 0.f, pbc[2 * E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float bv = bs[tt * NP + g * E + e];
              const float cv = cs[tt * NP + g * E + e];
              const float gg = fmaf(yv, cv, gc[e]);  // g_t
              const float ah = as[tt][e] * hs[tt][e];
              pbc[e] = gg * du_;
              pbc[E + e] = yv * h[e];
              su = fmaf(gg, bv, su);
              sdt = fmaf(gg, fmaf(a_[e], ah, uv * bv), sdt);
              dA_acc[e] = fmaf(gg * dtv, ah, dA_acc[e]);
              gc[e] = as[tt][e] * gg;
              h[e] = hs[tt][e];
            }
            store_n<2 * E>(pbs + (tt * NT + tid) * 2 * E, pbc);
            vals[k8] = su;
            vals[kBatch + k8] = sdt;
            if (g == 0) dD_acc = fmaf(yv, uv, dD_acc);
          }
        }
        reduce_steps<L, 2 * kBatch>(vals, g);
        // lane g holds in vals[q] the channel's sum of value q W + g % W:
        // step % 8 of the batch's du sums (< 8) or ddt's
#pragma unroll
        for (int q2 = 0; q2 < 2 * kBatch / W; ++q2) {
          const int x = q2 * W + g % W;
          if (g < W)
            dud[((hb * kBatch + x % kBatch) * 2 + x / kBatch) * CH + c] =
                vals[q2];
        }
      }
    };
    if (nt == kTC)
      walk(Flag<true>{});
    else
      walk(Flag<false>{});
    __syncthreads();  // the chunk's sums and dB / dC partials are in
    if (slot == 0 && pch >= 0) {  // the group before: every CTA's is in
      cluster_wait();
      cluster_pass();
    }
    // the CTA's dB, dC partials of (step, n): its channels added in order
    float* cbp = cb + par * CB + slot * kTC * 2 * NP;
    for (int e = tid; e < nt * 2 * NP; e += NT) {
      const int tt = e / (2 * NP), kind = (e / NP) % 2, n = e % NP;
      const float* x = pbs + (tt * NT + n / E) * 2 * E + kind * E + n % E;
      // the loads of up to 16 channels issued before their adds
      constexpr int G = CH < 16 ? CH : 16;
      float a = x[0];
#pragma unroll
      for (int c0 = 0; c0 < CH; c0 += G) {
        float xs[G];
#pragma unroll
        for (int k = 0; k < G; ++k)
          xs[k] = c0 + k > 0 ? x[(c0 + k) * L * 2 * E] : 0.f;
#pragma unroll
        for (int k = 0; k < G; ++k)
          if (c0 + k > 0) a += xs[k];
      }
      cbp[e] = a;
    }
    if (slot == kGroup - 1 || ch == 0) {  // the group's partials are in
      cluster_arrive();
      pch = ch + slot, pn = slot + 1;
      par ^= 1;
    }
    // du, ddt of (step, channel), in rows of the CTA's channels
    if (d0 + fc < di) {
      for (int tt = tid / CH; tt < nt; tt += NT / CH) {
        const size_t o = ((size_t)b * T + t0 + tt) * di + d0 + fc;
        du[o] = fmaf(D_f, ys[tt * CH + fc],
                     ds[tt * CH + fc] * dud[(tt * 2) * CH + fc]);
        ddt[o] = dud[(tt * 2 + 1) * CH + fc];
      }
    }
  }
  cp_async_wait<0>();
  cluster_wait();
  cluster_pass();  // the last group
  if (on) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int n = g * E + e;
      if (n < N) {
        dstate[s_off + n] = gc[e];
        dApart[s_off + n] = dA_acc[e];
      }
    }
    if (g == 0) dDpart[(size_t)b * di + d] = dD_acc;
  }
  cluster.sync();  // no CTA leaves while a peer may read its partials
}

// dB, dC = the sums of the clusters' partials; dA, dD = the sums of the
// batch rows' partials; each in a fixed order
__global__ void ssm_bwd_sum(const float* __restrict__ partB,
                            const float* __restrict__ partC,
                            const float* __restrict__ dApart,
                            const float* __restrict__ dDpart,
                            float* __restrict__ dB, float* __restrict__ dC,
                            float* __restrict__ dA, float* __restrict__ dD,
                            int B, int T, int di, int N, int G) {
  const size_t n_bc = (size_t)B * T * N, n_a = (size_t)di * N;
  const size_t n = n_bc + n_a + di;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_bc) {
      const size_t b = idx / ((size_t)T * N), tn = idx % ((size_t)T * N);
      const size_t off = b * G * T * N + tn;
      float sb = partB[off], sc = partC[off];
      for (int q = 1; q < G; ++q) {
        sb += partB[off + (size_t)q * T * N];
        sc += partC[off + (size_t)q * T * N];
      }
      dB[idx] = sb;
      dC[idx] = sc;
    } else if (idx < n_bc + n_a) {
      const size_t q = idx - n_bc;
      float s = dApart[q];
      for (int b = 1; b < B; ++b) s += dApart[(size_t)b * n_a + q];
      dA[q] = s;
    } else {
      const size_t q = idx - n_bc - n_a;
      float s = dDpart[q];
      for (int b = 1; b < B; ++b) s += dDpart[(size_t)b * di + q];
      dD[q] = s;
    }
  }
}

// f(Geo<L, E>{}) for state size N: ssm_scan.cu's lane layout, L the next
// power of two >= N / 2 (at most 32), two entries a lane
template <class F>
int by_state(int N, F f) {
  if (N == 1) return f(Geo<1, 1>{});
  if (N == 2) return f(Geo<1, 2>{});
  if (N <= 4) return f(Geo<2, 2>{});
  if (N <= 8) return f(Geo<4, 2>{});
  if (N <= 16) return f(Geo<8, 2>{});
  if (N <= 32) return f(Geo<16, 2>{});
  return f(Geo<32, 2>{});
}

bool takes(int B, int T, int di, int N) {
  return N >= 1 && N <= 64 && di >= 1 && T >= 1 && B >= 1 && B <= 65535;
}

// the launch of a call: grid (clusters x cluster, B), cluster (cluster,
// 1, 1); the channel blocks padded to a multiple of the cluster
template <class Gm>
cudaLaunchConfig_t config(int B, int di, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int* G) {
  const int ncb = (di + Gm::kCh - 1) / Gm::kCh;
  const int cl = ncb < kMaxCluster ? ncb : kMaxCluster;
  *G = (ncb + cl - 1) / cl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(*G * cl, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Gm::kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The geometry of a call: geo[0] the lanes of a channel, geo[1] the
// channels of a CTA, geo[2] its dynamic shared memory in bytes, geo[3]
// the cluster, geo[4] the clusters of a batch row. Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssm_scan_bwd_geometry(int B, int T, int di, int N,
                                     int* geo) {
  if (!takes(B, T, di, N)) return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto gm) {
    using Gm = decltype(gm);
    cudaLaunchAttribute attr[1];
    int G;
    const cudaLaunchConfig_t cfg = config<Gm>(B, di, nullptr, attr, &G);
    geo[0] = Gm::kL;
    geo[1] = Gm::kCh;
    geo[2] = Gm::kSmem;
    geo[3] = (int)cfg.gridDim.x / G;
    geo[4] = G;
    return 0;
  });
}

// The clusters of this call's shape the card can hold at once
// (cudaOccupancyMaxActiveClusters) to *n; returns the CUDA error.
extern "C" int ssm_scan_bwd_max_clusters(int B, int T, int di, int N,
                                         int* n) {
  if (!takes(B, T, di, N)) return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto gm) {
    using Gm = decltype(gm);
    auto kern = ssm_bwd_kernel<Gm::kL, Gm::kE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    int G;
    const cudaLaunchConfig_t cfg = config<Gm>(B, di, nullptr, attr, &G);
    return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
  });
}

// Writes the floats of the four scratch buffers a call at this shape
// needs to sizes[0..3]: the clusters' dB and dC partials (partB, partC)
// and the batch rows' dA and dD partials (dApart, dDpart). Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssm_scan_bwd_scratch(int B, int T, int di, int N,
                                    long long* sizes) {
  if (!takes(B, T, di, N)) return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto gm) {
    using Gm = decltype(gm);
    cudaLaunchAttribute attr[1];
    int G;
    config<Gm>(B, di, nullptr, attr, &G);
    sizes[0] = sizes[1] = (long long)B * G * T * N;
    sizes[2] = (long long)B * di * N;
    sizes[3] = (long long)B * di;
    return 0;
  });
}

// Launches the kernel, then the fixed-order sums of dB, dC, dA and dD, on
// `stream`, and returns the first launch error (0 = both queued). ck holds
// the checkpoints ssm_scan.cu's training forward wrote for these inputs
// (null when T <= 8); partB, partC, dApart and dDpart are scratch of the
// sizes ssm_scan_bwd_scratch gives; vec is 1 when N and di are multiples
// of 4 and every row of u, dt, dy, Bm, Cm, state and ck starts 16-byte
// aligned (16-byte staging), else 0.
extern "C" int ssm_scan_bwd(const float* u, const float* dt, const float* Bm,
                            const float* Cm, const float* A, const float* D,
                            const float* state, const float* ck,
                            const float* dy, const float* dstate_out,
                            float* du, float* ddt, float* dB, float* dC,
                            float* dA, float* dD, float* dstate,
                            float* partB, float* partC, float* dApart,
                            float* dDpart, int B, int T, int di, int N,
                            int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(B, T, di, N) || (T > kTC && !ck) || (vec && (N % 4 || di % 4)))
    return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto gm) {
    using Gm = decltype(gm);
    auto kern = ssm_bwd_kernel<Gm::kL, Gm::kE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    int G;
    const cudaLaunchConfig_t cfg = config<Gm>(B, di, st, attr, &G);
    err = cudaLaunchKernelEx(&cfg, kern, u, dt, Bm, Cm, A, D, state, ck, dy,
                             dstate_out, du, ddt, dstate, partB, partC,
                             dApart, dDpart, T, di, N, vec);
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)B * T * N + (size_t)di * N + di;
    const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                        : 132 * 16);
    ssm_bwd_sum<<<blocks, 256, 0, st>>>(partB, partC, dApart, dDpart, dB, dC,
                                        dA, dD, B, T, di, N, G);
    return (int)cudaGetLastError();
  });
}
