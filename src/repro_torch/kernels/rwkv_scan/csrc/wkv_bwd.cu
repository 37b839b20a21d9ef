// RWKV-6 WKV backward for Hopper (sm_90a): the gradient of wkv.cu's
// function, f32, any T >= 1, head dim <= 128.
//
// Replaces no TPU kernel: the reference takes the gradient of
// `_wkv_kernel`'s function (src/repro/kernels/rwkv_scan/kernel.py:29)
// through XLA's `lax.scan` (src/repro/models/rwkv6.py:80). Per batch row
// b and head h, with S_t the (hd x hd) state after step t (rows i the key
// dim, columns j the value dim) and dS_t its gradient (dS_T =
// dstate_out):
//     dr_t[i] = sum_j dout_t[j] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//     dk_t[i] = u[i] r_t[i] (dout_t . v_t) + sum_j dS_t[i][j] v_t[j]
//     dv_t[j] = dout_t[j] sum_i r_t[i] u[i] k_t[i]
//               + sum_i k_t[i] dS_t[i][j]
//     dw_t[i] = sum_j dS_t[i][j] S_{t-1}[i][j]
//     du[h][i] = sum_{b,t} r_t[i] k_t[i] (dout_t . v_t)
//     dS_{t-1}[i][j] = w_t[i] dS_t[i][j] + r_t[i] dout_t[j]
// and dstate = dS_0. Layouts (all contiguous f32): r, k, v, w, dout and
// dr, dk, dv, dw (B, T, H, hd); u, du (H, hd); state, dstate_out, dstate
// (B, H, hd, hd); ck (B, H, ceil(T / 8) - 1, hd, hd), the checkpoints
// wkv.cu's training forward wrote: S_{8 c} for c = 1, 2, ..., transposed
// (S[i][j] at [..., j, i]).
//
// Bound on an H100 SXM at the train shape (rwkv6-1.6b: B 2, T 1024, H
// 32, hd 64): 14 f32 operations a state entry and step (the forward
// once, for S_{t-1}, then the FMAs of dr, dk, dw and dv and the dS
// update), 3.76 GFLOP at 67 TFLOP/s, 0.056 ms; its bytes (r, k, v, w,
// dout read, dr, dk, dv, dw written, the state and its gradients) are
// 154 MB, 0.046 ms.
//
// Design.
// - Where S_{t-1} comes from. The decays underflow to exactly 0 in the
//   model, so S_{t-1} cannot be had by dividing S_t by w_t. The training
//   forward (ops.WKV) writes the state every 8 steps; the backward walks
//   those 8-step chunks from the last to the first: it runs a chunk
//   forward from its checkpoint keeping S_{t-1} in registers (8 steps x
//   8 entries a lane), then walks it back. Nothing runs over all of T
//   twice.
// - Who owns what. A lane holds two rows of a (b, h) and 4 columns (runs
//   of 4 at a stride of 4 lanes' worth, so a quarter-warp's 16-byte loads
//   of v and dout read 128 consecutive bytes): 16 lanes a row pair at hd
//   64, a CTA of 256 threads 32 rows. The row sums are taken off the
//   recurrence in batches: a lane keeps its partials of dr for each step
//   and row of the chunk (16 values) while it runs forward, and of dk and
//   dw (32) while it walks back; one transpose-reduce over the row pair's
//   lanes for each batch (hopper::reduce_steps) leaves each lane a sum or
//   two, which it puts in shared memory. dout . v and the CTA rows' sum
//   of r u k take one warp a step. A lane's step is 40 FMAs.
// - dv crosses the ceil(hd / RB) CTAs of a head (2 at hd 40 and 64, 1 at
//   32, 8 at 128, RB 16 there): they run as one thread-block cluster. Each
//   lane stores its columns' partials over its two rows (k_t[i]
//   dS_t[i][j]) to shared memory; the CTA adds its row pairs in order and
//   dout_t[j] times its rows' sum of r u k; every 4 chunks, after a
//   cluster barrier, each CTA adds a share of the (step, column) sums
//   over the cluster's CTAs in rank order through distributed shared
//   memory (16-byte loads) and writes dv. Every hd <= 128 takes a cluster
//   of at most 8, so no shape needs another route. 32-row CTAs put one
//   CTA on an SM: with 16-row CTAs in clusters of 4 the card packed 3
//   CTAs on some SMs and left others idle. du (over b) is left as per-(b,
//   h) partials that a second launch adds in a fixed order. No atomics:
//   two calls give the same bits.
// - One barrier a chunk: while a chunk is walked, the one before it is
//   finished (dr, dk, dw written, dv's partial summed), from a ring of
//   three stages (r, k, w of the CTA's rows, v, dout of every column and
//   the chunk's starting state, by 16-byte `cp.async` where rows allow)
//   and two of every other buffer.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; CUDA events,
// L2 flushed): 0.4569 ms at the train shape, 8.1x the bound (the kernel
// 0.4489, du's sum 0.0013 by the profiler); the training forward there
// 0.1234 ms against the serving call's 0.1037. Left on the table: with
// one CTA of 8 warps an SM the walk is latency-bound, and each cluster
// barrier's release / acquire is a GPU-wide fence and an L1 invalidate.
// The first version (PR 23) ran the forward again first to write its own
// checkpoints, recomputed each chunk into a 64 KB shared buffer (2 CTAs an
// SM), reduced 13 row sums a step over 32 lanes, and sent dv's row-block
// partials through device memory to a second launch: 0.5664 ms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
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

constexpr int kTC = 8;       // steps a chunk: wkv.cu's checkpoint interval
constexpr int kGroup = 4;    // chunks whose dv partials cross the cluster
//                              at one barrier
constexpr int kMaxCluster = 8;

// Two rows and C columns a lane, LR lanes a row pair (the head dim padded
// to LR C), RB rows a CTA. A lane's columns are C / 4 runs of 4 at a
// stride of 4 LR, so a quarter-warp's 16-byte loads of v and dout read 128
// consecutive bytes.
template <int C, int LR, int RB>
struct Geo {
  static constexpr int kC = C, kLR = LR, kRB = RB;
  static constexpr int kThreads = RB / 2 * LR;
  static constexpr int kHdp = LR * C;  // padded head dim
  // r, k, w of the CTA's rows and v, dout of a chunk; the state at its
  // start, column-major (floats)
  static constexpr int kStage = kTC * (3 * RB + 2 * kHdp) + kHdp * RB;
  static constexpr int kWp = kTC * RB / 2 * kHdp;    // dv partials, row pairs
  static constexpr int kCb = kGroup * kTC * kHdp;    // the CTA's dv partials
  static constexpr int kRed = kTC * RB * 3;          // dr, dk, dw row sums
  // a ring of three stages, two of everything else (one chunk is walked
  // while the one before is finished), the rows' u, a du partial a thread
  static constexpr int kSmem =
      4 * (3 * kStage + 2 * (kWp + kCb + kRed + 2 * kTC) + RB + kThreads);
  static_assert((C == 2 || C % 4 == 0) && kThreads % RB == 0 &&
                    (2 * kTC * kHdp / 4) % 32 == 0,
                "a finishing thread's row fixed, whole warps in the dv sum");
  static_assert(kSmem <= 227 * 1024, "shared memory past a CTA's limit");
};

// the lane's c-th column: a pair at C 2, else runs of 4 at a stride of 4 LR
template <int C, int LR>
__device__ __forceinline__ int col(int g, int c) {
  if constexpr (C == 2) return 2 * g + c;
  return (c / 4) * 4 * LR + 4 * g + c % 4;
}

// a lane's C columns of a row of shared memory, 8 or 16 bytes at a time
template <int C, int LR>
__device__ __forceinline__ void load_cols(const float* p, int g,
                                          float (&x)[C]) {
  if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + 2 * g);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 t =
          *reinterpret_cast<const float4*>(p + col<C, LR>(g, 4 * q));
      x[4 * q] = t.x, x[4 * q + 1] = t.y, x[4 * q + 2] = t.z,
      x[4 * q + 3] = t.w;
    }
  }
}

template <int C, int LR>
__device__ __forceinline__ void store_cols(float* p, int g,
                                           const float (&x)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p + 2 * g) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      *reinterpret_cast<float4*>(p + col<C, LR>(g, 4 * q)) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

template <int C, int LR, int RB>
__global__ void __launch_bounds__(Geo<C, LR, RB>::kThreads, 1)
    wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ state,
                   const float* __restrict__ ck,
                   const float* __restrict__ dout,
                   const float* __restrict__ dstate_out,
                   float* __restrict__ dr, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ dw,
                   float* __restrict__ dstate, float* __restrict__ dupart,
                   int T, int H, int hd, int vec) {
  using Gm = Geo<C, LR, RB>;
  constexpr int NT = Gm::kThreads, HDP = Gm::kHdp;
  constexpr int STAGE = Gm::kStage, CB = Gm::kCb;
  constexpr int WP = Gm::kWp, RED = Gm::kRed;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* wp = sm + 3 * STAGE;     // wp[x * WP + (tt * RB / 2 + rp) * HDP + j]
  // cb[par * CB + (slot * kTC + tt) * HDP + j]
  float* cb = wp + 2 * WP;
  float* red = cb + 2 * CB;       // red[x * RED + (tt * RB + row) * 3 + kind]
  float* dots = red + 2 * RED;    // dots[x * kTC + tt]: dout . v
  float* ruks = dots + 2 * kTC;   // ruks[x * kTC + tt]: sum of r u k
  float* urow = ruks + 2 * kTC;   // u of the CTA's rows
  float* dus = urow + RB;         // du partials, one a thread

  cg::cluster_group cluster = cg::this_cluster();
  const int rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nrb = gridDim.x;  // the cluster: a head's row blocks
  const int tid = threadIdx.x, g = tid % LR, lane = tid % 32;
  const int rp = tid / LR;  // the lane's row pair: rows 2 rp, 2 rp + 1
  const int i = rb * RB + 2 * rp;
  const size_t bh = (size_t)b * H + h;
  const int nck = (T + kTC - 1) / kTC;
  const int step = H * hd;  // floats between two steps' rows

  // chunk ch into stage `buf`: r, k, w of the CTA's rows and v, dout of
  // every column at steps [ch * kTC, +nt), and the state at its start,
  // column-major (the initial state, else the forward's checkpoint, which
  // is stored so); rows and columns past hd zero. With `vec` (hd % 4 == 0,
  // every row 16-byte aligned) 16 bytes a copy, else 4.
  auto stage = [&](int buf, int ch) {
    // the thread's pieces, worked out anew each call: kept across the
    // chunk loop they would hold registers the walk needs
    int tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
    float* rs = sm + buf * STAGE;     // then ks, ws (kTC * RB each)
    float* vs = rs + 3 * kTC * RB;    // then os (kTC * HDP)
    float* cs = vs + 2 * kTC * HDP;
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    const size_t base = (((size_t)b * T + t0) * H + h) * hd;
    constexpr int Q = RB / 4, QV = HDP / 4;  // 16-byte pieces of a row
    if (vec) {
      for (int p = tid; p < 3 * kTC * Q; p += NT) {
        const int a = p / (kTC * Q), q = p % (kTC * Q);
        const int tt = q / Q, ii = rb * RB + (q % Q) * 4;
        const bool ok = tt < nt && ii < hd;
        const float* src = (a == 0 ? r : a == 1 ? k : w) + base;
        cp_async16(rs + a * kTC * RB + q * 4, src + (ok ? tt * step + ii : 0),
                   ok);
      }
      for (int p = tid; p < 2 * kTC * QV; p += NT) {
        const int a = p / (kTC * QV), q = p % (kTC * QV);
        const int tt = q / QV, j = (q % QV) * 4;
        const bool ok = tt < nt && j < hd;
        const float* src = (a == 0 ? v : dout) + base;
        cp_async16(vs + a * kTC * HDP + q * 4, src + (ok ? tt * step + j : 0),
                   ok);
      }
    } else {
      for (int p = tid; p < 3 * kTC * RB; p += NT) {
        const int a = p / (kTC * RB), q = p % (kTC * RB);
        const int tt = q / RB, ii = rb * RB + q % RB;
        const bool ok = tt < nt && ii < hd;
        const float* src = (a == 0 ? r : a == 1 ? k : w) + base;
        cp_async4(rs + p, src + (ok ? tt * step + ii : 0), ok);
      }
      for (int p = tid; p < 2 * kTC * HDP; p += NT) {
        const int a = p / (kTC * HDP), q = p % (kTC * HDP);
        const int tt = q / HDP, j = q % HDP;
        const bool ok = tt < nt && j < hd;
        const float* src = (a == 0 ? v : dout) + base;
        cp_async4(vs + p, src + (ok ? tt * step + j : 0), ok);
      }
    }
    if (ch == 0) {  // row-major: consecutive threads along j
      for (int e = tid; e < RB * HDP; e += NT) {
        const int rr = e / HDP, j = e % HDP, ii = rb * RB + rr;
        const bool ok = ii < hd && j < hd;
        cp_async4(cs + j * RB + rr,
                  state + (ok ? (bh * hd + ii) * hd + j : 0), ok);
      }
    } else {  // transposed: a column's rows are contiguous
      const float* src = ck + (bh * (nck - 1) + ch - 1) * hd * hd;
      if (vec) {
        for (int p = tid; p < HDP * Q; p += NT) {
          const int j = p / Q, ii = rb * RB + (p % Q) * 4;
          const bool ok = ii < hd && j < hd;
          cp_async16(cs + p * 4, src + (ok ? j * hd + ii : 0), ok);
        }
      } else {
        for (int e = tid; e < HDP * RB; e += NT) {
          const int j = e / RB, ii = rb * RB + e % RB;
          const bool ok = ii < hd && j < hd;
          cp_async4(cs + e, src + (ok ? j * hd + ii : 0), ok);
        }
      }
    }
  };

  float dS[2][C];
#pragma unroll
  for (int y = 0; y < 2; ++y)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = col<C, LR>(g, c);
      dS[y][c] = i + y < hd && j < hd
                     ? dstate_out[(bh * hd + i + y) * hd + j] : 0.f;
    }
  // the row this thread finishes, and its u
  const int frow = tid % RB;
  const float u_f = rb * RB + frow < hd ? u[(size_t)h * hd + rb * RB + frow]
                                        : 0.f;
  float du_acc = 0.f;
  // dv of the group of chunks before (its first chunk pch, pn chunks),
  // this CTA's (slot, step)s of it (those rb mod nrb): the cluster's
  // partials added in rank order
  int par = 0, pch = -1, pn = 0;
  const size_t dvbase = ((size_t)b * T * H + h) * hd;
  auto cluster_pass = [&]() {
    const float* cbp = cb + (par ^ 1) * CB;
    constexpr int QV = HDP / 4;  // 16-byte pieces of a row
    const int j = (tid % QV) * 4;
    if (j >= hd) return;
    for (int s = rb + nrb * (tid / QV); s < pn * kTC; s += nrb * (NT / QV)) {
      const int t = (pch - s / kTC) * kTC + s % kTC;
      if (t >= T) continue;
      float4 x[kMaxCluster];
#pragma unroll
      for (int q2 = 0; q2 < kMaxCluster; ++q2)
        x[q2] = q2 < nrb ? *cluster.map_shared_rank(
                               reinterpret_cast<const float4*>(
                                   cbp + s * HDP + j), q2)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 a = x[0];
#pragma unroll
      for (int q2 = 1; q2 < kMaxCluster; ++q2)
        if (q2 < nrb) a.x += x[q2].x, a.y += x[q2].y, a.z += x[q2].z,
                      a.w += x[q2].w;
      float* o = dv + dvbase + (size_t)t * step + j;
      if (vec) {
        *reinterpret_cast<float4*>(o) = a;
      } else {
        const float y[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < hd) o[e] = y[e];
      }
    }
  };
  if (tid < RB)
    urow[tid] = rb * RB + tid < hd ? u[(size_t)h * hd + rb * RB + tid] : 0.f;
  // walk chunk ch (stage sb, buffers x): forward from its start with
  // S_{t-1} kept and dr's row partials of each step batched, then back.
  // `full`: a whole chunk, no step to skip.
  auto walk = [&](auto full, int ch, int sb, int x) {
    constexpr bool F = decltype(full)::value;
    const int nt = min(kTC, T - ch * kTC);
    const float* rs = sm + sb * STAGE;
    const float* ks = rs + kTC * RB;
    const float* ws = ks + kTC * RB;
    const float* vs = ws + kTC * RB;
    const float* os = vs + kTC * HDP;
    const float* cs = os + kTC * HDP;
    float* wpx = wp + x * WP;
    float* redx = red + x * RED;
    float S[2][C], prev[kTC][2][C], vf[2 * kTC], vals[4 * kTC];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float2 s2 = *reinterpret_cast<const float2*>(
          cs + col<C, LR>(g, c) * RB + 2 * rp);
      S[0][c] = s2.x, S[1][c] = s2.y;
    }
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      vf[tt] = vf[kTC + tt] = 0.f;
      if (F || tt < nt) {
        const float2 kk = *reinterpret_cast<const float2*>(
            ks + tt * RB + 2 * rp);
        const float2 ww = *reinterpret_cast<const float2*>(
            ws + tt * RB + 2 * rp);
        float vv[C], oo[C];
        load_cols<C, LR>(vs + tt * HDP, g, vv);
        load_cols<C, LR>(os + tt * HDP, g, oo);
        float dr0 = 0.f, dr1 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          prev[tt][0][c] = S[0][c];
          prev[tt][1][c] = S[1][c];
          dr0 = fmaf(oo[c], S[0][c], dr0);
          dr1 = fmaf(oo[c], S[1][c], dr1);
          S[0][c] = fmaf(ww.x, S[0][c], kk.x * vv[c]);
          S[1][c] = fmaf(ww.y, S[1][c], kk.y * vv[c]);
        }
        vf[tt] = dr0;
        vf[kTC + tt] = dr1;
      }
    }
    reduce_steps<LR, 2 * kTC>(vf, g);
    // lane g holds in vf[q] the sum of value q W + g % W (W = min(LR,
    // 16)): step % 8 of dr, of row pair / 8
    {
      constexpr int W = LR < 2 * kTC ? LR : 2 * kTC;
#pragma unroll
      for (int q2 = 0; q2 < 2 * kTC / W; ++q2) {
        const int xx = q2 * W + g % W;
        if (g < W)
          redx[((xx % kTC) * RB + 2 * rp + xx / kTC) * 3] = vf[q2];
      }
    }
#pragma unroll
    for (int tt = kTC - 1; tt >= 0; --tt) {
#pragma unroll
      for (int y = 0; y < 4; ++y) vals[y * kTC + tt] = 0.f;
      if (F || tt < nt) {
        const float2 rr = *reinterpret_cast<const float2*>(
            rs + tt * RB + 2 * rp);
        const float2 kk = *reinterpret_cast<const float2*>(
            ks + tt * RB + 2 * rp);
        const float2 ww = *reinterpret_cast<const float2*>(
            ws + tt * RB + 2 * rp);
        float vv[C], oo[C], dvp[C];
        load_cols<C, LR>(vs + tt * HDP, g, vv);
        load_cols<C, LR>(os + tt * HDP, g, oo);
        float dk0 = 0.f, dk1 = 0.f, dw0 = 0.f, dw1 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dk0 = fmaf(dS[0][c], vv[c], dk0);
          dk1 = fmaf(dS[1][c], vv[c], dk1);
          dw0 = fmaf(dS[0][c], prev[tt][0][c], dw0);
          dw1 = fmaf(dS[1][c], prev[tt][1][c], dw1);
          dvp[c] = fmaf(kk.y, dS[1][c], kk.x * dS[0][c]);
          dS[0][c] = fmaf(ww.x, dS[0][c], rr.x * oo[c]);
          dS[1][c] = fmaf(ww.y, dS[1][c], rr.y * oo[c]);
        }
        store_cols<C, LR>(wpx + (tt * RB / 2 + rp) * HDP, g, dvp);
        vals[tt] = dk0;
        vals[kTC + tt] = dk1;
        vals[2 * kTC + tt] = dw0;
        vals[3 * kTC + tt] = dw1;
      }
    }
    reduce_steps<LR, 4 * kTC>(vals, g);
    // lane g holds in vals[q] the sum of value q W + g % W (W = min(LR,
    // 32)): step % 8, row pair % 16 / 8, dk (< 16) or dw
    {
      constexpr int W = LR < 4 * kTC ? LR : 4 * kTC;
#pragma unroll
      for (int q2 = 0; q2 < 4 * kTC / W; ++q2) {
        const int xx = q2 * W + g % W;
        if (g < W)
          redx[((xx % kTC) * RB + 2 * rp + (xx / kTC) % 2) * 3 + 1 +
               xx / (2 * kTC)] = vals[q2];
      }
    }
    // dout . v and the CTA rows' sum of r u k of step `warp`, over a warp
    for (int tt = tid / 32; tt < nt; tt += NT / 32) {
      float a = 0.f, s2 = 0.f;
      for (int j = lane; j < HDP; j += 32)
        a = fmaf(os[tt * HDP + j], vs[tt * HDP + j], a);
      for (int rr2 = lane; rr2 < RB; rr2 += 32)
        s2 = fmaf(rs[tt * RB + rr2] * urow[rr2], ks[tt * RB + rr2], s2);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (lane == 0) dots[x * kTC + tt] = a, ruks[x * kTC + tt] = s2;
    }
  };
  // finish chunk ch (walked with stage sb into buffers x; the q-th walked):
  // dr, dk, dw, du's partials; its dv partial to the cluster
  auto finish = [&](int ch, int sb, int x, int q) {
    const int slot = q % kGroup;
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    const float* rs = sm + sb * STAGE;
    const float* ks = rs + kTC * RB;
    const float* os = ks + 2 * kTC * RB + kTC * HDP;
    // dr, dk, dw of (step, row); a thread's row is fixed
    for (int e = tid; e < nt * RB; e += NT) {
      const int tt = e / RB, ii = rb * RB + frow;
      if (ii < hd) {
        const float* xr = red + x * RED + e * 3;
        const float dot = dots[x * kTC + tt];
        const float rv = rs[tt * RB + frow], kv = ks[tt * RB + frow];
        const size_t o = dvbase + (size_t)(t0 + tt) * step + rb * RB + frow;
        dr[o] = fmaf(u_f * kv, dot, xr[0]);
        dk[o] = fmaf(u_f * rv, dot, xr[1]);
        dw[o] = xr[2];
        du_acc = fmaf(rv * kv, dot, du_acc);
      }
    }
    if (slot == 0 && pch >= 0) {  // the group before: every CTA's is in
      cluster_wait();
      cluster_pass();
    }
    // the CTA's dv partial of (step, column): its row pairs added in order
    // (two threads an output, half the pairs each), then dout_t[j] times
    // the CTA rows' sum of r u k
    float* cbp = cb + par * CB + slot * kTC * HDP;
    const float* wpx = wp + x * WP;
    for (int e = tid; e < 2 * kTC * (HDP / 4); e += NT) {
      const int o = e / 2, tt = o / (HDP / 4), j = (o % (HDP / 4)) * 4;
      const float* xw = wpx + (tt * RB / 2 + (e % 2) * (RB / 4)) * HDP + j;
      float4 a = *reinterpret_cast<const float4*>(xw);
#pragma unroll
      for (int rr2 = 1; rr2 < RB / 4; ++rr2) {
        const float4 y = *reinterpret_cast<const float4*>(xw + rr2 * HDP);
        a.x += y.x, a.y += y.y, a.z += y.z, a.w += y.w;
      }
      a.x += __shfl_xor_sync(0xffffffffu, a.x, 1);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, 1);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, 1);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, 1);
      if (e % 2 == 0 && tt < nt) {
        const float s2 = ruks[x * kTC + tt];
        const float4 od = *reinterpret_cast<const float4*>(os + tt * HDP + j);
        a.x = fmaf(od.x, s2, a.x), a.y = fmaf(od.y, s2, a.y);
        a.z = fmaf(od.z, s2, a.z), a.w = fmaf(od.w, s2, a.w);
        *reinterpret_cast<float4*>(cbp + tt * HDP + j) = a;
      }
    }
    if (slot == kGroup - 1 || ch == 0) {  // the group's partials are in
      cluster_arrive();
      pch = ch + slot, pn = slot + 1;
      par ^= 1;
    }
  };
  // iteration q walks chunk nck - 1 - q and finishes the one before it,
  // one barrier an iteration: a ring of three stages (the one walked, the one
  // finished, the next in flight), two of every other buffer
  stage(0, nck - 1);
  cp_async_commit();
  for (int q = 0; q <= nck; ++q) {
    const int ch = nck - 1 - q;
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed; chunk ch + 2 is finished
    if (ch > 0) stage((q + 1) % 3, ch - 1);
    cp_async_commit();
    if (q > 0) finish(ch + 1, (q - 1) % 3, (q - 1) & 1, q - 1);
    if (ch >= 0) {
      if (T - ch * kTC >= kTC)
        walk(Flag<true>{}, ch, q % 3, q & 1);
      else
        walk(Flag<false>{}, ch, q % 3, q & 1);
    }
  }
  cp_async_wait<0>();
  cluster_wait();
  cluster_pass();  // the last group
#pragma unroll
  for (int y = 0; y < 2; ++y)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = col<C, LR>(g, c);
      if (i + y < hd && j < hd) dstate[(bh * hd + i + y) * hd + j] = dS[y][c];
    }
  dus[tid] = du_acc;
  __syncthreads();
  if (tid < RB && rb * RB + tid < hd) {  // the row's threads, in order
    float a = dus[tid];
    for (int q2 = 1; q2 < min(NT, kTC * RB) / RB; ++q2)
      a += dus[tid + q2 * RB];
    dupart[bh * hd + rb * RB + tid] = a;
  }
  cluster.sync();  // no CTA leaves while a peer may read its partials
}

// du = the sum of the (b, h) partials over b, in a fixed order
__global__ void wkv_bwd_du(const float* __restrict__ dupart,
                           float* __restrict__ du, int B, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float a = dupart[q];
  for (int b = 1; b < B; ++b) a += dupart[(size_t)b * n + q];
  du[q] = a;
}

// f(Geo<C, LR, RB>{}) for head dim hd: 4 columns a lane, hd padded to 32
// (8 lanes a row pair, 32 rows a CTA), 64 (16, 32) or 128 (32, 16)
template <class F>
int by_head_dim(int hd, F f) {
  if (hd <= 32) return f(Geo<4, 8, 32>{});
  if (hd <= 64) return f(Geo<4, 16, 32>{});
  return f(Geo<4, 32, 16>{});
}

// the launch of a call: grid (ceil(hd / RB), H, B), a head's CTAs one
// cluster
template <class Gm>
cudaLaunchConfig_t config(int B, int H, int hd, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  const int nrb = (hd + Gm::kRB - 1) / Gm::kRB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nrb, H, B);
  cfg.blockDim = dim3(Gm::kThreads);
  cfg.dynamicSmemBytes = Gm::kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nrb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool takes(int B, int T, int H, int hd) {
  return hd >= 1 && hd <= 128 && T >= 1 && B >= 1 && H >= 1 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// The geometry of a call at head dim hd: geo[0] the rows a CTA, geo[1]
// its threads, geo[2] its dynamic shared memory in bytes, geo[3] the
// cluster (a head's CTAs). Returns cudaErrorInvalidValue for a head dim
// the kernel does not take.
extern "C" int wkv_bwd_geometry(int hd, int* geo) {
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  return by_head_dim(hd, [&](auto gm) {
    using Gm = decltype(gm);
    geo[0] = Gm::kRB;
    geo[1] = Gm::kThreads;
    geo[2] = Gm::kSmem;
    geo[3] = (hd + Gm::kRB - 1) / Gm::kRB;
    return 0;
  });
}

// The clusters of this call's shape the card can hold at once
// (cudaOccupancyMaxActiveClusters) to *n; returns the CUDA error.
extern "C" int wkv_bwd_max_clusters(int B, int T, int H, int hd, int* n) {
  if (!takes(B, T, H, hd)) return (int)cudaErrorInvalidValue;
  return by_head_dim(hd, [&](auto gm) {
    using Gm = decltype(gm);
    auto kern = wkv_bwd_kernel<Gm::kC, Gm::kLR, Gm::kRB>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config<Gm>(B, H, hd, nullptr, attr);
    return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
  });
}

// Writes the floats of the scratch a call at this shape needs to
// sizes[0]: the (b, h) du partials. Returns cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int wkv_bwd_scratch(int B, int T, int H, int hd,
                               long long* sizes) {
  if (!takes(B, T, H, hd)) return (int)cudaErrorInvalidValue;
  sizes[0] = (long long)B * H * hd;
  return 0;
}

// Launches the kernel, then the fixed-order sum of du, on `stream`, and
// returns the first launch error (0 = both queued). ck holds the
// checkpoints wkv.cu's training forward wrote for these inputs (null when
// T <= 8); dupart is scratch of the size wkv_bwd_scratch gives; vec is 1
// when hd % 4 == 0 and every row of r, k, v, w, dout and ck starts
// 16-byte aligned (16-byte staging), else 0.
extern "C" int wkv_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* state,
                       const float* ck, const float* dout,
                       const float* dstate_out, float* dr, float* dk,
                       float* dv, float* dw, float* du, float* dstate,
                       float* dupart, int B, int T, int H, int hd, int vec,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(B, T, H, hd) || (T > kTC && !ck) || (vec && hd % 4))
    return (int)cudaErrorInvalidValue;
  const int err = by_head_dim(hd, [&](auto gm) {
    using Gm = decltype(gm);
    auto kern = wkv_bwd_kernel<Gm::kC, Gm::kLR, Gm::kRB>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config<Gm>(B, H, hd, st, attr);
    return (int)cudaLaunchKernelEx(&cfg, kern, r, k, v, w, u, state, ck,
                                   dout, dstate_out, dr, dk, dv, dw, dstate,
                                   dupart, T, H, hd, vec);
  });
  if (err != cudaSuccess) return err;
  const int n = H * hd;
  wkv_bwd_du<<<(n + 255) / 256, 256, 0, st>>>(dupart, du, B, n);
  return (int)cudaGetLastError();
}
