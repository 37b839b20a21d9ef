// RWKV-6 WKV recurrence for Hopper (sm_90a), any T >= 1, head dim <= 128.
//
// Replaces the TPU kernel `_wkv_kernel`
// (src/repro/kernels/rwkv_scan/kernel.py:29, pallas_call at :69) and
// computes the same function. Per batch row b and head h, with the
// (hd x hd) state S carried over time:
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Everything is f32 (no TF32). Layouts (all contiguous): r, k, v, w, out
// (B, T, H, hd); u (H, hd); state, state_out (B, H, hd, hd), S[i][j] at
// [b, h, i, j]. state_out may alias state: each CTA reads its own slice
// of columns into shared memory before it writes any of it.
//
// Bound on an H100 SXM. At the serving decode shape (rwkv6-1.6b: B 8,
// T 1, H 32, hd 64) bytes: the state in and out is 2 * 8 * 32 * 64 * 64
// * 4 = 8.4 MB against 0.3 MB of r, k, v, w, out (0.0026 ms). A prefill
// (B 1, T 300) moves 13.3 MB (0.0040 ms) and does 7 flops per state
// entry and step, 275 Mflop at 67 TFLOP/s (0.0041 ms): the two bounds
// are about equal.
//
// Design. The TPU kernel keeps a head's state in VMEM and walks time
// blocks on an "arbitrary" grid axis. Column j of S depends on v_t[j]
// and on the head's r, k, w, never on another column, so here a pair of
// columns is what a channel is in ssm_scan.cu: L lanes hold it, lane g
// the 4 consecutive rows i = 4g .. 4g + 3 of both columns, 8 entries
// (L = hd / 4 with the head dim padded to 32, 64 or 128; rows and
// columns past hd hold zeros and stay zero). A CTA of 128 threads
// covers 256 / L consecutive columns of one (b, h); grid
// (ceil(hd * L / 256), H, B). What this does about the first design's
// limits (one CTA of hd threads per (b, h), thread j walking all hd rows
// of column j through four shared-memory broadcasts a row):
// - Threads: at B 1, H 32, hd 64 the grid is 128 CTAs of 4 warps, one
//   a SM (was 32 CTAs of 2 warps on 132 SMs).
// - The chain: a state entry's only loop-carried dependence is one FMA
//   a step, S = fma(w, S, k v); k v does not depend on S, and out's
//   partial reads S but feeds nothing back, so the steps of the unrolled
//   chunk overlap. A lane reads its rows' r, k, w as one 16-byte shared
//   load each and its columns' v as one 8-byte load, and uses them for
//   both columns: 4 shared loads a step for 8 entries (scratch variants
//   with one column a lane, 4 entries for the same loads, and with two
//   rows a lane, twice the warps, both read slower at T 300).
// - out off the recurrence: a lane keeps its partials of out for both
//   columns and each step of a TC-step chunk in registers; one
//   transpose-reduce over the pair's L lanes a chunk
//   (hopper::reduce_steps) leaves each lane with out of 2 TC / L (column,
//   step)s, which it stores. There is no reduction per step.
// - Staging: the rows r, k, w (hd floats each) and the CTA's columns of
//   v of TC steps are copied by `cp.async`, 16 bytes at a time where
//   every row starts 16-byte aligned and hd % 4 == 0 (`vec`), else 4
//   bytes. At T 1 into one one-step stage; above into a ring of two
//   16-step chunks, one scanned while the next is in flight, one barrier
//   a chunk (in a scratch variant 32-step chunks read a little faster at
//   T 300 and slower at short T and at hd 128). Steps past T are neither
//   staged nor scanned (a zero step would wipe the state: w = 0). r, k
//   and w are read by each of a head's ceil(hd * L / 256) CTAs: a few
//   times their bytes, from L2.
// - The state: a CTA's (hd x 256 / L) slice, 1,024 floats, is read row
//   by row (two 16-byte loads a thread at `vec`, both in flight at
//   once, coalesced along j) into shared memory laid out column-major,
//   so a lane takes its four rows of a column as one 16-byte load, and
//   is written back the same way at the end. At the decode shape that is
//   1,024 CTAs of 4 KB in and 4 KB out, all resident at once, with 56
//   registers a thread.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W; CUDA events,
// L2 flushed): B 1, T 300 0.0257 ms (first design 0.1960); B 8, T 1
// 0.0098 ms (0.0105); B 2, T 64 0.0131 ms. Left on the table: at decode
// every CTA loads in one phase and stores in the next, so reads and
// writes do not overlap (5.2 us of device time a launch in the rwkv6
// serve's profile against the 2.6 us bound); at T 300 one warp per
// scheduler leaves the chain's latencies exposed (6.3x the bound). The
// chunked tensor-core form of the reference's note needs TF32 / bf16
// operands and divides by cumulative decays, which underflow: not used.
// Training: the checkpoint instantiation (CK, ops.WKV's forward) also
// writes the state every 8 steps, transposed, for wkv_bwd.cu, which walks
// back from them: 133 MB a layer at rwkv6-1.6b's train shape (B 2, T
// 1024), kept from a layer's forward (under remat its recompute) to its
// backward; 0.1234 ms there against the serving call's 0.1037
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W). The serving
// instantiation is unchanged.
#include <cuda_runtime.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::reduce_steps;

constexpr int kThreads = 128;
constexpr int kE = 4;       // rows of a column a lane holds
constexpr int kC = 2;       // columns a lane holds
constexpr int kChunk = 16;  // time steps a staged chunk above T 1
constexpr int kCk = 8;      // steps between the training forward's checkpoints

// L lanes a column pair, TC time steps a staged chunk: 1 at T 1 (one
// stage, the whole scan), else kChunk (a ring of two stages).
template <int L, int TC>
struct Geo {
  static constexpr int kHdp = L * kE;                // padded head dim
  static constexpr int kCh = kC * kThreads / L;      // columns per CTA
  static constexpr int kK = kC * TC;                 // partials a lane
  static constexpr int kW = L < kK ? L : kK;         // lanes out lands on
  static constexpr int kStages = TC == 1 ? 1 : 2;
  static constexpr int kStage = 3 * TC * kHdp + TC * kCh;  // floats
  static constexpr int kSs = kHdp + 4;  // a column of the staged state
  // the state slice is kHdp x kCh = 1,024 floats whatever L is: each
  // thread moves kSlice / 4 16-byte pieces (vec) or kSlice floats of it
  static constexpr int kSlice = kHdp * kCh / kThreads;
  // dynamic shared memory: r, k, w, v stages, then the state slice
  static constexpr int kSmem = 4 * (kStages * kStage + kCh * kSs);
};

// CK: the training forward, which also writes the state after every 8th
// step short of the last, S_{8 c} for c = 1 .. ceil(T / 8) - 1, to ck (B,
// H, ceil(T / 8) - 1, hd, hd) for wkv_bwd.cu, transposed (S[i][j] at [...,
// j, i]): a lane's 4 rows of a column are one 16-byte store, and a
// half-warp writes a column's 256 bytes at hd 64. The serving forward (CK
// false) writes nothing more.
template <int L, int TC, bool CK>
__global__ void __launch_bounds__(kThreads, TC == 1 ? 8 : 1)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* state,
               float* __restrict__ out, float* state_out,
               float* __restrict__ ck, int T, int H, int hd, int vec) {
  using Gm = Geo<L, TC>;
  constexpr int HDP = Gm::kHdp, CH = Gm::kCh, W = Gm::kW, SS = Gm::kSs;
  constexpr int kTC = TC, kK = Gm::kK, kStages = Gm::kStages;
  constexpr int STAGE = Gm::kStage;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* ss = sm + kStages * STAGE;  // state slice, ss[cc * SS + i]

  const int j0 = blockIdx.x * CH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = kC * (threadIdx.x / L);  // first of the lane's columns
  const int g = threadIdx.x % L;         // lane in the pair's group
  const size_t bh = (size_t)b * H + h;

  // copy steps [t0, t0 + nt) of the rows r, k, w (entries past hd zero)
  // and of the CTA's columns of v (columns past hd zero) into `buf`
  auto stage = [&](int buf, int t0, int nt) {
    float* rs = sm + buf * STAGE;
    float* ks = rs + kTC * HDP;
    float* ws = ks + kTC * HDP;
    float* vs = ws + kTC * HDP;
    if (vec) {
      constexpr int Q = HDP / 4, QV = CH / 4;  // 16-byte pieces of a row
      for (int e = threadIdx.x; e < nt * Q; e += kThreads) {
        const int tt = e / Q, i = (e - tt * Q) * 4;
        const bool ok = i < hd;
        const size_t off = ok ? ((b * (size_t)T + t0 + tt) * H + h) * hd + i
                              : 0;
        cp_async16(rs + tt * HDP + i, r + off, ok);
        cp_async16(ks + tt * HDP + i, k + off, ok);
        cp_async16(ws + tt * HDP + i, w + off, ok);
      }
      for (int e = threadIdx.x; e < nt * QV; e += kThreads) {
        const int tt = e / QV, cc = (e - tt * QV) * 4;
        const bool ok = j0 + cc < hd;
        const size_t off =
            ok ? ((b * (size_t)T + t0 + tt) * H + h) * hd + j0 + cc : 0;
        cp_async16(vs + tt * CH + cc, v + off, ok);
      }
    } else {
      for (int e = threadIdx.x; e < nt * HDP; e += kThreads) {
        const int tt = e / HDP, i = e - tt * HDP;
        const bool ok = i < hd;
        const size_t off = ok ? ((b * (size_t)T + t0 + tt) * H + h) * hd + i
                              : 0;
        cp_async4(rs + tt * HDP + i, r + off, ok);
        cp_async4(ks + tt * HDP + i, k + off, ok);
        cp_async4(ws + tt * HDP + i, w + off, ok);
      }
      for (int e = threadIdx.x; e < nt * CH; e += kThreads) {
        const int tt = e / CH, cc = e - tt * CH;
        const bool ok = j0 + cc < hd;
        const size_t off =
            ok ? ((b * (size_t)T + t0 + tt) * H + h) * hd + j0 + cc : 0;
        cp_async4(vs + tt * CH + cc, v + off, ok);
      }
    }
  };

  stage(0, 0, min(kTC, T));  // the first chunk; T >= 1
  cp_async_commit();

  // the CTA's state slice: rows i < hd of columns j0 .. j0 + CH - 1,
  // read along j, stored column-major (entries past hd zero); every load
  // is issued before the first store waits for one
  const float* s_in = state + bh * hd * hd;
  if (vec) {
    constexpr int QV = CH / 4, N = Gm::kSlice / 4;
    float4 x[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / QV, cc = (e - i * QV) * 4;
      x[n] = i < hd && j0 + cc < hd
                 ? *reinterpret_cast<const float4*>(s_in + (size_t)i * hd +
                                                    j0 + cc)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / QV, cc = (e - i * QV) * 4;
      ss[cc * SS + i] = x[n].x;
      ss[(cc + 1) * SS + i] = x[n].y;
      ss[(cc + 2) * SS + i] = x[n].z;
      ss[(cc + 3) * SS + i] = x[n].w;
    }
  } else {
    constexpr int N = Gm::kSlice;
    float x[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / CH, cc = e - i * CH;
      x[n] = i < hd && j0 + cc < hd ? s_in[(size_t)i * hd + j0 + cc] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * kThreads;
      ss[(e % CH) * SS + e / CH] = x[n];
    }
  }
  float uu[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e)
    uu[e] = g * kE + e < hd ? u[(size_t)h * hd + g * kE + e] : 0.f;
  __syncthreads();
  float S[kC][kE];  // S[x][e]: row g * kE + e of column j0 + c + x
#pragma unroll
  for (int x = 0; x < kC; ++x) {
    const float4 q =
        *reinterpret_cast<const float4*>(ss + (c + x) * SS + g * kE);
    S[x][0] = q.x, S[x][1] = q.y, S[x][2] = q.z, S[x][3] = q.w;
  }

  for (int t0 = 0, buf = 0; t0 < T; t0 += kTC, buf = (buf + 1) % kStages) {
    const int nt = min(kTC, T - t0);
    cp_async_wait<0>();  // this chunk has landed
    __syncthreads();  // for every thread; the last stage is consumed
    if constexpr (kStages > 1) {
      const int tn = t0 + (kStages - 1) * kTC;
      if (tn < T) stage((buf + kStages - 1) % kStages, tn, min(kTC, T - tn));
      cp_async_commit();
    }
    const float* rs = sm + buf * STAGE;
    const float* ks = rs + kTC * HDP;
    const float* ws = ks + kTC * HDP;
    const float* vs = ws + kTC * HDP;
    // this lane's part of out_t[j0 + c + x] for each step tt, at
    // part[x * kTC + tt]
    float part[kK];
    // one step: the lane's rows' share of out, then their recurrence
    auto step = [&](int tt) {
      const float4 r4 = *reinterpret_cast<const float4*>(rs + tt * HDP +
                                                         g * kE);
      const float4 k4 = *reinterpret_cast<const float4*>(ks + tt * HDP +
                                                         g * kE);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + tt * HDP +
                                                         g * kE);
      const float2 v2 = *reinterpret_cast<const float2*>(vs + tt * CH + c);
      const float rr[kE] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kE] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[kE] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[kC] = {v2.x, v2.y};
#pragma unroll
      for (int x = 0; x < kC; ++x) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float kv = kk[e] * vv[x];
          acc = fmaf(rr[e], fmaf(uu[e], kv, S[x][e]), acc);
          S[x][e] = fmaf(ww[e], S[x][e], kv);
        }
        part[x * kTC + tt] = acc;
      }
    };
    // CK: S after step t0 + tt, tt + 1 a multiple of kCk, short of the
    // last step: a backward chunk's start, column by column (S^T)
    auto save = [&](int tt) {
      const int tc = t0 + tt + 1;
      if (tc >= T) return;
      float* dst = ck + (bh * ((T - 1) / kCk) + tc / kCk - 1) * hd * hd +
                   g * kE;
#pragma unroll
      for (int x = 0; x < kC; ++x) {
        const int j = j0 + c + x;
        if (j >= hd) continue;
        if (vec) {  // hd % 4 == 0: the lane's 4 rows, 16-byte aligned
          if (g * kE < hd)
            *reinterpret_cast<float4*>(dst + (size_t)j * hd) =
                make_float4(S[x][0], S[x][1], S[x][2], S[x][3]);
        } else {
#pragma unroll
          for (int e = 0; e < kE; ++e)
            if (g * kE + e < hd) dst[(size_t)j * hd + e] = S[x][e];
        }
      }
    };
    if (nt == kTC) {
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) {
        step(tt);
        if constexpr (CK)
          if (tt % kCk == kCk - 1) save(tt);
      }
    } else {  // the last chunk: steps past T are neither staged nor run
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) {
        if (tt < nt) {
          step(tt);
          if constexpr (CK)
            if (tt % kCk == kCk - 1) save(tt);
        } else {
#pragma unroll
          for (int x = 0; x < kC; ++x) part[x * kTC + tt] = 0.f;
        }
      }
    }
    reduce_steps<L, kK>(part, g);
#pragma unroll
    for (int q = 0; q < kK / W; ++q) {
      const int s = q * W + g % W, x = s / kTC, tt = s % kTC;
      const int j = j0 + c + x;
      if (j < hd && g < W && tt < nt)
        out[((b * (size_t)T + t0 + tt) * H + h) * hd + j] = part[q];
    }
  }
  cp_async_wait<0>();

  // the final state through the same column-major slice; each thread
  // rewrites only the entries it read, so no barrier is needed before
#pragma unroll
  for (int x = 0; x < kC; ++x)
    *reinterpret_cast<float4*>(ss + (c + x) * SS + g * kE) =
        make_float4(S[x][0], S[x][1], S[x][2], S[x][3]);
  __syncthreads();
  float* s_out = state_out + bh * hd * hd;
  if (vec) {
    constexpr int QV = CH / 4;
#pragma unroll
    for (int n = 0; n < Gm::kSlice / 4; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / QV, cc = (e - i * QV) * 4;
      if (i < hd && j0 + cc < hd)
        *reinterpret_cast<float4*>(s_out + (size_t)i * hd + j0 + cc) =
            make_float4(ss[cc * SS + i], ss[(cc + 1) * SS + i],
                        ss[(cc + 2) * SS + i], ss[(cc + 3) * SS + i]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < Gm::kSlice; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / CH, cc = e - i * CH;
      if (i < hd && j0 + cc < hd)
        s_out[(size_t)i * hd + j0 + cc] = ss[cc * SS + i];
    }
  }
}

template <int L, int TC, bool CK>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state,
                   float* out, float* state_out, float* ck, int B, int T,
                   int H, int hd, int vec, cudaStream_t stream) {
  using Gm = Geo<L, TC>;
  if (Gm::kSmem > 48 * 1024) {  // above the default: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<L, TC, CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Gm::kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((hd + Gm::kCh - 1) / Gm::kCh, H, B);
  wkv_kernel<L, TC, CK><<<grid, kThreads, Gm::kSmem, stream>>>(
      r, k, v, w, u, state, out, state_out, ck, T, H, hd, vec);
  return cudaGetLastError();
}

}  // namespace

// The checkpoints the training forward writes for T steps: the state
// after every 8th step short of the last (wkv_bwd.cu walks back over the
// same 8-step chunks).
extern "C" int wkv_scan_checkpoints(int T) {
  return T < 1 ? 0 : (T - 1) / kCk;
}

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// lanes (8, 16 or 32: the head dim padded to 4 * lanes >= hd) and chunk
// (1 at T 1, else 16) come from kernel.py::plan; vec is 1 when hd % 4 ==
// 0 and every tensor starts 16-byte aligned. ck is null (serving) or
// (B, H, wkv_scan_checkpoints(T), hd, hd) floats (training), each state
// transposed.
extern "C" int wkv_scan(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* state,
                        float* out, float* state_out, float* ck, int B,
                        int T, int H, int hd, int lanes, int chunk, int vec,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > kE * lanes || T < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535 || chunk != (T == 1 ? 1 : kChunk) || (vec && hd % 4 != 0))
    return (int)cudaErrorInvalidValue;
#define WKV_LAUNCH(L_, TC_, CK_)                                         \
  launch<L_, TC_, CK_>(r, k, v, w, u, state, out, state_out, ck, B, T, H, \
                       hd, vec, st)
  // T 1 writes no checkpoint: one instantiation serves both callers (so
  // does T <= 8, where ck is null)
#define WKV_LANES(L_)                                 \
  (T == 1 ? WKV_LAUNCH(L_, 1, false)                  \
   : ck   ? WKV_LAUNCH(L_, kChunk, true)              \
          : WKV_LAUNCH(L_, kChunk, false))
  cudaError_t err;
  if (lanes == 8)
    err = WKV_LANES(8);
  else if (lanes == 16)
    err = WKV_LANES(16);
  else if (lanes == 32)
    err = WKV_LANES(32);
  else
    err = cudaErrorInvalidValue;
#undef WKV_LANES
#undef WKV_LAUNCH
  return (int)err;
}
