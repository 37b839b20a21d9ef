// Mamba selective scan for Hopper (sm_90a), any T >= 1, any d_inner,
// state size N <= 64.
//
// Replaces the TPU kernel `_ssm_kernel`
// (src/repro/kernels/ssm_scan/kernel.py:36, pallas_call at :81) and
// computes the same function. Per batch row b and channel d, with the
// N-entry diagonal state h carried over time:
//     h[n] <- exp(dt_t[d] * A[d][n]) * h[n] + dt_t[d] * u_t[d] * B_t[n]
//     y_t[d] = sum_n C_t[n] * h[n] + D[d] * u_t[d]
// Everything is f32; the exponential is expf (not __expf), so the
// result holds an f32 tolerance against the plain version. Layouts (all
// contiguous): u, dt, y (B, T, di); Bm, Cm (B, T, N); A (di, N); D (di,);
// state, state_out (B, di, N). state_out may alias state: each lane
// reads its own state entries before it writes them.
//
// Bound on an H100 SXM. At the serving decode shape (hymba-1.5b: B 8,
// T 1, di 3200, N 16) bytes: the state in and out is 2 * 8 * 3200 * 16 *
// 4 = 3.3 MB against 0.3 MB of u, dt, y (0.0011 ms). A prefill (B 1,
// T 300) moves 12 MB (0.0036 ms) and does ~110 Mflop, but each state
// entry is a chain of T dependent steps, and with a few warps per SM
// what a step costs is its latency, not the card's throughput.
//
// Design. The TPU kernel holds a (bd, N) state tile in VMEM, lanes over
// both axes, and walks time blocks on an "arbitrary" grid axis. Here the
// same tile is laid over lanes: a channel gets L lanes and lane g holds
// the two consecutive entries n = 2g, 2g + 1 (L the next power of two
// >= N / 2, at most 32; N = 1 takes one lane and one entry), their h and
// A[d][n] in registers. Hymba's N 16 then runs B * di * 8 threads
// (25,600 at B 1, ~6 warps per SM, where one thread per channel gave
// 3,200, one warp per SM), and the state, A and state_out accesses are
// coalesced along (d, n). A CTA is 128 threads (64 at L = 1), CH =
// threads / L consecutive channels of one batch row; grid (ceil(di /
// CH), B), the ragged channel tail masked.
// - The recurrence chain is one FMA per step, h = fma(exp(dt A), h,
//   dt u B): the exponential and the input term do not depend on h, so
//   consecutive steps overlap.
// - y_t[d] = sum_n C_t[n] h[n] is reduced off that chain and out of
//   shared memory: a lane keeps its partials of a chunk's TC steps in
//   registers (lane 0's with D u), and one transpose-reduce over the
//   channel's lanes (L - 1 shuffles for TC = L steps) leaves each lane
//   with the channel's y of TC / L steps, which it stores.
// - B_t / C_t (N values, shared by every channel of the row) and u_t /
//   dt_t (CH values) of TC steps are staged in shared memory by 4-byte
//   `cp.async` (any N, any alignment): above T 16 into a ring of two
//   32-step chunks, one scanned while the next is in flight, one barrier
//   a chunk guarding the ring; at T <= 16 into one 16-step chunk, the
//   whole scan. u and dt are
//   stored channel-major, so one 16-byte read gives a lane four steps; a
//   lane reads its two B and two C entries in one 8-byte read each.
//   Steps past T up to a multiple of four are staged as zeros (dt = u =
//   0 leaves h as it is) and their y is not written.
// - Why two entries a lane, y from registers and 32-step chunks: the
//   first design, one lane per entry with a shuffle reduction in every
//   step, read 0.0508 ms at B 1, T 300 on an H100 SXM (this kernel:
//   0.0285). In scratch variants one lane per entry cost more in
//   threads and shuffles than it gained at hymba's di 3200 (at di 800
//   it read faster), and a shared-memory pass for y took as long at a
//   quarter of the channels: the chain of chunks, each with its
//   barriers and pass, bounded it, not the card.
// - No split of T into chunks scanned in parallel (the two-pass chunked
//   scan): at the served shapes B * di * N / 2 threads already fill the
//   card, and a 300-step chain at one FMA per step is ~1,200 cycles.
// - Training: the checkpoint instantiation (CK, ops.SelectiveScan's
//   forward) also writes the state every 8 steps for ssm_scan_bwd.cu,
//   which walks back from them: 52 MB a layer at hymba-1.5b's train shape
//   (B 2, T 1024), kept from a layer's forward (under remat its
//   recompute) to its backward; 0.1522 ms there against the serving
//   call's 0.1389 (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W). The
//   serving instantiation is unchanged.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::reduce_steps;

constexpr int kCk = 8;  // steps between the training forward's checkpoints

// L lanes a channel, E entries a lane, TC time steps a staged chunk
// (16 at T <= 16, else 32: a chunk costs a barrier and a reduction, a
// longer one more registers and idle steps at decode). The 16-step
// instantiation runs one chunk, so it reserves one stage.
template <int L, int E, int TC>
struct Geo {
  static constexpr int kThreads = L == 1 ? 64 : 128;
  static constexpr int kCh = kThreads / L;      // channels per CTA
  static constexpr int kW = L < TC ? L : TC;    // lanes a step's y lands on
  static constexpr int kRS = TC + 4;            // a channel's u / dt row
  static constexpr int kStages = TC == 16 ? 1 : 2;  // chunks in the ring
  // chunks staged before the loop
  static constexpr int kAhead = kStages > 1 ? kStages - 1 : 1;
  static constexpr int kStage = 2 * TC * L * E + 2 * kCh * kRS;  // floats
  // dynamic shared memory: at most 38,912 bytes, under the default 48 KB
  static constexpr int kSmem = 4 * kStages * kStage;
};

// E consecutive floats of shared memory (8-byte aligned when E is 2).
template <int E>
__device__ __forceinline__ void load_e(const float* p, float (&v)[E]) {
  if constexpr (E == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// CK: the training forward, which also writes the state after every
// kCk-th step short of the last, h_{8 c} for c = 1 .. ceil(T / 8) - 1, to
// ck (B, ceil(T / 8) - 1, di, N) for ssm_scan_bwd.cu; the serving forward
// (CK false) writes nothing more.
template <int L, int E, int TC, bool CK>
__global__ void __launch_bounds__(Geo<L, E, TC>::kThreads)
    ssm_kernel(const float* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, const float* __restrict__ D,
               const float* state, float* __restrict__ y, float* state_out,
               float* __restrict__ ck, int T, int di, int N) {
  using Gm = Geo<L, E, TC>;
  constexpr int NT = Gm::kThreads, CH = Gm::kCh, W = Gm::kW;
  constexpr int kTC = TC, kRS = Gm::kRS, kStages = Gm::kStages;
  constexpr int kAhead = Gm::kAhead;
  constexpr int NP = L * E;          // padded state row
  constexpr int STAGE = Gm::kStage;  // floats per stage
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / L;  // channel in the CTA
  const int g = threadIdx.x % L;  // lane in the channel's group
  const int d = d0 + c;
  const bool on = d < di;

  float h[E], a[E];
  const size_t s_off = ((size_t)b * di + d) * N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int n = g * E + e;
    const bool live = on && n < N;
    h[e] = live ? state[s_off + n] : 0.f;
    a[e] = live ? A[(size_t)d * N + n] : 0.f;
  }
  const float dd = on && g == 0 ? D[d] : 0.f;  // lane 0 carries D u

  // copy steps [t0, t0 + nt) of B, C (entries past N zero) and of u, dt
  // (channels past di zero) into stage `buf`, zeros up to a multiple of
  // four steps
  auto stage = [&](int buf, int t0, int nt) {
    float* bs = sm + buf * STAGE;
    float* cs = bs + kTC * NP;
    float* us = cs + kTC * NP;
    float* ds = us + CH * kRS;
    const int nt4 = (nt + 3) & ~3;
    for (int e = threadIdx.x; e < nt4 * NP; e += NT) {
      const int tt = e / NP;
      const int n = e - tt * NP;
      const bool ok = tt < nt && n < N;
      const size_t off = ok ? ((size_t)b * T + t0 + tt) * N + n : 0;
      cp_async4(bs + e, Bm + off, ok);
      cp_async4(cs + e, Cm + off, ok);
    }
    for (int e = threadIdx.x; e < nt4 * CH; e += NT) {
      const int tt = e / CH;
      const int cc = e - tt * CH;
      const bool ok = tt < nt && d0 + cc < di;
      const size_t off = ok ? ((size_t)b * T + t0 + tt) * di + d0 + cc : 0;
      cp_async4(us + cc * kRS + tt, u + off, ok);
      cp_async4(ds + cc * kRS + tt, dt + off, ok);
    }
  };

#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k * kTC < T) stage(k, k * kTC, min(kTC, T - k * kTC));
    cp_async_commit();
  }
  for (int t0 = 0, buf = 0; t0 < T; t0 += kTC, buf = (buf + 1) % kStages) {
    const int nt = min(kTC, T - t0);
    cp_async_wait<kAhead - 1>();  // this chunk has landed
    __syncthreads();  // for every thread; the last stage is consumed
    if constexpr (kStages > 1) {
      const int tn = t0 + (kStages - 1) * kTC;
      if (tn < T)
        stage((buf + kStages - 1) % kStages, tn, min(kTC, T - tn));
      cp_async_commit();
    }
    const float* bs = sm + buf * STAGE;
    const float* cs = bs + kTC * NP;
    const float* us = cs + kTC * NP;
    const float* ds = us + CH * kRS;
    float v[kTC];  // this lane's part of y for each step of the chunk
#pragma unroll
    for (int tt = 0; tt < kTC; tt += 4) {
      if (tt >= nt) {  // past the chunk: nothing to add
#pragma unroll
        for (int j = 0; j < 4; ++j) v[tt + j] = 0.f;
        continue;
      }
      const float4 u4 = *reinterpret_cast<const float4*>(us + c * kRS + tt);
      const float4 d4 = *reinterpret_cast<const float4*>(ds + c * kRS + tt);
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float bv[E], cv[E];
        load_e<E>(bs + (tt + j) * NP + g * E, bv);
        load_e<E>(cs + (tt + j) * NP + g * E, cv);
        const float du = dv[j] * uv[j];
        float acc = dd * uv[j];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dA = expf(dv[j] * a[e]);
          h[e] = fmaf(dA, h[e], du * bv[e]);
          acc = fmaf(cv[e], h[e], acc);
        }
        v[tt + j] = acc;
      }
      if constexpr (CK) {
        const int tc = t0 + tt + 4;  // steps done
        if ((tt + 4) % kCk == 0 && tc < T && on) {
          float* dst = ck + (((size_t)b * ((T - 1) / kCk) + tc / kCk - 1) *
                                 di + d) * N;
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (g * E + e < N) dst[g * E + e] = h[e];
        }
      }
    }
    reduce_steps<L, TC>(v, g);
#pragma unroll
    for (int j = 0; j < kTC / W; ++j) {
      const int tt = j * W + g % W;
      if (on && g < W && tt < nt)
        y[((size_t)b * T + t0 + tt) * di + d] = v[j];
    }
  }
  cp_async_wait<0>();
  if (!on) return;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int n = g * E + e;
    if (n < N) state_out[s_off + n] = h[e];
  }
}

template <int L, int E, int TC, bool CK>
cudaError_t launch_tc(const float* u, const float* dt, const float* Bm,
                      const float* Cm, const float* A, const float* D,
                      const float* state, float* y, float* state_out,
                      float* ck, int B, int T, int di, int N,
                      cudaStream_t stream) {
  using Gm = Geo<L, E, TC>;
  const dim3 grid((di + Gm::kCh - 1) / Gm::kCh, B);
  ssm_kernel<L, E, TC, CK><<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      u, dt, Bm, Cm, A, D, state, y, state_out, ck, T, di, N);
  return cudaGetLastError();
}

template <int L, int E>
cudaError_t launch(const float* u, const float* dt, const float* Bm,
                   const float* Cm, const float* A, const float* D,
                   const float* state, float* y, float* state_out, float* ck,
                   int B, int T, int di, int N, cudaStream_t stream) {
  if (T <= 16)  // one chunk: the one-stage instantiation (T <= kCk writes
               // no checkpoint: the serving one serves both callers)
    return ck && T > kCk
               ? launch_tc<L, E, 16, true>(u, dt, Bm, Cm, A, D, state, y,
                                           state_out, ck, B, T, di, N, stream)
               : launch_tc<L, E, 16, false>(u, dt, Bm, Cm, A, D, state, y,
                                            state_out, ck, B, T, di, N,
                                            stream);
  return ck ? launch_tc<L, E, 32, true>(u, dt, Bm, Cm, A, D, state, y,
                                        state_out, ck, B, T, di, N, stream)
            : launch_tc<L, E, 32, false>(u, dt, Bm, Cm, A, D, state, y,
                                         state_out, ck, B, T, di, N, stream);
}

}  // namespace

// The checkpoints the training forward writes for T steps: the state
// after every kCk-th step short of the last (ssm_scan_bwd.cu walks back
// over the same kCk-step chunks).
extern "C" int ssm_scan_checkpoints(int T) {
  return T < 1 ? 0 : (T - 1) / kCk;
}

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// ck is null (serving) or (B, ssm_scan_checkpoints(T), di, N) floats
// (training).
extern "C" int ssm_scan(const float* u, const float* dt, const float* Bm,
                        const float* Cm, const float* A, const float* D,
                        const float* state, float* y, float* state_out,
                        float* ck, int B, int T, int di, int N,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 64 || di < 1 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
#define SSM_LAUNCH(L_, E_) \
  launch<L_, E_>(u, dt, Bm, Cm, A, D, state, y, state_out, ck, B, T, di, N, \
                 st)
  cudaError_t err;
  if (N == 1)
    err = SSM_LAUNCH(1, 1);
  else if (N == 2)
    err = SSM_LAUNCH(1, 2);
  else if (N <= 4)
    err = SSM_LAUNCH(2, 2);
  else if (N <= 8)
    err = SSM_LAUNCH(4, 2);
  else if (N <= 16)
    err = SSM_LAUNCH(8, 2);
  else if (N <= 32)
    err = SSM_LAUNCH(16, 2);
  else
    err = SSM_LAUNCH(32, 2);
#undef SSM_LAUNCH
  return (int)err;
}
