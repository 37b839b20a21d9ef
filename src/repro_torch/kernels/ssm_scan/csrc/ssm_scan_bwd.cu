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
// state, dstate_out, dstate (B, di, N).
//
// Bound on an H100 SXM at the train shape (hymba-1.5b: B 2, T 1024, di
// 3200, N 16): bytes. u, dt and dy read and du and ddt written are 131
// MB (0.039 ms); B, C and their gradients, the state and A add little;
// the operations, 23 an entry and step with the forward once (this
// kernel's second forward pass not counted), are 2.4 GFLOP (0.036 ms at
// 67 TFLOP/s).
//
// Design.
// - Where h_{t-1} comes from. exp(dt A) underflows to exactly 0 at
//   hymba's A in [-16, -1], so the kernel runs the forward again first
//   and keeps the state at the start of every 16-step chunk in a scratch
//   (`ck`). Going back, a chunk starts from its checkpoint (loaded during
//   the chunk before), runs its steps forward into shared memory, then
//   walks them backward. Serving's forward is untouched.
// - Lanes as in the forward: a channel's N entries over L lanes, two a
//   lane (L the next power of two >= N / 2, at most 32), a CTA of 128
//   threads (64 at L = 1) over CH = threads / L channels of one batch
//   row; grid (ceil(di / CH), B), the ragged tail staged as zeros.
// - The sums. du and ddt sum over a channel's lanes, dB and dC over
//   d_inner (3,200 channels at hymba, 200 CTAs). A step's du and ddt
//   lane partials go to shared memory; its dB and dC partials are first
//   added over the warp's channels by a butterfly of shuffles, so shared
//   memory holds one a warp. After a chunk the CTA adds a channel's
//   lanes, and a step's warps, in a fixed order. du and ddt are then
//   written; dB and dC are the CTA's partials, written to a scratch and
//   added over the CTAs by a second launch in a fixed order, which also
//   adds dA's and dD's per-batch-row partials over b. No atomics: two
//   calls give the same bits.
// - Staging as in ssm_scan.cu: B, C (N values) and u, dt, dy (the CTA's
//   channels, channel-major) of a 16-step chunk by 4-byte `cp.async`
//   into a ring of two, the next chunk (backward: the one before) in
//   flight while one is scanned. 52 KB of shared memory a CTA at N 16,
//   so an SM holds 4 and hymba's 400 CTAs (B 2) run in one wave: with
//   one dB / dC partial a channel (76 KB, 3 an SM) 4 CTAs ran in a second
//   wave, and the kernel took 0.7686 ms against 0.6086 ms now (two
//   chip_smoke.py runs on two machines; NVIDIA H100 80GB HBM3, 700.00 W).
// - A simple kernel first: the two passes over T are chains of one FMA
//   a step; the time is written down beside the bound (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kTC = 16;  // time steps a chunk

// L lanes a channel, E entries a lane
template <int L, int E>
struct Geo {
  static constexpr int kL = L, kE = E;
  static constexpr int kThreads = L == 1 ? 64 : 128;
  static constexpr int kCh = kThreads / L;        // channels a CTA
  static constexpr int kNp = L * E;               // padded state row
  static constexpr int kRS = kTC + 1;             // a channel's u / dt / dy
  static constexpr int kStage = 2 * kTC * kNp + 3 * kCh * kRS;  // floats
  static constexpr int kHbuf = kTC * E * kThreads;              // h_{t-1}
  static constexpr int kSlots = kThreads / 32 * L;  // (warp, lane) pairs
  static constexpr int kPbc = 2 * kTC * E * kSlots;    // dB, dC partials
  static constexpr int kPud = 2 * kTC * kThreads;      // du, ddt partials
  static constexpr int kSmem = 4 * (2 * kStage + kHbuf + kPbc + kPud);
  static_assert(kSmem <= 227 * 1024, "shared memory past a CTA's limit");
};

template <int L, int E>
__global__ void __launch_bounds__(Geo<L, E>::kThreads)
    ssm_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   const float* __restrict__ state,
                   const float* __restrict__ dy,
                   const float* __restrict__ dstate_out,
                   float* __restrict__ du, float* __restrict__ ddt,
                   float* __restrict__ dstate, float* __restrict__ ck,
                   float* __restrict__ partB, float* __restrict__ partC,
                   float* __restrict__ dApart, float* __restrict__ dDpart,
                   int T, int di, int N) {
  using Gm = Geo<L, E>;
  constexpr int NT = Gm::kThreads, CH = Gm::kCh, NP = Gm::kNp;
  constexpr int RS = Gm::kRS, STAGE = Gm::kStage, SL = Gm::kSlots;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* hbuf = sm + 2 * STAGE;   // hbuf[(tt * E + e) * NT + tid]
  // pbc[((tt * 2 + {B, C}) * E + e) * SL + warp * L + g]: a warp's sum
  float* pbc = hbuf + Gm::kHbuf;
  float* pud = pbc + Gm::kPbc;    // pud[(tt * 2 + {du, ddt}) * NT + tid]

  const int cb = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = cb * CH;
  const int c = tid / L;  // channel in the CTA
  const int g = tid % L;  // lane in the channel's group
  const int d = d0 + c;
  const bool on = d < di;
  const int nck = (T + kTC - 1) / kTC;
  float* ckb = ck + ((size_t)b * gridDim.x + cb) * nck * E * NT + tid;

  float a_[E];
  const size_t s_off = ((size_t)b * di + d) * N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int n = g * E + e;
    a_[e] = on && n < N ? A[(size_t)d * N + n] : 0.f;
  }

  // steps [ch * kTC, +nt) into stage `buf`: B and u, dt (and with `full`
  // C and dy); entries past N and channels past di zero
  auto stage = [&](int buf, int ch, bool full) {
    float* bs = sm + buf * STAGE;
    float* cs = bs + kTC * NP;
    float* us = cs + kTC * NP;
    float* ds = us + CH * RS;
    float* ys = ds + CH * RS;
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    for (int e = tid; e < nt * NP; e += NT) {
      const int tt = e / NP, n = e % NP;
      const bool ok = n < N;
      const size_t off = ok ? ((size_t)b * T + t0 + tt) * N + n : 0;
      cp_async4(bs + e, Bm + off, ok);
      if (full) cp_async4(cs + e, Cm + off, ok);
    }
    for (int e = tid; e < nt * CH; e += NT) {
      const int tt = e / CH, cc = e % CH;
      const bool ok = d0 + cc < di;
      const size_t off = ok ? ((size_t)b * T + t0 + tt) * di + d0 + cc : 0;
      cp_async4(us + cc * RS + tt, u + off, ok);
      cp_async4(ds + cc * RS + tt, dt + off, ok);
      if (full) cp_async4(ys + cc * RS + tt, dy + off, ok);
    }
  };
  auto load_entries = [&](const float* src, float (&x)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int n = g * E + e;
      x[e] = on && n < N ? src[s_off + n] : 0.f;
    }
  };
  auto load_ck = [&](int ch, float (&x)[E]) {
    if (ch == 0) {
      load_entries(state, x);
      return;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = ckb[((size_t)ch * E + e) * NT];
  };
  // one forward step of staged step tt, as ssm_scan.cu computes it
  auto forward_step = [&](const float* bs, const float* us, const float* ds,
                          int tt, float (&h)[E]) {
    const float uv = us[c * RS + tt], dtv = ds[c * RS + tt];
    const float du_ = dtv * uv;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float dA = expf(dtv * a_[e]);
      h[e] = fmaf(dA, h[e], du_ * bs[tt * NP + g * E + e]);
    }
  };

  float h[E];
  // pass 1: the forward again, the state at the start of chunks 1 ..
  // nck - 1 to the scratch
  load_entries(state, h);
  if (nck > 1) {
    stage(0, 0, false);
    cp_async_commit();
    for (int ch = 0; ch + 1 < nck; ++ch) {
      const int buf = ch & 1;
      cp_async_wait<0>();
      __syncthreads();
      if (ch + 2 < nck) stage(buf ^ 1, ch + 1, false);
      cp_async_commit();
      const float* bs = sm + buf * STAGE;
      const float* us = bs + 2 * kTC * NP;
      const float* ds = us + CH * RS;
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) forward_step(bs, us, ds, tt, h);
#pragma unroll
      for (int e = 0; e < E; ++e)
        ckb[((size_t)(ch + 1) * E + e) * NT] = h[e];
    }
    __syncthreads();  // the stages are reused below
  }

  // pass 2: the chunks from the last back to the first
  float gc[E], dA_acc[E], hn[E];  // a_{t+1} g_{t+1}; dA; next checkpoint
  float dD_acc = 0.f;
  load_entries(dstate_out, gc);
#pragma unroll
  for (int e = 0; e < E; ++e) dA_acc[e] = 0.f;
  load_ck(nck - 1, hn);
  stage(0, nck - 1, true);
  cp_async_commit();
  for (int ch = nck - 1, q = 0; ch >= 0; --ch, ++q) {
    const int buf = q & 1;
    const int t0 = ch * kTC, nt = min(kTC, T - t0);
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is finished
    if (ch > 0) stage(buf ^ 1, ch - 1, true);
    cp_async_commit();
    const float* bs = sm + buf * STAGE;
    const float* cs = bs + kTC * NP;
    const float* us = cs + kTC * NP;
    const float* ds = us + CH * RS;
    const float* ys = ds + CH * RS;
#pragma unroll
    for (int e = 0; e < E; ++e) h[e] = hn[e];
    if (ch > 0) load_ck(ch - 1, hn);
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      if (tt < nt) {
#pragma unroll
        for (int e = 0; e < E; ++e) hbuf[(tt * E + e) * NT + tid] = h[e];
        forward_step(bs, us, ds, tt, h);
      }
    }
    // h is now the state after the chunk's last step
#pragma unroll
    for (int tt = kTC - 1; tt >= 0; --tt) {
      if (tt >= nt) continue;
      const float uv = us[c * RS + tt], dtv = ds[c * RS + tt];
      const float yv = ys[c * RS + tt];
      const float du_ = dtv * uv;
      float su = 0.f, sdt = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float bv = bs[tt * NP + g * E + e];
        const float cv = cs[tt * NP + g * E + e];
        const float a = expf(dtv * a_[e]);
        const float hp = hbuf[(tt * E + e) * NT + tid];
        const float gg = fmaf(yv, cv, gc[e]);  // g_t
        float pb = gg * du_, pc = yv * h[e];
        // the warp's channels (lanes L apart) added by a butterfly
#pragma unroll
        for (int o = L; o < 32; o *= 2) {
          pb += __shfl_xor_sync(0xffffffffu, pb, o);
          pc += __shfl_xor_sync(0xffffffffu, pc, o);
        }
        if (lane < L) {
          pbc[((tt * 2) * E + e) * SL + warp * L + g] = pb;
          pbc[((tt * 2 + 1) * E + e) * SL + warp * L + g] = pc;
        }
        su = fmaf(gg, bv, su);
        sdt = fmaf(gg, fmaf(a_[e] * a, hp, uv * bv), sdt);
        dA_acc[e] = fmaf(gg * dtv, a * hp, dA_acc[e]);
        gc[e] = a * gg;
        h[e] = hp;
      }
      pud[(tt * 2) * NT + tid] = su;
      pud[(tt * 2 + 1) * NT + tid] = sdt;
      if (g == 0) dD_acc = fmaf(yv, uv, dD_acc);
    }
    __syncthreads();
    // du, ddt of (step, channel): the channel's lanes added in order
    for (int e = tid; e < nt * CH; e += NT) {
      const int tt = e / CH, cc = e % CH, dd = d0 + cc;
      if (dd >= di) continue;
      const float* x = pud + (tt * 2) * NT + cc * L;
      float su = x[0], sdt = x[NT];
#pragma unroll
      for (int gq = 1; gq < L; ++gq) {
        su += x[gq];
        sdt += x[NT + gq];
      }
      const size_t o = ((size_t)b * T + t0 + tt) * di + dd;
      du[o] = fmaf(D[dd], ys[cc * RS + tt], ds[cc * RS + tt] * su);
      ddt[o] = sdt;
    }
    // the CTA's dB, dC partials of (step, n): its warps added in order
    for (int e = tid; e < nt * NP; e += NT) {
      const int tt = e / NP, n = e % NP;
      if (n >= N) continue;
      const float* xb = pbc + ((tt * 2) * E + n % E) * SL + n / E;
      const float* xc = xb + E * SL;
      float sb = xb[0], sc = xc[0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) {
        sb += xb[w * L];
        sc += xc[w * L];
      }
      const size_t o = (((size_t)b * gridDim.x + cb) * T + t0 + tt) * N + n;
      partB[o] = sb;
      partC[o] = sc;
    }
  }
  cp_async_wait<0>();
  if (!on) return;
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

// dB, dC = the sums of the channel blocks' partials; dA, dD = the sums of
// the batch rows' partials; each in a fixed order
__global__ void ssm_bwd_sum(const float* __restrict__ partB,
                            const float* __restrict__ partC,
                            const float* __restrict__ dApart,
                            const float* __restrict__ dDpart,
                            float* __restrict__ dB, float* __restrict__ dC,
                            float* __restrict__ dA, float* __restrict__ dD,
                            int B, int T, int di, int N, int ncb) {
  const size_t n_bc = (size_t)B * T * N, n_a = (size_t)di * N;
  const size_t n = n_bc + n_a + di;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_bc) {
      const size_t b = idx / ((size_t)T * N), tn = idx % ((size_t)T * N);
      const size_t off = b * ncb * T * N + tn;
      float sb = partB[off], sc = partC[off];
      for (int q = 1; q < ncb; ++q) {
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

template <int L, int E>
cudaError_t launch(const float* u, const float* dt, const float* Bm,
                   const float* Cm, const float* A, const float* D,
                   const float* state, const float* dy,
                   const float* dstate_out, float* du, float* ddt,
                   float* dstate, float* ck, float* partB, float* partC,
                   float* dApart, float* dDpart, int B, int T, int di, int N,
                   cudaStream_t stream) {
  using Gm = Geo<L, E>;
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_kernel<L, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Gm::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + Gm::kCh - 1) / Gm::kCh, B);
  ssm_bwd_kernel<L, E><<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      u, dt, Bm, Cm, A, D, state, dy, dstate_out, du, ddt, dstate, ck, partB,
      partC, dApart, dDpart, T, di, N);
  return cudaGetLastError();
}

// f(Geo<L, E>{}) for the forward's lane layout of state size N: L the
// next power of two >= N / 2 (at most 32), two entries a lane
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

}  // namespace

// Writes the floats of the five scratch buffers a call at this shape
// needs to sizes[0..4]: the state at every chunk's start (ck), the
// channel blocks' dB and dC partials (partB, partC) and the batch rows'
// dA and dD partials (dApart, dDpart). Returns cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int ssm_scan_bwd_scratch(int B, int T, int di, int N,
                                    long long* sizes) {
  if (!takes(B, T, di, N)) return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto g) {
    using Gm = decltype(g);
    const long long ncb = (long long)B * ((di + Gm::kCh - 1) / Gm::kCh);
    sizes[0] = ncb * ((T + kTC - 1) / kTC) * Gm::kE * Gm::kThreads;
    sizes[1] = sizes[2] = ncb * T * N;
    sizes[3] = (long long)B * di * N;
    sizes[4] = (long long)B * di;
    return 0;
  });
}

// Launches the kernel, then the fixed-order sums of dB, dC, dA and dD, on
// `stream`, and returns the first launch error (0 = both queued). ck,
// partB, partC, dApart and dDpart are scratch of the sizes
// ssm_scan_bwd_scratch gives.
extern "C" int ssm_scan_bwd(const float* u, const float* dt, const float* Bm,
                            const float* Cm, const float* A, const float* D,
                            const float* state, const float* dy,
                            const float* dstate_out, float* du, float* ddt,
                            float* dB, float* dC, float* dA, float* dD,
                            float* dstate, float* ck, float* partB,
                            float* partC, float* dApart, float* dDpart, int B,
                            int T, int di, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!takes(B, T, di, N)) return (int)cudaErrorInvalidValue;
  return by_state(N, [&](auto g) {
    using Gm = decltype(g);
    cudaError_t err = launch<Gm::kL, Gm::kE>(
        u, dt, Bm, Cm, A, D, state, dy, dstate_out, du, ddt, dstate, ck,
        partB, partC, dApart, dDpart, B, T, di, N, st);
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)B * T * N + (size_t)di * N + di;
    const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                        : 132 * 16);
    ssm_bwd_sum<<<blocks, 256, 0, st>>>(partB, partC, dApart, dDpart, dB, dC,
                                        dA, dD, B, T, di, N,
                                        (di + Gm::kCh - 1) / Gm::kCh);
    return (int)cudaGetLastError();
  });
}
