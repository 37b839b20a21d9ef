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
// state, state_out (B, di, N). state_out may alias state: each thread
// reads its own channel's state before it writes it.
//
// Design. The TPU grid carried a (bd, N) state tile in VMEM across an
// "arbitrary" time-block axis. Here one thread owns one channel for the
// whole scan and keeps its h[N] and A[d][:] in registers; a CTA is
// kThreads consecutive channels of one batch row, grid (ceil(di /
// kThreads), B), the ragged channel tail masked. B_t and C_t (N values
// each, shared by every channel of the row) are staged in shared memory
// kTC steps at a time; u_t and dt_t are read coalesced along d. State
// sizes below NMAX run with zeroed tail entries (A = 0, B = C = 0 keeps
// h = 0 and adds 0 to y), so the inner loop needs no predicate.
//
// Bound on an H100 SXM: bytes. At the serving decode shape (hymba-1.5b:
// B 8, T 1, di 3200, N 16) the state in and out is 2 * 8 * 3200 * 16 * 4
// = 3.3 MB against 0.3 MB of u, dt, y; the flops (one exp and about 6
// more per state entry per step) are small beside the bytes. A long
// prefill is bound by the T dependent steps of each channel. What this
// first design leaves on the table: at decode only B * ceil(di / 128)
// CTAs (200 at the serving shape), synchronous staging (no cp.async
// double buffering), and no split of T into chunks scanned in parallel.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // channels per CTA
constexpr int kTC = 32;        // time steps staged per __syncthreads pair

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
    ssm_kernel(const float* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ A, const float* __restrict__ D,
               const float* state, float* __restrict__ y, float* state_out,
               int T, int di, int N) {
  __shared__ float bs[kTC][NMAX];
  __shared__ float cs[kTC][NMAX];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool on = d < di;

  float h[NMAX], a[NMAX];
  const size_t s_off = ((size_t)b * di + d) * N;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool live = on && n < N;
    h[n] = live ? state[s_off + n] : 0.f;
    a[n] = live ? A[(size_t)d * N + n] : 0.f;
  }
  const float dd = on ? D[d] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int nt = min(kTC, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < nt * NMAX; e += kThreads) {
      const int tt = e / NMAX;
      const int n = e - tt * NMAX;
      const size_t src = ((size_t)b * T + t0 + tt) * N + n;
      bs[tt][n] = n < N ? Bm[src] : 0.f;
      cs[tt][n] = n < N ? Cm[src] : 0.f;
    }
    __syncthreads();
    if (!on) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = ((size_t)b * T + t0 + tt) * di + d;
      const float ut = u[off];
      const float dtt = dt[off];
      const float du = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        h[n] = expf(dtt * a[n]) * h[n] + du * bs[tt][n];
        acc += cs[tt][n] * h[n];
      }
      y[off] = acc + dd * ut;
    }
  }
  if (!on) return;
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    if (n < N) state_out[s_off + n] = h[n];
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int ssm_scan(const float* u, const float* dt, const float* Bm,
                        const float* Cm, const float* A, const float* D,
                        const float* state, float* y, float* state_out,
                        int B, int T, int di, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((di + kThreads - 1) / kThreads, B);
#define SSM_LAUNCH(NMAX_)                                             \
  ssm_kernel<NMAX_><<<grid, kThreads, 0, st>>>(u, dt, Bm, Cm, A, D,   \
                                               state, y, state_out, T, \
                                               di, N)
  if (N < 1 || N > 64 || di < 1) return (int)cudaErrorInvalidValue;
  if (N <= 16)
    SSM_LAUNCH(16);
  else if (N <= 32)
    SSM_LAUNCH(32);
  else
    SSM_LAUNCH(64);
#undef SSM_LAUNCH
  return (int)cudaGetLastError();
}
