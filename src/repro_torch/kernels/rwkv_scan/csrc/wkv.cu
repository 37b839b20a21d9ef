// RWKV-6 WKV recurrence for Hopper (sm_90a), any T >= 1, head dim <= 128.
//
// Replaces the TPU kernel `_wkv_kernel`
// (src/repro/kernels/rwkv_scan/kernel.py:29, pallas_call at :69) and
// computes the same function. Per batch row b and head h, with the
// (hd x hd) state S carried over time:
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Everything is f32. Layouts (all contiguous): r, k, v, w, out
// (B, T, H, hd); u (H, hd); state, state_out (B, H, hd, hd), S[i][j] at
// [b, h, i, j]. state_out may alias state: each CTA reads its own
// (b, h) slice before it writes it.
//
// Design. The TPU grid carried S in VMEM across an "arbitrary" time-block
// axis. Here one CTA owns one (b, h) and walks all of T itself: thread j
// keeps column j of S (HDMAX floats) in registers for the whole scan, so
// the state touches device memory once in and once out. Time steps are
// staged kTC at a time in shared memory (r, k, w, v: one coalesced row
// of hd floats per step), one __syncthreads pair per kTC steps; every
// thread then reads r_t[i], k_t[i], w_t[i] as shared-memory broadcasts
// and its own v_t[j]. Head dims below HDMAX run with the tail threads
// and tail entries zeroed: a zero k, r, w and S entry contributes 0 to
// out and stays 0, so the inner loop needs no predicate.
//
// Bound on an H100 SXM: bytes. At the serving decode shape (rwkv6-1.6b:
// B 8, T 1, H 32, hd 64) the state in and out is 2 * 8 * 32 * 64 * 64 * 4
// = 8.4 MB against 0.3 MB of r, k, v, w, out; the flops (about 6 per
// state entry per step) are negligible, so a decode call is bound by
// 8.7 MB over 3.35 TB/s. A long prefill is bound by the T dependent
// steps instead: each step's out[j] is a chain of hd dependent FMAs.
// What this first design leaves on the table: the out[j] sum is one
// dependent chain (no split over i), the staging is synchronous (no
// cp.async double buffering), and at decode only B * H CTAs of hd
// threads exist. A chunked formulation on tensor cores is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTC = 16;  // time steps staged per __syncthreads pair

template <int HDMAX>
__global__ void __launch_bounds__(HDMAX)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* state,
               float* __restrict__ out, float* state_out, int T, int H,
               int hd) {
  __shared__ float rs[kTC][HDMAX];
  __shared__ float ks[kTC][HDMAX];
  __shared__ float ws[kTC][HDMAX];
  __shared__ float vs[kTC][HDMAX];
  __shared__ float us[HDMAX];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const bool on = j < hd;

  // column j of this head's state; rows i >= hd stay 0
  float S[HDMAX];
  const float* s0 = state + (size_t)bh * hd * hd;
#pragma unroll
  for (int i = 0; i < HDMAX; ++i)
    S[i] = (on && i < hd) ? s0[(size_t)i * hd + j] : 0.f;
  us[j] = on ? u[(size_t)h * hd + j] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int nt = min(kTC, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (((size_t)b * T + t0 + tt) * H + h) * hd + j;
      rs[tt][j] = on ? r[off] : 0.f;
      ks[tt][j] = on ? k[off] : 0.f;
      ws[tt][j] = on ? w[off] : 0.f;
      vs[tt][j] = on ? v[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HDMAX; ++i) {
        const float kv = ks[tt][i] * vj;
        acc += rs[tt][i] * (S[i] + us[i] * kv);
        S[i] = ws[tt][i] * S[i] + kv;
      }
      if (on) out[(((size_t)b * T + t0 + tt) * H + h) * hd + j] = acc;
    }
  }
  if (!on) return;
  float* sT = state_out + (size_t)bh * hd * hd;
#pragma unroll
  for (int i = 0; i < HDMAX; ++i)
    if (i < hd) sT[(size_t)i * hd + j] = S[i];
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int wkv_scan(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* state,
                        float* out, float* state_out, int B, int T, int H,
                        int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H);
#define WKV_LAUNCH(HDMAX_)                                              \
  wkv_kernel<HDMAX_><<<grid, HDMAX_, 0, st>>>(r, k, v, w, u, state, out, \
                                              state_out, T, H, hd)
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  if (hd <= 32)
    WKV_LAUNCH(32);
  else if (hd <= 64)
    WKV_LAUNCH(64);
  else
    WKV_LAUNCH(128);
#undef WKV_LAUNCH
  return (int)cudaGetLastError();
}
