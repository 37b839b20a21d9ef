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
// (B, H, hd, hd).
//
// Bound on an H100 SXM at the train shape (rwkv6-1.6b: B 2, T 1024, H
// 32, hd 64): 14 f32 operations a state entry and step (the forward
// once, for S_{t-1}, then the FMAs of dr, dk, dw and dv and the dS
// update; this kernel's second forward pass is not counted), 3.76 GFLOP
// at 67 TFLOP/s, 0.056 ms; its bytes (r, k, v, w, dout read, dr, dk,
// dv, dw written, the state and its gradients) are 154 MB, 0.046 ms.
//
// Design.
// - Where S_{t-1} comes from. The decays underflow to exactly 0 in the
//   model, so S_{t-1} cannot be had by dividing S_t by w_t: the kernel
//   first runs the forward again and writes the state at the start of
//   every 16-step chunk to a scratch (`ck`, 64 KB a (b, h) a chunk at hd
//   64). Going back, a chunk starts from its checkpoint (loaded during
//   the chunk before), runs its 16 steps forward once more into shared
//   memory, and then walks them backward. Serving's forward is
//   untouched.
// - Who owns what. Every recurrence here is entry by entry; only the sums
//   couple entries: dr, dk, dw sum over the columns j of a row, dv over
//   the rows i of a column. A CTA takes 16 rows of a (b, h) and all of
//   its columns, so a row's sums stay inside one warp: lane l of warp q
//   holds rows 4q .. 4q + 3 and the CPL = hd_padded / 32 columns from
//   l * CPL (8 entries of S and 8 of dS at hd 64). Two steps' 13 row
//   sums a lane (dr, dk, dw of 4 rows, and dout . v) are reduced over the
//   warp by one transpose-reduce (31 shuffles for 32 values,
//   hopper::reduce_steps). dv crosses the ceil(hd / 16) CTAs of a head:
//   each writes its (T, hd) partial, summed over the warps in a fixed
//   order, to a scratch, and a second launch adds them in a fixed order,
//   as it adds du's per-(b, h) partials over b. No atomics: two calls
//   give the same bits.
// - Staging as in wkv.cu: r, k, w (the CTA's 16 rows) and v, dout (all
//   columns) of a 16-step chunk by 4-byte `cp.async` into a ring of two,
//   the next chunk (backward: the one before) in flight while one is
//   scanned. Grid (ceil(hd / 16), H, B): 256 CTAs of 128 threads at the
//   train shape, 108 KB of shared memory each at hd 64 (207 KB at 128).
// - A simple kernel first: the two passes over T are sequential chains,
//   one FMA a step each, and at the train shape the card holds two CTAs
//   an SM; the time is written down beside the bound (PERF.md).
#include <cuda_runtime.h>
#include <stddef.h>

#include "../../include/hopper.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::reduce_steps;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 4;              // rows a lane holds
constexpr int kRB = kWarps * kE;   // rows a CTA holds
constexpr int kTC = 16;            // time steps a chunk
constexpr int kRed = 16;           // row sums a warp and step: dr, dk, dw
//                                    of its 4 rows, dout . v, 3 unused

template <int CPL>
struct Geo {
  static constexpr int kHdp = 32 * CPL;                   // padded hd
  static constexpr int kEnt = kE * CPL;                   // entries a lane
  static constexpr int kStage = kTC * (3 * kRB + 2 * kHdp);  // floats
  static constexpr int kSbuf = kTC * kEnt * kThreads;     // S_{t-1}
  static constexpr int kRedN = kTC * kWarps * kRed;       // row sums
  static constexpr int kDvp = kTC * kWarps * kHdp;        // dv partials
  static constexpr int kSmem =
      4 * (2 * kStage + kSbuf + kRedN + kDvp + kThreads);
  static_assert(kSmem <= 227 * 1024, "shared memory past a CTA's limit");
};

template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

template <int CPL>
__global__ void __launch_bounds__(kThreads, 1)
    wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ state,
                   const float* __restrict__ dout,
                   const float* __restrict__ dstate_out,
                   float* __restrict__ dr, float* __restrict__ dk,
                   float* __restrict__ dw, float* __restrict__ dstate,
                   float* __restrict__ ck, float* __restrict__ dvpart,
                   float* __restrict__ dupart, int T, int H, int hd) {
  using Gm = Geo<CPL>;
  constexpr int HDP = Gm::kHdp, ENT = Gm::kEnt, STAGE = Gm::kStage;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sbuf = sm + 2 * STAGE;      // sbuf[(tt * ENT + x) * kThreads + tid]
  float* red = sbuf + Gm::kSbuf;     // red[(tt * kWarps + q) * kRed + s]
  float* dvps = red + Gm::kRedN;     // dvps[(tt * kWarps + q) * HDP + j]
  float* dus = dvps + Gm::kDvp;      // du partials, one a thread

  const int rb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = rb * kRB + warp * kE;  // the lane's first row
  const int j0 = lane * CPL;            // its first column
  const size_t bh = (size_t)b * H + h;
  const size_t bhr = bh * gridDim.x + rb;
  const int nck = (T + kTC - 1) / kTC;
  float* ckb = ck + bhr * nck * ENT * kThreads + tid;

  // steps [c * kTC, +nt) into stage `buf`: k, w (and with `full` r) of
  // the CTA's rows, v (and dout) of every column; past hd zero
  auto stage = [&](int buf, int c, bool full) {
    float* rs = sm + buf * STAGE;
    float* ks = rs + kTC * kRB;
    float* ws = ks + kTC * kRB;
    float* vs = ws + kTC * kRB;
    float* os = vs + kTC * HDP;
    const int t0 = c * kTC, nt = min(kTC, T - t0);
    for (int e = tid; e < nt * kRB; e += kThreads) {
      const int tt = e / kRB, i = rb * kRB + e % kRB;
      const bool ok = i < hd;
      const size_t off =
          ok ? (((size_t)b * T + t0 + tt) * H + h) * hd + i : 0;
      if (full) cp_async4(rs + e, r + off, ok);
      cp_async4(ks + e, k + off, ok);
      cp_async4(ws + e, w + off, ok);
    }
    for (int e = tid; e < nt * HDP; e += kThreads) {
      const int tt = e / HDP, j = e % HDP;
      const bool ok = j < hd;
      const size_t off =
          ok ? (((size_t)b * T + t0 + tt) * H + h) * hd + j : 0;
      cp_async4(vs + e, v + off, ok);
      if (full) cp_async4(os + e, dout + off, ok);
    }
  };
  // the lane's entries of a (B, H, hd, hd) tensor
  auto load_entries = [&](const float* src, float (&x)[kE][CPL]) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = i0 + e, j = j0 + c;
        x[e][c] = i < hd && j < hd ? src[(bh * hd + i) * hd + j] : 0.f;
      }
  };
  auto load_ck = [&](int c, float (&x)[kE][CPL]) {
    if (c == 0) {
      load_entries(state, x);
      return;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        x[e][cc] = ckb[((size_t)c * ENT + e * CPL + cc) * kThreads];
  };
  // one forward step of staged step tt: S = w S + k v
  auto forward_step = [&](const float* ks, const float* ws, const float* vs,
                          int tt, float (&S)[kE][CPL]) {
    float kk[kE], ww[kE], vv[CPL];
    load_n<kE>(ks + tt * kRB + warp * kE, kk);
    load_n<kE>(ws + tt * kRB + warp * kE, ww);
    load_n<CPL>(vs + tt * HDP + j0, vv);
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        S[e][c] = fmaf(ww[e], S[e][c], kk[e] * vv[c]);
  };

  float S[kE][CPL];
  // pass 1: the forward again, the state at the start of chunks 1 ..
  // nck - 1 to the scratch (the last chunk's own steps are not needed)
  load_entries(state, S);
  if (nck > 1) {
    stage(0, 0, false);
    cp_async_commit();
    for (int c = 0; c + 1 < nck; ++c) {
      const int buf = c & 1;
      cp_async_wait<0>();
      __syncthreads();
      if (c + 2 < nck) stage(buf ^ 1, c + 1, false);
      cp_async_commit();
      const float* ks = sm + buf * STAGE + kTC * kRB;
      const float* ws = ks + kTC * kRB;
      const float* vs = ws + kTC * kRB;
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) forward_step(ks, ws, vs, tt, S);
#pragma unroll
      for (int e = 0; e < kE; ++e)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          ckb[((size_t)(c + 1) * ENT + e * CPL + cc) * kThreads] = S[e][cc];
    }
    __syncthreads();  // the stages are reused below
  }

  // pass 2: the chunks from the last back to the first
  float dS[kE][CPL], uu[kE];
  load_entries(dstate_out, dS);
#pragma unroll
  for (int e = 0; e < kE; ++e)
    uu[e] = i0 + e < hd ? u[(size_t)h * hd + i0 + e] : 0.f;
  const int frow = tid % kRB;  // the row this thread finishes
  float du_acc = 0.f;
  float Sn[kE][CPL];  // the next chunk's checkpoint, loaded a chunk ahead
  load_ck(nck - 1, Sn);
  stage(0, nck - 1, true);
  cp_async_commit();
  for (int c = nck - 1, q = 0; c >= 0; --c, ++q) {
    const int buf = q & 1;
    const int t0 = c * kTC, nt = min(kTC, T - t0);
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is finished
    if (c > 0) stage(buf ^ 1, c - 1, true);
    cp_async_commit();
    const float* rs = sm + buf * STAGE;
    const float* ks = rs + kTC * kRB;
    const float* ws = ks + kTC * kRB;
    const float* vs = ws + kTC * kRB;
    const float* os = vs + kTC * HDP;
#pragma unroll
    for (int e = 0; e < kE; ++e)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) S[e][cc] = Sn[e][cc];
    if (c > 0) load_ck(c - 1, Sn);
    // the chunk's states S_{t-1} into this thread's slots of sbuf
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      if (tt < nt) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            sbuf[(tt * ENT + e * CPL + cc) * kThreads + tid] = S[e][cc];
        forward_step(ks, ws, vs, tt, S);
      }
    }
    // backward over the chunk, two steps a transpose-reduce
#pragma unroll
    for (int p = kTC / 2 - 1; p >= 0; --p) {
      float vals[2 * kRed];
#pragma unroll
      for (int s = 1; s >= 0; --s) {
        const int tt = 2 * p + s;
#pragma unroll
        for (int m = 0; m < kRed; ++m) vals[s * kRed + m] = 0.f;
        if (tt >= nt) continue;
        float rr[kE], kk[kE], ww[kE], vv[CPL], oo[CPL];
        load_n<kE>(rs + tt * kRB + warp * kE, rr);
        load_n<kE>(ks + tt * kRB + warp * kE, kk);
        load_n<kE>(ws + tt * kRB + warp * kE, ww);
        load_n<CPL>(vs + tt * HDP + j0, vv);
        load_n<CPL>(os + tt * HDP + j0, oo);
        float rku = 0.f, dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) rku = fmaf(rr[e] * uu[e], kk[e], rku);
        float dvp[CPL];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          dot = fmaf(oo[cc], vv[cc], dot);
          dvp[cc] = oo[cc] * rku;
        }
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float drp = 0.f, dkp = 0.f, dwp = 0.f;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) {
            const float sp = sbuf[(tt * ENT + e * CPL + cc) * kThreads + tid];
            drp = fmaf(oo[cc], sp, drp);
            dkp = fmaf(dS[e][cc], vv[cc], dkp);
            dwp = fmaf(dS[e][cc], sp, dwp);
            dvp[cc] = fmaf(kk[e], dS[e][cc], dvp[cc]);
            dS[e][cc] = fmaf(ww[e], dS[e][cc], rr[e] * oo[cc]);
          }
          vals[s * kRed + e] = drp;
          vals[s * kRed + kE + e] = dkp;
          vals[s * kRed + 2 * kE + e] = dwp;
        }
        vals[s * kRed + 3 * kE] = dot;
        store_n<CPL>(dvps + (tt * kWarps + warp) * HDP + j0, dvp);
      }
      reduce_steps<32, 2 * kRed>(vals, lane);
      // lane l now holds the warp's sum of value l: step 2p + l / 16
      red[((2 * p + lane / kRed) * kWarps + warp) * kRed + lane % kRed] =
          vals[0];
    }
    __syncthreads();
    // dr, dk, dw of (step, row): 8 threads a row, 2 steps each
    {
      const int i = rb * kRB + frow;
      const float u_i = i < hd ? u[(size_t)h * hd + i] : 0.f;
      for (int tt = tid / kRB; tt < nt; tt += kThreads / kRB) {
        if (i >= hd) break;
        const float* x = red + (tt * kWarps + frow / kE) * kRed;
        const float dot = x[3 * kE];
        const float rv = rs[tt * kRB + frow], kv = ks[tt * kRB + frow];
        const size_t o = (((size_t)b * T + t0 + tt) * H + h) * hd + i;
        dr[o] = fmaf(u_i * kv, dot, x[frow % kE]);
        dk[o] = fmaf(u_i * rv, dot, x[kE + frow % kE]);
        dw[o] = x[2 * kE + frow % kE];
        du_acc = fmaf(rv * kv, dot, du_acc);
      }
    }
    // the CTA's dv partial of (step, column), its warps added in order
    for (int e = tid; e < nt * HDP; e += kThreads) {
      const int tt = e / HDP, j = e % HDP;
      if (j >= hd) continue;
      const float* x = dvps + tt * kWarps * HDP + j;
      float s = x[0];
#pragma unroll
      for (int qq = 1; qq < kWarps; ++qq) s += x[qq * HDP];
      dvpart[(bhr * T + t0 + tt) * hd + j] = s;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int i = i0 + e, j = j0 + cc;
      if (i < hd && j < hd) dstate[(bh * hd + i) * hd + j] = dS[e][cc];
    }
  dus[tid] = du_acc;
  __syncthreads();
  if (tid < kRB && rb * kRB + tid < hd) {
    float s = dus[tid];
#pragma unroll
    for (int qq = 1; qq < kThreads / kRB; ++qq) s += dus[tid + qq * kRB];
    dupart[bh * hd + rb * kRB + tid] = s;
  }
}

// dv = the sum of the row blocks' partials, du = the sum of the (b, h)
// partials over b, each in a fixed order
__global__ void wkv_bwd_sum(const float* __restrict__ dvpart,
                            const float* __restrict__ dupart,
                            float* __restrict__ dv, float* __restrict__ du,
                            int B, int T, int H, int hd, int rbn) {
  const size_t n_dv = (size_t)B * T * H * hd;
  const size_t n = n_dv + (size_t)H * hd;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_dv) {
      const int j = idx % hd;
      size_t rest = idx / hd;
      const int h = rest % H;
      rest /= H;
      const int t = rest % T;
      const size_t b = rest / T;
      const float* p =
          dvpart + (((b * H + h) * rbn) * T + t) * (size_t)hd + j;
      float s = p[0];
      for (int q = 1; q < rbn; ++q) s += p[(size_t)q * T * hd];
      dv[idx] = s;
    } else {
      const size_t q = idx - n_dv;
      float s = dupart[q];
      for (int b = 1; b < B; ++b) s += dupart[(size_t)b * H * hd + q];
      du[q] = s;
    }
  }
}

template <int CPL>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* state,
                   const float* dout, const float* dstate_out, float* dr,
                   float* dk, float* dw, float* dstate, float* ck,
                   float* dvpart, float* dupart, int B, int T, int H,
                   int hd, cudaStream_t stream) {
  using Gm = Geo<CPL>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Gm::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hd + kRB - 1) / kRB, H, B);
  wkv_bwd_kernel<CPL><<<grid, kThreads, Gm::kSmem, stream>>>(
      r, k, v, w, u, state, dout, dstate_out, dr, dk, dw, dstate, ck,
      dvpart, dupart, T, H, hd);
  return cudaGetLastError();
}

}  // namespace

// Writes the floats of the three scratch buffers a call at this shape
// needs to sizes[0..2]: the state at every chunk's start (ck), the row
// blocks' dv partials (dvpart) and the (b, h) du partials (dupart).
// Returns cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int wkv_bwd_scratch(int B, int T, int H, int hd,
                               long long* sizes) {
  if (hd < 1 || hd > 128 || T < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long cpl = hd <= 32 ? 1 : hd <= 64 ? 2 : 4;
  const long long bhr = (long long)B * H * ((hd + kRB - 1) / kRB);
  sizes[0] = bhr * ((T + kTC - 1) / kTC) * kE * cpl * kThreads;
  sizes[1] = bhr * T * hd;
  sizes[2] = (long long)B * H * hd;
  return 0;
}

// Launches the kernel, then the fixed-order sum of dv and du, on
// `stream`, and returns the first launch error (0 = both queued). ck,
// dvpart and dupart are scratch of the sizes wkv_bwd_scratch gives.
extern "C" int wkv_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* state,
                       const float* dout, const float* dstate_out, float* dr,
                       float* dk, float* dv, float* dw, float* du,
                       float* dstate, float* ck, float* dvpart,
                       float* dupart, int B, int T, int H, int hd,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128 || T < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const int cols = hd <= 32 ? 1 : hd <= 64 ? 2 : 4;
#define WKV_BWD_LAUNCH(C_)                                                 \
  launch<C_>(r, k, v, w, u, state, dout, dstate_out, dr, dk, dw, dstate, \
             ck, dvpart, dupart, B, T, H, hd, st)
  cudaError_t err = cols == 1   ? WKV_BWD_LAUNCH(1)
                    : cols == 2 ? WKV_BWD_LAUNCH(2)
                                : WKV_BWD_LAUNCH(4);
#undef WKV_BWD_LAUNCH
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * H * hd + (size_t)H * hd;
  const int blocks = (int)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                      : 132 * 16);
  wkv_bwd_sum<<<blocks, 256, 0, st>>>(dvpart, dupart, dv, du, B, T, H, hd,
                                      (hd + kRB - 1) / kRB);
  return (int)cudaGetLastError();
}
