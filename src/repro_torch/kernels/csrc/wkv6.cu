// RWKV6 WKV recurrence for Hopper (sm_90a): the forward and its backward as
// four kernels (dr, dk with dlogw and ds0, dv, du). fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/rwkv/kernel.py, wkv6_bhld (pallas_call body
// _wkv6_kernel), the TPU WKV6 forward, wrapped by rwkv/ops.py: wkv6. The
// reference has no backward kernel; the backward here computes the gradient
// of the same recurrence (held against jax.vjp of
// src/repro/models/ssm.py: wkv6_scan in the tests).
//
// What it computes, per (b, h), with w_t = exp(logw_t):
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// S_0 = s0, and the final state sT = S_L. Every tensor is fp32 and
// contiguous, in the model's layout: r, k, v, logw, y [B, L, H, hd]; u
// [H, hd]; states [B, H, hd, hd] with S[i][j] at i * hd + j (i indexes k, j
// indexes v). Any L >= 1 works: nothing is padded.
//
// The backward, with G_t the gradient with respect to S_t (G_L = dsT) and
// G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//   dr_t = S_{t-1} dy_t + u . k_t (v_t . dy_t)
//   dk_t = G_t v_t + u . r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + (sum_i r_ti u_i k_ti) dy_t
//   du   = sum_{b,t} r_t . k_t (v_t . dy_t),   ds0 = G_0
//   dlogw_t = w_t . rowsum(G_t . S_{t-1}) = sum_{m >= t} a_m - sum_{t <= m < L} b_m
// with a_m = r_{m+1} . w_m . (S_{m-1} dy_{m+1}) for m < L, a_L = w_L .
// rowsum(dsT . S_{L-1}), and b_m = k_m . w_{m+1} . (G_{m+1} v_m). This holds
// because dlogw_t - dlogw_{t+1} = a_t - b_t: expanding S_t and G_t by one
// step, the two products of S_t with r_{t+1} dy_{t+1}^T and of G_t with
// k_t v_t^T share the term r_{t+1} k_t (v_t . dy_{t+1}), which cancels. It is
// left out of a and b, not subtracted: it carries no decay, so where w is
// small it is far larger than dlogw, and subtracting it in fp32 would leave
// its rounding error in dlogw. So dlogw is a reverse cumulative sum of terms
// that the dr and dk scans form beside their own sums, and no kernel stores
// a state per step.
//
// Design. The recurrence is serial in t, so each block owns one (b, h) and
// loops over t itself (the TPU's sequential chunk axis becomes that loop), as
// the RWKV project's own CUDA kernels do. A block has hd threads and each
// thread keeps one column (wkv6_fwd, wkv6_bwd_dv) or one row (wkv6_bwd_dr,
// wkv6_bwd_dk) of the hd x hd fp32 state in registers, so each thread owns
// its outputs and no kernel needs atomics: the forward and dv need column j
// of S or G only, dr and dk row i only. Blocks stage CH steps of their inputs
// in shared memory at a time (coalesced rows of hd floats), and the step loop
// reads them as broadcasts. du sums per-(b, h) partials that wkv6_bwd_dr
// writes, over b in a fixed order, in wkv6_bwd_du.
//
// What bounds it on an H100: the work is ~5 hd^2 flops per (token, head), so
// at hd = 64 one [B, L, H, hd] fp32 tensor (4 bytes a value) carries 80
// flops per value, 20 per byte: about the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). Both bounds are near 0.1 ms at B = 8, H = 32, L = 1024.
// This first version does not reach them: a step's 64-term sums run on one
// thread, the B x H blocks (256 at the main shape) give an SM two warps or
// four, and the loads of the next CH steps are not overlapped with the
// current ones. Splitting each sum over several threads (with warp shuffles)
// and double-buffered staging are the next steps.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CH = 16;     // time steps staged in shared memory at once

struct Dims {
  size_t row;    // H * hd: the stride of t in [B, L, H, hd]
  size_t base;   // offset of (b, t = 0, h, 0)
};

template <int HD>
__device__ __forceinline__ Dims dims_of(int L, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  Dims d;
  d.row = (size_t)H * HD;
  d.base = (size_t)b * L * d.row + (size_t)h * HD;
  return d;
}

// Steps [t0, t0 + n) of a [B, L, H, hd] tensor into dst[CH][HD], element x of
// each row by thread x, optionally through expf.
template <int HD, bool EXP = false>
__device__ __forceinline__ void stage(float (*dst)[HD], const float* __restrict__ src,
                                      const Dims& d, int t0, int n) {
  const int x = threadIdx.x;
  for (int c = 0; c < n; ++c) {
    const float val = src[d.base + (size_t)(t0 + c) * d.row + x];
    dst[c][x] = EXP ? expf(val) : val;
  }
}

// Forward. Thread j keeps column j of S.
template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sT, int L, int H) {
  __shared__ float sr[CH][HD], sk[CH][HD], sv[CH][HD], sw[CH][HD], su[HD];
  const Dims d = dims_of<HD>(L, H);
  const int j = threadIdx.x;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0[st + i * HD + j];
  su[j] = u[(blockIdx.x % H) * HD + j];
  for (int t0 = 0; t0 < L; t0 += CH) {
    const int n = min(CH, L - t0);
    __syncthreads();  // the previous chunk is consumed
    stage<HD>(sr, r, d, t0, n);
    stage<HD>(sk, k, d, t0, n);
    stage<HD>(sv, v, d, t0, n);
    stage<HD, true>(sw, logw, d, t0, n);
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float yj = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = sk[c][i] * vj;
        yj = fmaf(sr[c][i], fmaf(su[i], kv, S[i]), yj);
        S[i] = fmaf(sw[c][i], S[i], kv);
      }
      y[d.base + (size_t)(t0 + c) * d.row + j] = yj;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[st + i * HD + j] = S[i];
}

// dr, the a terms of dlogw and the (b, h) partial of du: the forward scan
// again, thread i keeping row i of S. Rows of r and dy are staged one step
// ahead, for a.
template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_bwd_dr_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ logw,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       const float* __restrict__ dy, const float* __restrict__ dsT,
                       float* __restrict__ dr, float* __restrict__ a,
                       float* __restrict__ du_part, int L, int H) {
  __shared__ float sr[CH + 1][HD], sk[CH][HD], sv[CH][HD], sw[CH][HD], sdy[CH + 1][HD];
  const Dims d = dims_of<HD>(L, H);
  const int i = threadIdx.x;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  float S[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) S[j] = s0[st + i * HD + j];
  const float ui = u[(blockIdx.x % H) * HD + i];
  float dui = 0.f;
  for (int t0 = 0; t0 < L; t0 += CH) {
    const int n = min(CH, L - t0), n1 = min(CH + 1, L - t0);
    __syncthreads();
    stage<HD>(sr, r, d, t0, n1);
    stage<HD>(sk, k, d, t0, n);
    stage<HD>(sv, v, d, t0, n);
    stage<HD, true>(sw, logw, d, t0, n);
    stage<HD>(sdy, dy, d, t0, n1);
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float ri = sr[c][i], ki = sk[c][i], wi = sw[c][i];
      const bool last = t0 + c == L - 1;
      // S_{t-1} against the next step's dy, or against dsT after the last
      float snext = 0.f, anext = 1.f;
      if (!last) {
        anext = sr[c + 1][i];
#pragma unroll
        for (int j = 0; j < HD; ++j) snext = fmaf(S[j], sdy[c + 1][j], snext);
      } else {
#pragma unroll
        for (int j = 0; j < HD; ++j) snext = fmaf(S[j], dsT[st + i * HD + j], snext);
      }
      float sdot = 0.f, vdy = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        const float vj = sv[c][j], dyj = sdy[c][j];
        sdot = fmaf(S[j], dyj, sdot);
        vdy = fmaf(vj, dyj, vdy);
        S[j] = fmaf(wi, S[j], ki * vj);
      }
      const size_t o = d.base + (size_t)(t0 + c) * d.row + i;
      dr[o] = fmaf(ui * ki, vdy, sdot);
      a[o] = anext * wi * snext;
      dui = fmaf(ri * ki, vdy, dui);
    }
  }
  du_part[(size_t)blockIdx.x * HD + i] = dui;
}

// dk, dlogw and ds0: the reverse scan of G, thread i keeping row i of G.
// Rows of v are staged one step behind, for b.
template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_bwd_dk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ logw,
                       const float* __restrict__ u, const float* __restrict__ dy,
                       const float* __restrict__ dsT, const float* __restrict__ a,
                       float* __restrict__ dk, float* __restrict__ dlogw,
                       float* __restrict__ ds0, int L, int H) {
  // sv[c + 1] holds step t0 + c and sv[0] step t0 - 1 (zeros before step 0)
  __shared__ float sr[CH][HD], sk[CH][HD], sv[CH + 1][HD], sw[CH][HD], sdy[CH][HD], sa[CH][HD];
  const Dims d = dims_of<HD>(L, H);
  const int i = threadIdx.x;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  float G[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) G[j] = dsT[st + i * HD + j];
  const float ui = u[(blockIdx.x % H) * HD + i];
  float acc = 0.f;     // dlogw_{t+1}
  float gv_next = 0.f; // G_{t+1} v_t, formed at step t + 1
  float w_next = 0.f;  // w_{t+1}
  for (int t0 = ((L - 1) / CH) * CH; t0 >= 0; t0 -= CH) {
    const int n = min(CH, L - t0);
    __syncthreads();
    stage<HD>(sr, r, d, t0, n);
    stage<HD>(sk, k, d, t0, n);
    stage<HD>(sv + 1, v, d, t0, n);
    sv[0][i] = t0 > 0 ? v[d.base + (size_t)(t0 - 1) * d.row + i] : 0.f;
    stage<HD, true>(sw, logw, d, t0, n);
    stage<HD>(sdy, dy, d, t0, n);
    stage<HD>(sa, a, d, t0, n);
    __syncthreads();
    for (int c = n - 1; c >= 0; --c) {
      const float ri = sr[c][i], ki = sk[c][i], wi = sw[c][i];
      float gv = 0.f, gv_prev = 0.f, vdy = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        const float vj = sv[c + 1][j], dyj = sdy[c][j];
        gv = fmaf(G[j], vj, gv);
        gv_prev = fmaf(G[j], sv[c][j], gv_prev);
        vdy = fmaf(vj, dyj, vdy);
        G[j] = fmaf(wi, G[j], ri * dyj);
      }
      const size_t o = d.base + (size_t)(t0 + c) * d.row + i;
      dk[o] = fmaf(ui * ri, vdy, gv);
      acc = t0 + c == L - 1 ? sa[c][i] : acc + (sa[c][i] - ki * w_next * gv_next);
      dlogw[o] = acc;
      gv_next = gv_prev;
      w_next = wi;
    }
  }
#pragma unroll
  for (int j = 0; j < HD; ++j) ds0[st + i * HD + j] = G[j];
}

// dv: the reverse scan of G, thread j keeping column j of G.
template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_bwd_dv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ logw, const float* __restrict__ u,
                       const float* __restrict__ dy, const float* __restrict__ dsT,
                       float* __restrict__ dv, int L, int H) {
  __shared__ float sr[CH][HD], sk[CH][HD], sw[CH][HD], sdy[CH][HD], su[HD];
  const Dims d = dims_of<HD>(L, H);
  const int j = threadIdx.x;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  float G[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) G[i] = dsT[st + i * HD + j];
  su[j] = u[(blockIdx.x % H) * HD + j];
  for (int t0 = ((L - 1) / CH) * CH; t0 >= 0; t0 -= CH) {
    const int n = min(CH, L - t0);
    __syncthreads();
    stage<HD>(sr, r, d, t0, n);
    stage<HD>(sk, k, d, t0, n);
    stage<HD, true>(sw, logw, d, t0, n);
    stage<HD>(sdy, dy, d, t0, n);
    __syncthreads();
    for (int c = n - 1; c >= 0; --c) {
      const float dyj = sdy[c][j];
      float gk = 0.f, ruk = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float ri = sr[c][i], ki = sk[c][i];
        gk = fmaf(G[i], ki, gk);
        ruk = fmaf(ri * su[i], ki, ruk);
        G[i] = fmaf(sw[c][i], G[i], ri * dyj);
      }
      dv[d.base + (size_t)(t0 + c) * d.row + j] = fmaf(ruk, dyj, gk);
    }
  }
}

// du[h, i] = sum over b, in order, of du_part[b, h, i]. One block per head.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                                   int B, int H, int hd) {
  const int h = blockIdx.x, i = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[((size_t)b * H + h) * hd + i];
  du[(size_t)h * hd + i] = s;
}

}  // namespace

// head_dim: 16, 32 or 64. Every tensor is fp32 and contiguous; the caller
// checks shapes. Each launch goes on the given stream; returns a cudaError_t.
#define WKV_DISPATCH(KERNEL, ...)                                            \
  do {                                                                       \
    const dim3 grid(B * H);                                                  \
    switch (head_dim) {                                                      \
      case 16: KERNEL<16><<<grid, 16, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
      case 32: KERNEL<32><<<grid, 32, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
      case 64: KERNEL<64><<<grid, 64, 0, (cudaStream_t)stream>>>(__VA_ARGS__); break; \
      default: return (int)cudaErrorInvalidValue;                            \
    }                                                                        \
    return (int)cudaGetLastError();                                          \
  } while (0)

#define RD(p) ((const float*)(p))
#define WR(p) ((float*)(p))

extern "C" {

int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw, const void* u,
             const void* s0, void* y, void* sT, int B, int L, int H, int head_dim,
             void* stream) {
  WKV_DISPATCH(wkv6_fwd_kernel, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(s0), WR(y), WR(sT), L, H);
}

int wkv6_bwd_dr(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, const void* dy, const void* dsT, void* dr, void* a,
                void* du_part, int B, int L, int H, int head_dim, void* stream) {
  WKV_DISPATCH(wkv6_bwd_dr_kernel, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(s0), RD(dy), RD(dsT),
               WR(dr), WR(a), WR(du_part), L, H);
}

int wkv6_bwd_dk(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* dy, const void* dsT, const void* a, void* dk, void* dlogw, void* ds0,
                int B, int L, int H, int head_dim, void* stream) {
  WKV_DISPATCH(wkv6_bwd_dk_kernel, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(dy), RD(dsT), RD(a),
               WR(dk), WR(dlogw), WR(ds0), L, H);
}

int wkv6_bwd_dv(const void* r, const void* k, const void* logw, const void* u, const void* dy,
                const void* dsT, void* dv, int B, int L, int H, int head_dim, void* stream) {
  WKV_DISPATCH(wkv6_bwd_dv_kernel, RD(r), RD(k), RD(logw), RD(u), RD(dy), RD(dsT), WR(dv), L, H);
}

int wkv6_bwd_du(const void* du_part, void* du, int B, int H, int head_dim, void* stream) {
  if (head_dim < 1 || head_dim > 1024) return (int)cudaErrorInvalidValue;
  wkv6_bwd_du_kernel<<<H, head_dim, 0, (cudaStream_t)stream>>>(RD(du_part), WR(du), B, H,
                                                               head_dim);
  return (int)cudaGetLastError();
}

const char* wkv6_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
