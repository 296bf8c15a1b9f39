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
// the RWKV project's own CUDA kernels do, with the hd x hd fp32 state in
// registers and nothing stored per step. Each output has one owning thread,
// so no kernel needs atomics and two runs give the same bits.
//
// The forward (wkv6_fwd_kernel) spreads the state over 128 threads at
// hd = 64: column j of S evolves alone, S_t[:, j] = w_t . S_{t-1}[:, j] +
// k_t v_tj, and y_tj = sum_i r_ti S_{t-1}[i, j] + (sum_i r_ti u_i k_ti) v_tj,
// so R = 4 threads share a column pair (NC = 2), each keeping 16 of its rows
// (32 registers), and close y_tj with two xor-shuffles. The per-step sum
// sum_i r_i u_i k_i is formed once, while staging, which leaves 3 operations
// per (i, j) a step. A thread reads its rows of r, k and w as float4
// broadcasts (12 LDS.128 and 3 LDS a step for 96 FP operations); its rows
// are the chunks q R + g, so the R lanes of a column read neighbouring
// chunks in different banks (16 contiguous rows a thread put lanes g and
// g + 2 in the same banks, and ran 1.8 times slower). Stages of CH = 16 steps are
// double-buffered with cp.async (16-byte chunks), or stored by the threads
// where a tensor does not start on a 16-byte boundary; after the wait each
// thread takes exp of the logw it staged and adds its share of the u sum, so
// one block barrier a chunk suffices. The step loop is unrolled 8 times, so
// that later steps' loads and FMAs can issue while a step's shuffles are in
// flight (unrolled 2, 4, 8 times: 0.223, 0.175, 0.167 ms at B = 4).
// ptxas (sm_90a, hd = 64): 96 registers, no spills; 33 KB of shared memory,
// 128 threads a block.
//
// The backward kernels keep the first design: hd threads a block, each
// thread one column (wkv6_bwd_dv) or one row (wkv6_bwd_dr, wkv6_bwd_dk) of
// the state or its gradient, CH steps staged by the threads between two
// barriers, and the step loop reading them as scalar broadcasts. du sums
// per-(b, h) partials that wkv6_bwd_dr writes, over b in a fixed order, in
// wkv6_bwd_du.
//
// What bounds it on an H100: the work is ~5 hd^2 flops per (token, head), so
// at hd = 64 one [B, L, H, hd] fp32 tensor (4 bytes a value) carries 80
// flops per value, 20 per byte: about the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). Both bounds are near 0.1 ms at B = 8, H = 32, L = 1024.
// The forward takes 0.29 ms there and 0.17 ms at B = 4 (NVIDIA H100 80GB
// HBM3, 700 W; tools/torch_kernel_bench.py): it is bound by instruction
// issue and latency, not bytes. At B = 4 (128 blocks, 4 warps an SM) the
// step loop's in-order chain of loads, FMAs and two shuffles a step leaves
// most issue slots empty; twice the blocks (B = 8, 8 warps an SM) take 1.7
// times as long. Closing the y sums once per stage instead of every step
// (more registers, a longer body), stages of 32 steps, and 64-thread blocks
// (4 columns a thread, or R = 2) were measured and are slower at B = 4. The
// backward
// kernels (one thread, hd-term sums) are the next to redesign.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;     // time steps the backward kernels stage at once

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

// Forward layout: R threads share each column of S. Thread t keeps columns
// NC (t / R) .. NC (t / R) + NC - 1 of the rows of chunks q R + t % R
// (rows 4 (q R + t % R) .. + 3, q < NR / 4), so a step's hd-term sum for y_j
// is split R ways and closed by log2(R) xor-shuffles over adjacent lanes.
// The R lanes of a column read R neighbouring chunks of a staged row, which
// lie in different banks. A stage holds CH steps of r, k,
// v and w, and sum_i r_i u_i k_i of each step; a thread stages NCP 16-byte
// chunks of each tensor, always at the same offset x of a row.
template <int HD>
struct FwdCfg {
  static constexpr int R = 4;               // threads per column
  static constexpr int NC = 2;              // columns of a thread
  static constexpr int NR = HD / R;         // rows of a thread
  static constexpr int NT = HD / NC * R;    // threads of a block
  static constexpr int C4 = HD / 4;         // 16-byte chunks in a row of hd floats
  static constexpr int CH = 16;             // steps a stage holds
  static constexpr int NCP = CH * C4 / NT;  // chunks of each tensor a thread stages
  static constexpr int PLANE = CH * HD;     // floats of one tensor in a stage
  static constexpr int STAGE = 4 * PLANE + CH;
  static_assert(NR % 4 == 0 && NCP >= 1 && CH * C4 % NT == 0 && NT % C4 == 0 && C4 <= 32,
                "every thread stages whole chunks at one offset, and its rows are whole chunks");
};

template <int HD>
constexpr size_t fwd_smem() { return sizeof(float) * 2 * FwdCfg<HD>::STAGE; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Forward. Steps of chunk n + 1 load (cp.async, or the threads' own loads
// where a tensor does not start on a 16-byte boundary) while chunk n
// computes; after the wait each thread turns the logw it staged into w and
// adds its share of sum_i r_i u_i k_i, so that y_j = sum_i r_i S_ij +
// (sum_i r_i u_i k_i) v_j costs 3 operations per (i, j) in the step loop.
template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::NT)
    wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sT, int L, int H, int async_ok) {
  using C = FwdCfg<HD>;
  constexpr int R = C::R, NC = C::NC, NR = C::NR, NT = C::NT, C4 = C::C4, CH = C::CH;
  constexpr int PLANE = C::PLANE, STAGE = C::STAGE;
  extern __shared__ float4 wkv_stages[];
  // 2 stages of r, k, v, w [CH][HD] and ruk [CH]
  float* stages = reinterpret_cast<float*>(wkv_stages);
  const Dims d = dims_of<HD>(L, H);
  const int tid = threadIdx.x, g = tid % R, j0 = tid / R * NC;
  const int x = 4 * (tid % C4);
  const size_t st = (size_t)blockIdx.x * HD * HD;
  const float* uh = u + (size_t)(blockIdx.x % H) * HD + x;
  const float u0 = uh[0], u1 = uh[1], u2 = uh[2], u3 = uh[3];

  auto issue = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      if (t0 + c >= L) continue;
      const size_t off = d.base + (size_t)(t0 + c) * d.row + x;
      float* dst = sg + c * HD + x;
      const float* src[4] = {r + off, k + off, v + off, logw + off};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (async_ok) cp_async16(dst + p * PLANE, src[p]);
        else
          *reinterpret_cast<float4*>(dst + p * PLANE) =
              make_float4(src[p][0], src[p][1], src[p][2], src[p][3]);
      }
    }
  };
  // on the chunks this thread staged: w = exp(logw), and the ruk sums over
  // the C4 lanes that staged one step
  auto prepare = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      float part = 0.f;
      if (t0 + c < L) {
        float* at = sg + c * HD + x;
        const float4 r4 = *reinterpret_cast<const float4*>(at);
        const float4 k4 = *reinterpret_cast<const float4*>(at + PLANE);
        float4& w4 = *reinterpret_cast<float4*>(at + 3 * PLANE);
        w4 = make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w));
        part = fmaf(r4.x * u0, k4.x,
                    fmaf(r4.y * u1, k4.y, fmaf(r4.z * u2, k4.z, r4.w * u3 * k4.w)));
      }
#pragma unroll
      for (int o = 1; o < C4; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (x == 0) sg[4 * PLANE + c] = part;
    }
  };

  float S[NR][NC];
  // row of S[a]: element a % 4 of chunk (a / 4) R + g
  auto row = [&](int a) { return 4 * ((a >> 2) * R + g) + (a & 3); };
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) S[a][cc] = s0[st + (size_t)row(a) * HD + j0 + cc];

  const int n_chunks = (L + CH - 1) / CH;
  issue(0, stages);
  cp_async_commit();
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * CH, nc = min(CH, L - t0);
    float* sg = stages + (n & 1) * STAGE;
    cp_async_wait_all();
    prepare(t0, sg);
    __syncthreads();  // chunk n is staged for all; every thread is done with chunk n - 1
    if (n + 1 < n_chunks) issue(t0 + CH, stages + ((n + 1) & 1) * STAGE);
    cp_async_commit();
    const float* sr = sg;
    const float* sk = sg + PLANE;
    const float* sv = sg + 2 * PLANE;
    const float* sw = sg + 3 * PLANE;
    const float* ruk = sg + 4 * PLANE;
#pragma unroll 8
    for (int c = 0; c < nc; ++c) {
      float rr[NR], kk[NR], ww[NR], vv[NC];
#pragma unroll
      for (int q = 0; q < NR / 4; ++q) {
        const int at = c * HD + 4 * (q * R + g);
        const float4 a = *reinterpret_cast<const float4*>(sr + at);
        const float4 b = *reinterpret_cast<const float4*>(sk + at);
        const float4 e = *reinterpret_cast<const float4*>(sw + at);
        rr[4 * q] = a.x, rr[4 * q + 1] = a.y, rr[4 * q + 2] = a.z, rr[4 * q + 3] = a.w;
        kk[4 * q] = b.x, kk[4 * q + 1] = b.y, kk[4 * q + 2] = b.z, kk[4 * q + 3] = b.w;
        ww[4 * q] = e.x, ww[4 * q + 1] = e.y, ww[4 * q + 2] = e.z, ww[4 * q + 3] = e.w;
      }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vv[cc] = sv[c * HD + j0 + cc];
      const float rk = ruk[c];
      const size_t yo = d.base + (size_t)(t0 + c) * d.row + j0;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float ya = 0.f, yb = 0.f;  // two chains of NR / 2
#pragma unroll
        for (int a = 0; a < NR; a += 2) {
          ya = fmaf(rr[a], S[a][cc], ya);
          yb = fmaf(rr[a + 1], S[a + 1][cc], yb);
          S[a][cc] = fmaf(ww[a], S[a][cc], kk[a] * vv[cc]);
          S[a + 1][cc] = fmaf(ww[a + 1], S[a + 1][cc], kk[a + 1] * vv[cc]);
        }
        float yj = ya + yb;
#pragma unroll
        for (int o = 1; o < R; o <<= 1) yj += __shfl_xor_sync(0xffffffffu, yj, o);
        if (g == cc % R) y[yo + cc] = fmaf(rk, vv[cc], yj);
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) sT[st + (size_t)row(a) * HD + j0 + cc] = S[a][cc];
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

template <int HD>
int fwd(const float* r, const float* k, const float* v, const float* logw, const float* u,
        const float* s0, float* y, float* sT, int B, int L, int H, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  // cp.async copies 16-byte chunks: the staged tensors must start on a
  // 16-byte boundary (rows of hd floats then do too)
  const uintptr_t any = (uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)logw;
  wkv6_fwd_kernel<HD><<<B * H, FwdCfg<HD>::NT, fwd_smem<HD>(), st>>>(
      r, k, v, logw, u, s0, y, sT, L, H, (any & 15) == 0);
  return (int)cudaGetLastError();
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
#define WKV_FWD(HD) \
  fwd<HD>(RD(r), RD(k), RD(v), RD(logw), RD(u), RD(s0), WR(y), WR(sT), B, L, H, (cudaStream_t)stream)
  switch (head_dim) {
    case 16: return WKV_FWD(16);
    case 32: return WKV_FWD(32);
    case 64: return WKV_FWD(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WKV_FWD
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

// Blocks of wkv6_fwd_kernel that fit on one SM at once at head_dim 64 (the
// rwkv6 path).
int wkv6_fwd_blocks_per_sm(int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(wkv6_fwd_kernel<64>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)fwd_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv6_fwd_kernel<64>,
                                                      FwdCfg<64>::NT, fwd_smem<64>());
  return (int)e;
}

}  // extern "C"
