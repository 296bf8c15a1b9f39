// RWKV6 WKV recurrence for Hopper (sm_90a): the forward and its backward as
// three kernels (dr; dk with dlogw, ds0 and du; dv). fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/rwkv/kernel.py, wkv6_bhld (pallas_call body
// _wkv6_kernel), the TPU WKV6 forward, wrapped by rwkv/ops.py: wkv6. The
// reference has no backward kernel; the backward here computes the gradient
// of the same recurrence (held against jax.vjp of
// src/repro/models/ssm.py: wkv6_scan in the tests).
//
// What it computes, per (b, h), with w_t = exp(logw_t):   y_t = r_t^T (S_{t-1}
// + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T, S_0 = s0, and the
// final state sT = S_L. Every tensor is fp32 and contiguous, in the model's
// layout: r, k, v, logw, y [B, L, H, hd]; u [H, hd]; states [B, H, hd, hd] with
// S[i][j] at i * hd + j (i indexes k, j indexes v). Any L >= 1 works: nothing
// is padded.
//
// The backward, with G_t the gradient with respect to S_t (G_L = dsT) and
// G_{t-1} = diag(w_t) G_t + r_t dy_t^T:   dr_t = S_{t-1} dy_t + u . k_t (v_t .
// dy_t)   dk_t = G_t v_t + u . r_t (v_t . dy_t)   dv_t = G_t^T k_t + (sum_i
// r_ti u_i k_ti) dy_t   du   = sum_{b,t} r_t . k_t (v_t . dy_t),   ds0 = G_0
// dlogw_t = w_t . rowsum(G_t . S_{t-1}) = sum_{m >= t} a_m - sum_{t <= m < L}
// b_m with a_m = r_{m+1} . w_m . (S_{m-1} dy_{m+1}) for m < L, a_L = w_L .
// rowsum(dsT . S_{L-1}), and b_m = k_m . w_{m+1} . (G_{m+1} v_m). This holds
// because dlogw_t - dlogw_{t+1} = a_t - b_t: expanding S_t and G_t by one step,
// the two products of S_t with r_{t+1} dy_{t+1}^T and of G_t with k_t v_t^T
// share the term r_{t+1} k_t (v_t . dy_{t+1}), which cancels. It is left out of
// a and b, not subtracted: it carries no decay, so where w is small it is far
// larger than dlogw, and subtracting it in fp32 would leave its rounding error
// in dlogw. So dlogw is a reverse cumulative sum of terms that the dr and dk
// scans form beside their own sums, and no kernel stores a state per step.
//
// Design. The recurrence is serial in t, so each block owns one (b, h) and
// loops over t itself (the TPU's sequential chunk axis becomes that loop), as
// the RWKV project's own CUDA kernels do, with the hd x hd fp32 state in
// registers and nothing stored per step. Each output has one owning thread,
// so no kernel needs atomics and two runs give the same bits.
//
// The forward (wkv6_fwd_kernel) and dv (wkv6_bwd_dv_kernel) run one column scan
// (col_scan), forward in t and in reverse. The forward spreads the state over
// 128 threads at hd = 64: column j of S evolves alone, S_t[:, j] = w_t .
// S_{t-1}[:, j] + k_t v_tj, and y_tj = sum_i r_ti S_{t-1}[i, j] + (sum_i r_ti
// u_i k_ti) v_tj, so R = 4 threads share a column pair (NC = 2), each keeping
// 16 of its rows (32 registers), and close y_tj with two xor-shuffles. The
// per-step sum sum_i r_i u_i k_i is formed once, while staging, which leaves 3
// operations per (i, j) a step. A thread reads its rows of r, k and w as float4
// broadcasts (12 LDS.128 and 3 LDS a step for 96 FP operations); its rows are
// the chunks q R + g, so the R lanes of a column read neighbouring chunks in
// different banks (16 contiguous rows a thread put lanes g and g + 2 in the
// same banks, and ran 1.8 times slower). Stages of CH = 16 steps are
// double-buffered with cp.async (16-byte chunks), or stored by the threads
// where a tensor does not start on a 16-byte boundary; after the wait each
// thread takes exp of the logw it staged and adds its share of the u sum, so
// one block barrier a chunk suffices. The step loop is unrolled 8 times, so
// that later steps' loads and FMAs can issue while a step's shuffles are in
// flight (unrolled 2, 4, 8 times: 0.223, 0.175, 0.167 ms at B = 4). ptxas
// (sm_90a, hd = 64): 96 registers, no spills; 33 KB of shared memory, 128
// threads a block.
//
// The two backward scans (wkv6_bwd_dr_kernel, wkv6_bwd_dk_kernel) use the
// forward's plan transposed: row i of S (or G) evolves alone, S_t[i, :] =
// w_ti S_{t-1}[i, :] + k_ti v_t, so R lanes share a group of R / 2 rows
// (R = 4 in dr, 2 in dk; 128 threads at hd = 64), each keeping hd / R
// columns of them in the interleaved chunks q R + g. A step forms two
// hd-term sums per row, dr S_{t-1} dy_t and S_{t-1} dy_{t+1} (dsT after the
// last step), dk G_t v_t and G_t v_{t-1}, closed by one reduce-scatter of
// R - 1 shuffles that leaves each lane one sum, which it stores; v_t . dy_t
// is formed once while staging (each stager's share closed by a shuffle
// tree), so a step costs 4 operations per (i, j). The neighbour step's row
// is staged beside each stage (dr's dy and r one step ahead, dk's v one
// step behind), so no step reads the stage still loading. Stages of CH = 16
// steps are double-buffered with cp.async (42 and 49 KB of dynamic shared
// memory), the step loop is unrolled 8 times, and its body has no branch:
// every lane forms both outputs and stores one through a selected pointer
// (with dk's dlogw sum in a branch on half the lanes, dk took 0.362 ms
// against 0.306 at B = 8 with R = 4). ptxas (sm_90a, hd = 64): dr 128 and
// dk 140 registers, no spills, 4 and 3 blocks an SM fit.
//
// dv has the forward's shape with column j of G in place of column j of S:
// G_{t-1}[:, j] = w_t . G_t[:, j] + r_t dy_tj and dv_tj = k_t . G_t[:, j] +
// (sum_i r_ti u_i k_ti) dy_tj, so wkv6_bwd_dv_kernel is col_scan with the
// roles renamed (k read, r written, dy the column values, dsT the start)
// and run from t = L - 1 down: stages are issued from the last chunk back,
// the ragged chunk first, and each stage's steps run backwards. It stores
// no final state (G_0 is ds0, which dk writes). du needs no kernel of its
// own: wkv6_bwd_dr writes a partial per (b, h), and the blocks of b = 0 of
// wkv6_bwd_dk, which runs after dr on the same stream, sum them over b in
// a fixed order after their scan. ptxas (sm_90a, hd = 64): dv 113
// registers, no spills, 4 blocks an SM fit.
//
// What bounds them on an H100: the work is ~5 hd^2 flops per (token, head), so
// at hd = 64 one [B, L, H, hd] fp32 tensor (4 bytes a value) carries 80 flops
// per value, 20 per byte: about the fp32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20). At B = 8, H = 32, L = 1024 the operations take 0.080 ms and the bytes
// 0.103 (forward: 5 tensors), 0.143 (dr: 7), 0.163 (dk: 8) and 0.101 ms (dv:
// 5), so bytes bound all four. They take 0.29, 0.28, 0.29 and 0.29 ms there and
// 0.17, 0.18, 0.19 and 0.18 ms at B = 4 (NVIDIA H100 80GB HBM3, 700 W;
// tools/torch_kernel_bench.py): bound by instruction issue and latency, not
// bytes. At B = 4 (128 blocks, 4 warps an SM) each step's in-order chain of
// loads, FMAs and shuffles leaves most issue slots empty; twice the blocks (B =
// 8, 8 warps an SM) take 1.5-1.75 times as long. Closing the forward's y sums
// once per stage instead of every step (more registers, a longer body), stages
// of 32 steps, and 64-thread blocks (4 columns a thread, or R = 2) were
// measured and are slower at B = 4; for the backward scans, R = 8 and 4 chains
// per sum are slower, and 32-step stages or unrolling 4 within 3 %. For
// col_scan on today's body, R = 2 takes 0.35 ms at both B for the forward and
// dv, and 32-step stages are within 3 % (dv 0.290 and 0.173 ms against 0.289
// and 0.177) at twice the shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

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

// One 16-byte chunk into shared memory: cp.async, or the thread's own loads
// where the tensor does not start on a 16-byte boundary.
__device__ __forceinline__ void stage16(float* dst, const float* src, int async_ok) {
  if (async_ok) cp_async16(dst, src);
  else *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// The column scan of the forward's plan, shared by wkv6_fwd_kernel and
// wkv6_bwd_dv_kernel. In the forward's roles, per column j and step t:
// y_tj = sum_i r_ti S[i, j] + (sum_i r_ti u_i k_ti) v_tj, read before the
// update S[:, j] = w_t . S[:, j] + k_t v_tj; S starts at s0, and the state
// after the last step is stored in sT. The forward runs t = 0 .. L - 1.
// With REV it runs t = L - 1 .. 0 and stores no final state: that is dv's
// scan of G with k in r's place, r in k's place, dy in v's place and dsT in
// s0's (the u sum is symmetric in r and k). Chunks load (cp.async, or the
// threads' own loads where a tensor does not start on a 16-byte boundary)
// one ahead in the order of the scan, so in reverse the ragged last chunk
// is staged and scanned first; after the wait each thread turns the logw it
// staged into w and adds its share of the u sum, so that a step costs 3
// operations per (i, j).
template <int HD, bool REV>
__device__ __forceinline__ void col_scan(const float* __restrict__ r, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ logw,
                                         const float* __restrict__ u,
                                         const float* __restrict__ s0, float* __restrict__ y,
                                         float* __restrict__ sT, int L, int H, int async_ok) {
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
      for (int p = 0; p < 4; ++p) stage16(dst + p * PLANE, src[p], async_ok);
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
  // the chunk that the it-th stage holds, in the order of the scan
  auto chunk = [&](int it) { return REV ? n_chunks - 1 - it : it; };
  issue(chunk(0) * CH, stages);
  cp_async_commit();
  for (int it = 0; it < n_chunks; ++it) {
    const int t0 = chunk(it) * CH, nc = min(CH, L - t0);
    float* sg = stages + (it & 1) * STAGE;
    cp_async_wait_all();
    prepare(t0, sg);
    __syncthreads();  // this chunk is staged for all; every thread is done with the last
    if (it + 1 < n_chunks) issue(chunk(it + 1) * CH, stages + ((it + 1) & 1) * STAGE);
    cp_async_commit();
    const float* sr = sg;
    const float* sk = sg + PLANE;
    const float* sv = sg + 2 * PLANE;
    const float* sw = sg + 3 * PLANE;
    const float* ruk = sg + 4 * PLANE;
#pragma unroll 8
    for (int s = 0; s < nc; ++s) {
      const int c = REV ? nc - 1 - s : s;
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
  if constexpr (!REV) {
#pragma unroll
    for (int a = 0; a < NR; ++a)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) sT[st + (size_t)row(a) * HD + j0 + cc] = S[a][cc];
  }
}

// Forward: y and the final state sT from s0.
template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::NT)
    wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sT, int L, int H, int async_ok) {
  col_scan<HD, false>(r, k, v, logw, u, s0, y, sT, L, H, async_ok);
}

// dv: the forward's scan in reverse from G_L = dsT, with k read against the
// state, r written into it and dy as its column values:
// dv_tj = sum_i k_ti G_t[i, j] + (sum_i r_ti u_i k_ti) dy_tj, then
// G_{t-1}[:, j] = w_t . G_t[:, j] + r_t dy_tj. G_0 is ds0, which dk writes.
template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::NT)
    wkv6_bwd_dv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ logw, const float* __restrict__ u,
                       const float* __restrict__ dy, const float* __restrict__ dsT,
                       float* __restrict__ dv, int L, int H, int async_ok) {
  col_scan<HD, true>(k, r, dy, logw, u, dsT, dv, nullptr, L, H, async_ok);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// Layout of the backward scans (wkv6_bwd_dr, wkv6_bwd_dk): the forward's,
// transposed. Row i of S (or of G) evolves alone, so R threads share a
// group of NR = R / 2 rows: lane g = t % R keeps columns 4 (q R + g) .. + 3
// (q < NQ) of rows NR (t / R) .. + NR - 1, and the R lanes of a row read
// neighbouring chunks of a staged row, in different banks. A step forms two
// hd-term sums per row, 2 NR = R partial sums a thread; one reduce-scatter
// over the R lanes (R - 1 shuffles) leaves lane g with the whole of sum
// g / NR of row g % NR, and that lane writes its output. A stage holds CH
// steps of each tensor, the step-ahead (dr) or step-behind (dk) row of the
// tensors read one step away, and v_t . dy_t of each step.
template <int HD, int LANES>
struct BwdCfg {
  static constexpr int R = LANES;              // threads per row group
  static constexpr int NR = R / 2;             // rows of a thread
  static constexpr int NCH = 2;                // FMA chains of each sum
  static constexpr int NQ = HD / 4 / R;        // 16-byte chunks of a row a thread keeps
  static constexpr int NT = HD / NR * R;       // threads of a block
  static constexpr int C4 = HD / 4;            // 16-byte chunks in a row of hd floats
  static constexpr int CH = 16;                // steps a stage holds
  static constexpr int NCP = CH * C4 / NT;     // chunks of each tensor a thread stages
  static constexpr int PLANE = CH * HD;        // floats of one tensor in a stage
  static constexpr int PLANE1 = PLANE + HD;    // the same with a neighbour step's row
  // dr's stage: r and dy with the step-ahead row CH, k, v, w, v . dy
  static constexpr int DR_R = 0, DR_DY = PLANE1, DR_K = 2 * PLANE1, DR_V = DR_K + PLANE,
                       DR_W = DR_V + PLANE, DR_VDY = DR_W + PLANE, DR_STAGE = DR_VDY + CH;
  // dk's stage: r, k, w, dy, a, v with the step-behind row first, v . dy
  static constexpr int DK_R = 0, DK_K = PLANE, DK_W = 2 * PLANE, DK_DY = 3 * PLANE,
                       DK_A = 4 * PLANE, DK_V = 5 * PLANE, DK_VDY = DK_V + PLANE1,
                       DK_STAGE = DK_VDY + CH;
  static_assert(R == 2 * NR && NQ >= 1 && 4 * NQ % NCH == 0 && NT >= 32 && NCP >= 1 &&
                    CH * C4 % NT == 0 && NT % C4 == 0 && C4 <= 32 && CH % 4 == 0,
                "a lane closes one of the 2 NR sums; whole warps; every thread stages "
                "whole chunks at one offset; stages stay 16-byte aligned");
};

// lanes per row group of each scan: R = 2 was 1-6 % slower in dr, R = 4 2-4 %
// slower in dk (tools/torch_kernel_bench.py)
constexpr int DR_LANES = 4, DK_LANES = 2;
template <int HD>
using DrCfg = BwdCfg<HD, DR_LANES>;
template <int HD>
using DkCfg = BwdCfg<HD, DK_LANES>;
template <int HD>
constexpr size_t dr_smem() { return sizeof(float) * 2 * DrCfg<HD>::DR_STAGE; }
template <int HD>
constexpr size_t dk_smem() { return sizeof(float) * 2 * DkCfg<HD>::DK_STAGE; }

// The N lanes g = t % N of a row group each hold partial sums x[0 .. N).
// Returns to lane g the whole of x[g]: at each level a lane keeps the half
// of its sums whose index has the lane's bit and hands over the other half,
// so N - 1 shuffles in all, summed in the same order on every run.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&x)[N], int g) {
#pragma unroll
  for (int n = N, o = 1; n > 1; n >>= 1, o <<= 1) {
    const bool hi = g & o;
#pragma unroll
    for (int m = 0; m < n / 2; ++m)
      x[m] = (hi ? x[2 * m + 1] : x[2 * m]) +
             __shfl_xor_sync(0xffffffffu, hi ? x[2 * m] : x[2 * m + 1], o);
  }
  return x[0];
}

// One row x of the state in one step: x . a and x . b, each in NCH chains
// added in a fixed order, and the update x = w x + s c.
template <int NJ, int NCH>
__device__ __forceinline__ void row_step(float (&x)[NJ], const float (&a)[NJ],
                                         const float (&b)[NJ], const float (&c)[NJ], float w,
                                         float s, float& xa, float& xb) {
  float pa[NCH], pb[NCH];
#pragma unroll
  for (int e = 0; e < NCH; ++e) pa[e] = pb[e] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; j += NCH)
#pragma unroll
    for (int e = 0; e < NCH; ++e) {
      pa[e] = fmaf(x[j + e], a[j + e], pa[e]);
      pb[e] = fmaf(x[j + e], b[j + e], pb[e]);
      x[j + e] = fmaf(w, x[j + e], s * c[j + e]);
    }
#pragma unroll
  for (int n = NCH; n > 1; n >>= 1)
#pragma unroll
    for (int e = 0; e < n / 2; ++e) pa[e] += pa[e + n / 2], pb[e] += pb[e + n / 2];
  xa = pa[0], xb = pb[0];
}

// Shared loads of the row-group scalars and column chunks a lane reads.
template <class C>
struct BwdLane {
  static constexpr int HD = C::C4 * 4;
  int g, i0;
  // rows i0 .. i0 + NR - 1 of staged row c
  __device__ __forceinline__ void rows(float (&out)[C::NR], const float* plane, int c) const {
    const float* p = plane + c * HD + i0;
    if constexpr (C::NR % 2 == 0) {
#pragma unroll
      for (int q = 0; q < C::NR / 2; ++q) {
        const float2 f = ld2(p + 2 * q);
        out[2 * q] = f.x, out[2 * q + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::NR; ++i) out[i] = p[i];
    }
  }
  // of one value per row of the group, the one of the row this lane closes
  __device__ __forceinline__ float mine(const float (&x)[C::NR]) const {
    float m = x[0];
#pragma unroll
    for (int i = 1; i < C::NR; ++i) m = g % C::NR == i ? x[i] : m;
    return m;
  }
  // columns 4 (q R + g) .. + 3 of staged row c, q < NQ
  __device__ __forceinline__ void cols(float (&out)[4 * C::NQ], const float* plane,
                                       int c) const {
#pragma unroll
    for (int q = 0; q < C::NQ; ++q) {
      const float4 f = ld4(plane + c * HD + 4 * (q * C::R + g));
      out[4 * q] = f.x, out[4 * q + 1] = f.y, out[4 * q + 2] = f.z, out[4 * q + 3] = f.w;
    }
  }
  __device__ __forceinline__ int col(int j) const {
    return 4 * ((j >> 2) * C::R + g) + (j & 3);
  }
};

// dr, the a terms of dlogw and the (b, h) partial of du: the forward scan of
// S again, by rows. Per row i and step t it forms sdot = S_{t-1}[i,:] . dy_t
// and snext = S_{t-1}[i,:] . dy_{t+1} (. dsT[i,:] at the last step); with
// v_t . dy_t staged that leaves 4 operations per (i, j) a step. r and dy are
// staged with the first row of the next stage as row CH, so that a step
// never reads the stage that is still loading.
template <int HD>
__global__ void __launch_bounds__(DrCfg<HD>::NT)
    wkv6_bwd_dr_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ logw,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       const float* __restrict__ dy, const float* __restrict__ dsT,
                       float* __restrict__ dr, float* __restrict__ a,
                       float* __restrict__ du_part, int L, int H, int async_ok) {
  using C = DrCfg<HD>;
  constexpr int NR = C::NR, NQ = C::NQ, NT = C::NT, C4 = C::C4, CH = C::CH;
  constexpr int NJ = 4 * NQ, STAGE = C::DR_STAGE;
  extern __shared__ float4 wkv_stages[];
  float* stages = reinterpret_cast<float*>(wkv_stages);
  const Dims d = dims_of<HD>(L, H);
  const int tid = threadIdx.x, x = 4 * (tid % C4);
  const BwdLane<C> ln{tid % C::R, NR * (tid / C::R)};
  const bool second = ln.g >= NR;  // this lane closes sum g / NR of row g % NR
  const int row = ln.i0 + ln.g % NR;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  const float u_row = u[(size_t)(blockIdx.x % H) * HD + row];

  auto issue = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      if (t0 + c >= L) continue;
      const size_t off = d.base + (size_t)(t0 + c) * d.row + x;
      stage16(sg + C::DR_R + c * HD + x, r + off, async_ok);
      stage16(sg + C::DR_DY + c * HD + x, dy + off, async_ok);
      stage16(sg + C::DR_K + c * HD + x, k + off, async_ok);
      stage16(sg + C::DR_V + c * HD + x, v + off, async_ok);
      stage16(sg + C::DR_W + c * HD + x, logw + off, async_ok);
    }
    if (tid < C4 && t0 + CH < L) {  // the step-ahead row
      const size_t off = d.base + (size_t)(t0 + CH) * d.row + x;
      stage16(sg + C::DR_R + CH * HD + x, r + off, async_ok);
      stage16(sg + C::DR_DY + CH * HD + x, dy + off, async_ok);
    }
  };
  // on the chunks this thread staged: w = exp(logw), and v . dy summed over
  // the C4 lanes that staged one step
  auto prepare = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      float part = 0.f;
      if (t0 + c < L) {
        const float4 v4 = ld4(sg + C::DR_V + c * HD + x), y4 = ld4(sg + C::DR_DY + c * HD + x);
        float4& w4 = *reinterpret_cast<float4*>(sg + C::DR_W + c * HD + x);
        w4 = make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w));
        part = fmaf(v4.x, y4.x, fmaf(v4.y, y4.y, fmaf(v4.z, y4.z, v4.w * y4.w)));
      }
#pragma unroll
      for (int o = 1; o < C4; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (x == 0) sg[C::DR_VDY + c] = part;
    }
  };

  float S[NR][NJ];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) S[i][j] = s0[st + (size_t)(ln.i0 + i) * HD + ln.col(j)];
  float dui = 0.f;

  // step t = t0 + c of the stage at sg; the last step of the scan takes dsT
  // for the step-ahead dy
  auto step = [&](const float* sg, int c, int t, bool last) {
    float dyc[NJ], vc[NJ], nx[NR][NJ];
    ln.cols(dyc, sg + C::DR_DY, c);
    ln.cols(vc, sg + C::DR_V, c);
    if (!last) {
      ln.cols(nx[0], sg + C::DR_DY, c + 1);
#pragma unroll
      for (int i = 1; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) nx[i][j] = nx[0][j];
    } else {
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) nx[i][j] = dsT[st + (size_t)(ln.i0 + i) * HD + ln.col(j)];
    }
    float kk[NR], ww[NR];
    ln.rows(kk, sg + C::DR_K, c);
    ln.rows(ww, sg + C::DR_W, c);
    float sum[2 * NR];  // sdot of each row, then snext
#pragma unroll
    for (int i = 0; i < NR; ++i)
      row_step<NJ, C::NCH>(S[i], dyc, nx[i], vc, ww[i], kk[i], sum[i], sum[NR + i]);
    const float y = reduce_scatter<2 * NR>(sum, ln.g);
    float rr[NR];
    ln.rows(rr, sg + C::DR_R, c);
    const float vdy = sg[C::DR_VDY + c];
    const float k_row = ln.mine(kk), w_row = ln.mine(ww), r_row = ln.mine(rr);
    float anext = 1.f;
    if (!last) {
      float rn[NR];
      ln.rows(rn, sg + C::DR_R, c + 1);
      anext = ln.mine(rn);
    }
    // one store a lane, no branch: the step loop stays one block of code
    (second ? a : dr)[d.base + (size_t)t * d.row + row] =
        second ? anext * w_row * y : fmaf(u_row * k_row, vdy, y);
    dui = fmaf(r_row * k_row, vdy, dui);
  };

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
    const bool tail = n + 1 == n_chunks;
    const int nmain = tail ? nc - 1 : nc;
#pragma unroll 8
    for (int c = 0; c < nmain; ++c) step(sg, c, t0 + c, false);
    if (tail) step(sg, nc - 1, L - 1, true);
  }
  cp_async_wait_all();
  if (!second) du_part[(size_t)blockIdx.x * HD + row] = dui;
}

// dk, dlogw and ds0: the reverse scan of G, by rows. Per row i and step t it
// forms gv = G_t[i,:] . v_t and gv_prev = G_t[i,:] . v_{t-1}, the b term of
// step t - 1; with v_t . dy_t staged that leaves 4 operations per (i, j) a
// step. v is staged with the last row of the previous stage (zeros before
// step 0) as row 0, so that a step never reads the stage that is still
// loading. The lane that closes gv_prev keeps dlogw's running sum. After
// the scan the blocks of b = 0 also write du[h, :], the sum of dr's
// partials du_part[b, h, :] over b = 0 .. B - 1 in that order: one thread
// an entry, its B loads issued together.
template <int HD>
__global__ void __launch_bounds__(DkCfg<HD>::NT)
    wkv6_bwd_dk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ logw,
                       const float* __restrict__ u, const float* __restrict__ dy,
                       const float* __restrict__ dsT, const float* __restrict__ a,
                       const float* __restrict__ du_part, float* __restrict__ dk,
                       float* __restrict__ dlogw, float* __restrict__ ds0,
                       float* __restrict__ du, int L, int H, int async_ok) {
  using C = DkCfg<HD>;
  constexpr int NR = C::NR, NQ = C::NQ, NT = C::NT, C4 = C::C4, CH = C::CH;
  constexpr int NJ = 4 * NQ, STAGE = C::DK_STAGE;
  extern __shared__ float4 wkv_stages[];
  float* stages = reinterpret_cast<float*>(wkv_stages);
  const Dims d = dims_of<HD>(L, H);
  const int tid = threadIdx.x, x = 4 * (tid % C4);
  const BwdLane<C> ln{tid % C::R, NR * (tid / C::R)};
  const bool second = ln.g >= NR;  // this lane closes sum g / NR of row g % NR
  const int row = ln.i0 + ln.g % NR;
  const size_t st = (size_t)blockIdx.x * HD * HD;
  const float u_row = u[(size_t)(blockIdx.x % H) * HD + row];

  auto issue = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      if (t0 + c >= L) continue;
      const size_t off = d.base + (size_t)(t0 + c) * d.row + x;
      stage16(sg + C::DK_R + c * HD + x, r + off, async_ok);
      stage16(sg + C::DK_K + c * HD + x, k + off, async_ok);
      stage16(sg + C::DK_W + c * HD + x, logw + off, async_ok);
      stage16(sg + C::DK_DY + c * HD + x, dy + off, async_ok);
      stage16(sg + C::DK_A + c * HD + x, a + off, async_ok);
      stage16(sg + C::DK_V + (c + 1) * HD + x, v + off, async_ok);
    }
    if (tid < C4) {  // the step-behind row of v
      if (t0 > 0)
        stage16(sg + C::DK_V + x, v + d.base + (size_t)(t0 - 1) * d.row + x, async_ok);
      else
        *reinterpret_cast<float4*>(sg + C::DK_V + x) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto prepare = [&](int t0, float* sg) {
#pragma unroll
    for (int m = 0; m < C::NCP; ++m) {
      const int c = (tid + NT * m) / C4;
      float part = 0.f;
      if (t0 + c < L) {
        const float4 v4 = ld4(sg + C::DK_V + (c + 1) * HD + x);
        const float4 y4 = ld4(sg + C::DK_DY + c * HD + x);
        float4& w4 = *reinterpret_cast<float4*>(sg + C::DK_W + c * HD + x);
        w4 = make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w));
        part = fmaf(v4.x, y4.x, fmaf(v4.y, y4.y, fmaf(v4.z, y4.z, v4.w * y4.w)));
      }
#pragma unroll
      for (int o = 1; o < C4; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (x == 0) sg[C::DK_VDY + c] = part;
    }
  };

  float G[NR][NJ];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) G[i][j] = dsT[st + (size_t)(ln.i0 + i) * HD + ln.col(j)];
  // dlogw_{t+1}, G_{t+1} v_t (formed at step t + 1) and w_{t+1}, of use on
  // the lanes that close gv_prev
  float acc = 0.f, gv_next = 0.f, w_next = 0.f;

  auto step = [&](const float* sg, int c, int t) {
    float vc[NJ], vp[NJ], dyc[NJ];
    ln.cols(vc, sg + C::DK_V, c + 1);
    ln.cols(vp, sg + C::DK_V, c);
    ln.cols(dyc, sg + C::DK_DY, c);
    float rr[NR], ww[NR];
    ln.rows(rr, sg + C::DK_R, c);
    ln.rows(ww, sg + C::DK_W, c);
    float sum[2 * NR];  // gv of each row, then gv_prev
#pragma unroll
    for (int i = 0; i < NR; ++i)
      row_step<NJ, C::NCH>(G[i], vc, vp, dyc, ww[i], rr[i], sum[i], sum[NR + i]);
    const float y = reduce_scatter<2 * NR>(sum, ln.g);
    float kk[NR], aa[NR];
    ln.rows(kk, sg + C::DK_K, c);
    ln.rows(aa, sg + C::DK_A, c);
    const float r_row = ln.mine(rr), w_row = ln.mine(ww), k_row = ln.mine(kk), a_row = ln.mine(aa);
    const float vdy = sg[C::DK_VDY + c];
    // every lane keeps the running sum, and the lanes that close gv_prev
    // store it: one store a lane, no branch
    acc = t == L - 1 ? a_row : acc + (a_row - k_row * w_next * gv_next);
    gv_next = y;
    w_next = w_row;
    (second ? dlogw : dk)[d.base + (size_t)t * d.row + row] =
        second ? acc : fmaf(u_row * r_row, vdy, y);
  };

  const int n_chunks = (L + CH - 1) / CH;
  issue((n_chunks - 1) * CH, stages);
  cp_async_commit();
  for (int it = 0; it < n_chunks; ++it) {
    const int t0 = (n_chunks - 1 - it) * CH, nc = min(CH, L - t0);
    float* sg = stages + (it & 1) * STAGE;
    cp_async_wait_all();
    prepare(t0, sg);
    __syncthreads();  // this chunk is staged for all; every thread is done with the last
    if (t0 > 0) issue(t0 - CH, stages + ((it + 1) & 1) * STAGE);
    cp_async_commit();
#pragma unroll 8
    for (int c = nc - 1; c >= 0; --c) step(sg, c, t0 + c);
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ds0[st + (size_t)(ln.i0 + i) * HD + ln.col(j)] = G[i][j];
  static_assert(NT >= HD, "a thread for each entry of du's row");
  if (blockIdx.x < H && tid < HD) {
    constexpr int NB = 8;  // loads in flight
    const int B = gridDim.x / H;
    const float* p = du_part + (size_t)blockIdx.x * HD + tid;
    const size_t bstride = (size_t)H * HD;
    float sum = 0.f;
    for (int b0 = 0; b0 < B; b0 += NB) {
      float part[NB];
#pragma unroll
      for (int e = 0; e < NB; ++e) part[e] = b0 + e < B ? p[(b0 + e) * bstride] : 0.f;
#pragma unroll
      for (int e = 0; e < NB; ++e) sum += part[e];
    }
    du[(size_t)blockIdx.x * HD + tid] = sum;
  }
}

// Launches a kernel that stages through cp.async: allows its dynamic shared
// memory and passes, as its last argument, whether every staged tensor
// starts on a 16-byte boundary (rows of hd floats then do too), the
// condition for cp.async's 16-byte chunks.
template <typename... P, typename... A>
int launch_staged(void (*kernel)(P...), int blocks, int threads, size_t smem, cudaStream_t st,
                  uintptr_t staged, A... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, st>>>(args..., (int)((staged & 15) == 0));
  return (int)cudaGetLastError();
}

template <int HD>
int fwd(const float* r, const float* k, const float* v, const float* logw, const float* u,
        const float* s0, float* y, float* sT, int B, int L, int H, cudaStream_t st) {
  return launch_staged(wkv6_fwd_kernel<HD>, B * H, FwdCfg<HD>::NT, fwd_smem<HD>(), st,
                       (uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)logw, r, k, v,
                       logw, u, s0, y, sT, L, H);
}

template <int HD>
int bwd_dr(const float* r, const float* k, const float* v, const float* logw, const float* u,
           const float* s0, const float* dy, const float* dsT, float* dr, float* a,
           float* du_part, int B, int L, int H, cudaStream_t st) {
  return launch_staged(
      wkv6_bwd_dr_kernel<HD>, B * H, DrCfg<HD>::NT, dr_smem<HD>(), st,
      (uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)logw | (uintptr_t)dy, r, k, v,
      logw, u, s0, dy, dsT, dr, a, du_part, L, H);
}

template <int HD>
int bwd_dk(const float* r, const float* k, const float* v, const float* logw, const float* u,
           const float* dy, const float* dsT, const float* a, const float* du_part, float* dk,
           float* dlogw, float* ds0, float* du, int B, int L, int H, cudaStream_t st) {
  return launch_staged(wkv6_bwd_dk_kernel<HD>, B * H, DkCfg<HD>::NT, dk_smem<HD>(), st,
                       (uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)logw |
                           (uintptr_t)dy | (uintptr_t)a,
                       r, k, v, logw, u, dy, dsT, a, du_part, dk, dlogw, ds0, du, L, H);
}

template <int HD>
int bwd_dv(const float* r, const float* k, const float* logw, const float* u, const float* dy,
           const float* dsT, float* dv, int B, int L, int H, cudaStream_t st) {
  return launch_staged(wkv6_bwd_dv_kernel<HD>, B * H, FwdCfg<HD>::NT, fwd_smem<HD>(), st,
                       (uintptr_t)r | (uintptr_t)k | (uintptr_t)logw | (uintptr_t)dy, r, k,
                       logw, u, dy, dsT, dv, L, H);
}

}  // namespace

#define RD(p) ((const float*)(p))
#define WR(p) ((float*)(p))

extern "C" {

// head_dim: 16, 32 or 64. Every tensor is fp32 and contiguous; the caller
// checks shapes. Each launch goes on the given stream; returns a cudaError_t.
// F<head_dim>(...) for head_dim 16, 32 or 64
#define WKV_BY_HEAD_DIM(F, ...)                 \
  switch (head_dim) {                           \
    case 16: return F<16>(__VA_ARGS__);         \
    case 32: return F<32>(__VA_ARGS__);         \
    case 64: return F<64>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue; \
  }

int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw, const void* u,
             const void* s0, void* y, void* sT, int B, int L, int H, int head_dim,
             void* stream) {
  WKV_BY_HEAD_DIM(fwd, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(s0), WR(y), WR(sT), B, L, H,
                  (cudaStream_t)stream)
}

int wkv6_bwd_dr(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, const void* dy, const void* dsT, void* dr, void* a,
                void* du_part, int B, int L, int H, int head_dim, void* stream) {
  WKV_BY_HEAD_DIM(bwd_dr, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(s0), RD(dy), RD(dsT), WR(dr),
                  WR(a), WR(du_part), B, L, H, (cudaStream_t)stream)
}

int wkv6_bwd_dk(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* dy, const void* dsT, const void* a, const void* du_part, void* dk,
                void* dlogw, void* ds0, void* du, int B, int L, int H, int head_dim,
                void* stream) {
  WKV_BY_HEAD_DIM(bwd_dk, RD(r), RD(k), RD(v), RD(logw), RD(u), RD(dy), RD(dsT), RD(a),
                  RD(du_part), WR(dk), WR(dlogw), WR(ds0), WR(du), B, L, H,
                  (cudaStream_t)stream)
}

int wkv6_bwd_dv(const void* r, const void* k, const void* logw, const void* u, const void* dy,
                const void* dsT, void* dv, int B, int L, int H, int head_dim, void* stream) {
  WKV_BY_HEAD_DIM(bwd_dv, RD(r), RD(k), RD(logw), RD(u), RD(dy), RD(dsT), WR(dv), B, L, H,
                  (cudaStream_t)stream)
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

// Blocks of wkv6_bwd_dr_kernel and wkv6_bwd_dk_kernel that fit on one SM at
// once at head_dim 64.
int wkv6_bwd_blocks_per_sm(int* dr_blocks, int* dk_blocks) {
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_dr_kernel<64>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dr_smem<64>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_dk_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dk_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dr_blocks, wkv6_bwd_dr_kernel<64>,
                                                      DrCfg<64>::NT, dr_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dk_blocks, wkv6_bwd_dk_kernel<64>,
                                                      DkCfg<64>::NT, dk_smem<64>());
  return (int)e;
}

// Blocks of wkv6_bwd_dv_kernel that fit on one SM at once at head_dim 64.
int wkv6_bwd_dv_blocks_per_sm(int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_dv_kernel<64>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)fwd_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv6_bwd_dv_kernel<64>,
                                                      FwdCfg<64>::NT, fwd_smem<64>());
  return (int)e;
}

}  // extern "C"
