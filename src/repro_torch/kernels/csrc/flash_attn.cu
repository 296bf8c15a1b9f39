// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dK/dV and dQ). fp32 accumulation on the CUDA cores.
//
// Replaces: src/repro/kernels/attention/kernel.py, flash_attention_bhld
// (pallas_call body _flash_kernel), the TPU flash-attention forward. The
// reference has no backward kernel; the backward here computes the gradient
// of the same function (held against jax.vjp of
// src/repro/models/attention.py: chunked_attention in the tests).
//
// What it computes, as the reference does: q [B,Hq,Lq,D], k/v [B,Hkv,Lk,D],
// q head h reads kv head h / (Hq/Hkv); scores (q*scale).k masked by
// k < kv_len, causal q >= k and window (q - k) < window with the finite
// NEG_INF = -1e30; online (m, l, acc) softmax over kv tiles; out =
// acc / max(l, 1e-30) in the input type. A kv tile is skipped when every row
// of the q tile is past it (causal) or before it (window), as the reference
// skips whole blocks. The forward also writes lse = m + log(l), fp32, for the
// backward, which recomputes P = exp(s - lse).
//
// What bounds it on an H100: at the trainer's shapes (D = 64, L = 1024,
// causal, fp32) attention does ~130 (forward, dQ) to ~170 (dK/dV) flops
// per byte it must move, far above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20, so the bound is the fp32 CUDA-core rate, not HBM. This
// first version does not reach it: each thread owns a 4 x 4 micro-tile of
// the 64 x 64 score tile and reads its operands from shared memory, which
// costs one shared load per two FMAs, so shared-memory bandwidth, not the
// FMA units, is its limit. The design keeps every byte of a tile on chip
// (one read of q per q tile, one read of k/v per (q tile, kv tile) pair,
// nothing of the L x L matrix in HBM), pads shared rows to odd strides so
// the score loop has no bank conflicts, and does the reductions across the
// 16 threads of a row group with warp shuffles. The backward avoids atomics:
// one block per (b, kv head, k tile) loops over the G q heads and the q tiles
// that can see its keys and owns its dK/dV rows; one block per (b, q head,
// q tile) owns its dQ rows and also writes delta = rowsum(dO * O).
// wgmma, TMA and a pipelined tile ring are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;     // q rows per tile
constexpr int BK = 64;     // kv rows per tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int LDS = BK + 4;  // score-tile stride: the two row groups of a warp land 16 banks apart

static_assert(BQ == BK, "the dQ kernel stages the O tile in the K buffer");

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [r0, r0 + ROWS) of a row-major [L, D] matrix into shared memory with
// row stride LD, times mul; rows at or past L are zero.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int L, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (r0 + r < L) x = to_f<T>(src[(size_t)(r0 + r) * D + c]) * mul;
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int kv_len, int causal, int window) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// Reductions over the 16 threads (a half warp) that share a row group.
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int ceil_div_pos(int n, int d) { return n <= 0 ? 0 : (n + d - 1) / d; }

// kv tiles [lo, hi) that the q tile starting at q0 visits.
__device__ __forceinline__ void kv_tiles(int q0, int kv_len, int causal, int window, int& lo,
                                         int& hi) {
  hi = (kv_len + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  lo = window > 0 ? ceil_div_pos(q0 - window + 2 - BK, BK) : 0;
}

// q tiles [lo, hi) that visit the kv tile starting at k0 (the same pairs).
__device__ __forceinline__ void q_tiles(int k0, int Lq, int kv_len, int causal, int window,
                                        int& lo, int& hi) {
  hi = (Lq + BQ - 1) / BQ;
  lo = causal ? ceil_div_pos(k0 - BQ + 1, BQ) : 0;
  if (window > 0) hi = min(hi, (k0 + BK + window - 2) / BQ + 1);
  if (k0 >= kv_len) hi = lo;
}

// ------------------------------------------------------------------ forward
// grid (q tiles, B * Hq). Thread (ty, tx) owns q rows ty*4 + i, score
// columns tx + 16*j and output columns tx + 16*j.
template <typename T, int D>
__global__ void __launch_bounds__(NT) fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                 const T* __restrict__ v, T* __restrict__ o,
                                                 float* __restrict__ lse, int Hq, int Hkv, int Lq,
                                                 int Lk, int kv_len, int causal, int window,
                                                 float scale) {
  constexpr int LDQ = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LDQ], pre-scaled
  float* Ks = Qs + BQ * LDQ;     // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;     // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][LDS]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;

  load_tile<T, D, BQ, LDQ>(Qs, q + q_off, q0, Lq, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_tiles(q0, kv_len, causal, window, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    load_tile<T, D, BK, LDQ>(Ks, k + kv_off, k0, Lk, 1.f);
    load_tile<T, D, BK, D>(Vs, v + kv_off, k0, Lk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qp, k0 + tx + 16 * j, kv_len, causal, window)) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = group_max(mt);
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty * 4 + i) * LDS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vb[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Lq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o[q_off + (size_t)qp * D + tx + 16 * j] = from_f<T>(acc[i][j] / lm);
    if (tx == 0) lse[(size_t)bh * Lq + qp] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------ backward: dQ
// grid (q tiles, B * Hq). Also writes delta = rowsum(dO * O), which the
// dK/dV kernel (launched after it on the same stream) reads.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale) {
  constexpr int LDQ = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LDQ], pre-scaled
  float* dOs = Qs + BQ * LDQ;    // [BQ][LDQ]
  float* Ks = dOs + BQ * LDQ;    // [BK][LDQ]; holds the O tile before the loop
  float* Vs = Ks + BK * LDQ;     // [BK][LDQ]
  float* Ps = Vs + BK * LDQ;     // [BQ][LDS], holds dS
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;

  load_tile<T, D, BQ, LDQ>(Qs, q + q_off, q0, Lq, scale);
  load_tile<T, D, BQ, LDQ>(dOs, dout + q_off, q0, Lq, 1.f);
  load_tile<T, D, BQ, LDQ>(Ks, o + q_off, q0, Lq, 1.f);
  __syncthreads();

  float dl[4], ls[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qp = q0 + r;
    float x = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) x += dOs[r * LDQ + tx + 16 * j] * Ks[r * LDQ + tx + 16 * j];
    dl[i] = group_sum(x);
    ls[i] = qp < Lq ? lse[(size_t)bh * Lq + qp] : 0.f;
    if (tx == 0 && qp < Lq) delta[(size_t)bh * Lq + qp] = dl[i];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_tiles(q0, kv_len, causal, window, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, D, BK, LDQ>(Ks, k + kv_off, k0, Lk, 1.f);
    load_tile<T, D, BK, LDQ>(Vs, v + kv_off, k0, Lk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * LDQ + d];
        g[i] = dOs[(ty * 4 + i) * LDQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * LDQ + d];
        vb[j] = Vs[(tx + 16 * j) * LDQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sv = visible(qp, k0 + tx + 16 * j, kv_len, causal, window) ? s[i][j] : NEG_INF;
        const float p = expf(sv - ls[i]);
        Ps[(ty * 4 + i) * LDS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4], kb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ps[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) kb[j] = Ks[c * LDQ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(ds[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[q_off + (size_t)qp * D + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// --------------------------------------------------------- backward: dK, dV
// grid (k tiles, B * Hkv). Thread (ty, tx) owns key rows ty*4 + i, score
// columns (queries) tx + 16*j and dK/dV columns tx + 16*j. Sums over the G
// q heads of its kv head and the q tiles that see its keys: no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale) {
  constexpr int LDQ = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;     // [BK][LDQ]
  float* Qs = Vs + BK * LDQ;     // [BQ][LDQ], pre-scaled
  float* dOs = Qs + BQ * LDQ;    // [BQ][LDQ]
  float* Ps = dOs + BQ * LDQ;    // [BK][LDS]: P^T, then dS^T
  float* lse_s = Ps + BK * LDS;  // [BQ]
  float* dl_s = lse_s + BQ;      // [BQ]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = Hq / Hkv;
  const size_t kv_off = (size_t)bhk * Lk * D;

  load_tile<T, D, BK, LDQ>(Ks, k + kv_off, k0, Lk, 1.f);
  load_tile<T, D, BK, LDQ>(Vs, v + kv_off, k0, Lk, 1.f);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[i][j] = dva[i][j] = 0.f;

  int lo, hi;
  q_tiles(k0, Lq, kv_len, causal, window, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int bh = b * Hq + hk * G + g;
    const size_t q_off = (size_t)bh * Lq * D;
    for (int u = lo; u < hi; ++u) {
      const int q0 = u * BQ;
      __syncthreads();
      load_tile<T, D, BQ, LDQ>(Qs, q + q_off, q0, Lq, scale);
      load_tile<T, D, BQ, LDQ>(dOs, dout + q_off, q0, Lq, 1.f);
      if (tid < BQ) {
        const bool in = q0 + tid < Lq;
        lse_s[tid] = in ? lse[(size_t)bh * Lq + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[4], vr[4], qc[4], gc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = Ks[(ty * 4 + i) * LDQ + d];
          vr[i] = Vs[(ty * 4 + i) * LDQ + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qc[j] = Qs[(tx + 16 * j) * LDQ + d];
          gc[j] = dOs[(tx + 16 * j) * LDQ + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, qp = q0 + r;
          const float sv = visible(qp, kp, kv_len, causal, window) ? s[i][j] : NEG_INF;
          const float p = qp < Lq ? expf(sv - lse_s[r]) : 0.f;
          Ps[(ty * 4 + i) * LDS + r] = p;
          s[i][j] = p * (dp[i][j] - dl_s[r]);  // dS^T, kept for after dV
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], gb[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDS + r];
#pragma unroll
        for (int j = 0; j < NC; ++j) gb[j] = dOs[r * LDQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) dva[i][j] = fmaf(p[i], gb[j], dva[i][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float ds[4], qb[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = Ps[(ty * 4 + i) * LDS + r];
#pragma unroll
        for (int j = 0; j < NC; ++j) qb[j] = Qs[r * LDQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) dka[i][j] = fmaf(ds[i], qb[j], dka[i][j]);
      }
    }
  }

  // q was pre-scaled, so dK = dS^T (scale * q) needs no further factor
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[kv_off + (size_t)kp * D + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[kv_off + (size_t)kp * D + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

constexpr size_t fwd_smem(int D) { return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * LDS); }
constexpr size_t dq_smem(int D) { return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LDS); }
constexpr size_t dkdv_smem(int D) {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + BK * LDS + 2 * BQ);
}

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                cudaStream_t st) {
  const size_t smem = fwd_smem(D);
  cudaError_t e = prepare(fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Lq + BQ - 1) / BQ, B * Hq);
  fwd_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq,
                                           Hkv, Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, float* delta, int B, int Hq, int Hkv, int Lq,
                   int Lk, int kv_len, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = dq_smem(D);
  cudaError_t e = prepare(bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Lq + BQ - 1) / BQ, B * Hq);
  bwd_dq_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                              (const T*)o, (const T*)dout, lse, (T*)dq, delta,
                                              Hq, Hkv, Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                     int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                     cudaStream_t st) {
  const size_t smem = dkdv_smem(D);
  cudaError_t e = prepare(bwd_dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Lk + BK - 1) / BK, B * Hkv);
  bwd_dkdv_kernel<T, D><<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                (const T*)dout, lse, delta, (T*)dk, (T*)dv, Hq,
                                                Hkv, Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 16, 32, 64 or 128. Every
// tensor is contiguous; the caller checks shapes. Returns a cudaError_t.
#define FA_DISPATCH(FN, ...)                                                  \
  do {                                                                        \
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;          \
    switch (head_dim) {                                                       \
      case 16: return (int)(dtype ? FN<__nv_bfloat16, 16>(__VA_ARGS__)        \
                                  : FN<float, 16>(__VA_ARGS__));              \
      case 32: return (int)(dtype ? FN<__nv_bfloat16, 32>(__VA_ARGS__)        \
                                  : FN<float, 32>(__VA_ARGS__));              \
      case 64: return (int)(dtype ? FN<__nv_bfloat16, 64>(__VA_ARGS__)        \
                                  : FN<float, 64>(__VA_ARGS__));              \
      case 128: return (int)(dtype ? FN<__nv_bfloat16, 128>(__VA_ARGS__)      \
                                   : FN<float, 128>(__VA_ARGS__));            \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  } while (0)

extern "C" {

int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int Hq, int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                   int window, float scale, int dtype, void* stream) {
  FA_DISPATCH(fwd, q, k, v, o, (float*)lse, B, Hq, Hkv, Lq, Lk, kv_len, causal, window, scale,
              (cudaStream_t)stream);
}

int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int B, int Hq,
                      int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal, int window,
                      float scale, int dtype, void* stream) {
  FA_DISPATCH(bwd_dq, q, k, v, o, dout, (const float*)lse, dq, (float*)delta, B, Hq, Hkv, Lq,
              Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
                        int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                        int window, float scale, int dtype, void* stream) {
  FA_DISPATCH(bwd_dkdv, q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, B, Hq,
              Hkv, Lq, Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

const char* flash_attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
