// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dQ, then dK/dV). fp32 accumulation on the CUDA cores.
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
// What bounds the forward on an H100: at the trainer's shapes (D = 64,
// L = 1024, causal, fp32) attention does ~130 (forward, dQ) to ~170 (dK/dV)
// flops per byte it must move, far above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20, so the bound is the fp32 CUDA-core rate, not HBM. The
// forward does not reach it: each thread owns a 4 x 4 micro-tile of the
// 64 x 64 score tile and reads its operands from shared memory, which costs
// one shared load per two FMAs, so shared-memory bandwidth, not the FMA
// units, is its limit. It keeps every byte of a tile on chip (one read of q
// per q tile, one read of k/v per (q tile, kv tile) pair, nothing of the
// L x L matrix in HBM), pads shared rows to odd strides so the score loop
// has no bank conflicts, and does the reductions across the 16 threads of a
// row group with warp shuffles.
//
// The backward is bound by the same fp32 FMA rate (6 D flops a visible
// (query, key) pair for dQ, 8 D for dK/dV; TF32 is off, so no tensor core
// serves it). The first version read one float from shared memory per two
// FMAs, and shared memory, not the FMA units, set its pace. This one:
// - Register blocking with 16-byte shared loads. Every product reads both
//   operands as float4: the score loops along d (S = Q K^T and dP = dO V^T
//   contract over d, contiguous in both rows), the dQ/dV/dK loops along the
//   score tile's columns and along d of the data tile. A thread owns an
//   MR x 4 micro-tile of the score tile (MR = 8 for D <= 64, 4 for D = 128)
//   and MR x D/16 outputs: 12 LDS.128 per 128 FMAs at D = 64 (10.7 FMAs a
//   load, against 2). S and dP take two passes over d; P goes to shared
//   memory between them, so only one score micro-tile is live in registers.
//   On the H100 a warp-wide LDS.128 is cheapest when the warp touches at
//   most 8 different chunks, and costs more the more it touches beyond
//   that (measured on the card). The lanes of a warp are therefore 4
//   score rows by 8 score columns of threads, and the tiles are XOR-swizzled
//   by chunk with a key that is the same for all of a thread's rows, so that
//   every load in the inner loops touches at most 8 chunks, hits 8
//   different bank groups, and takes an immediate offset.
// - A two-stage ring filled with cp.async (16 bytes, .cg): the streamed
//   tiles (K, V for dQ; Q, dO, lse, delta for dK/dV) of step t + 1 load
//   while step t computes. bf16 inputs, and fp32 inputs that do not start on
//   a 16-byte boundary, are converted and stored by the threads instead, at
//   the same point of the loop, so they stay correct without the overlap.
// - One block barrier a step in both kernels, after the wait for the step's
//   tiles (it also frees the other stage and the score buffers of the step
//   before), and one barrier of the two warps that share score rows after
//   P and dS are written (bar.sync with 64 threads). dK/dV keeps P and dS in
//   two buffers, so dV += P^T dO and dK += dS^T Q both follow that barrier.
// - Blocks: dQ, one per (b, q head, 64-row q tile), 128 threads at D <= 64,
//   113 KB of shared memory, two blocks an SM; dK/dV, one per (b, kv
//   head, 128-key tile) at D <= 64 (64 keys at D = 128), 256 threads, 193 KB
//   at D = 64, one block an SM. dK/dV loops over the G q heads of its kv
//   head and the q tiles that see its keys and owns its rows; dQ owns its
//   rows and also writes delta = rowsum(dO * O): no atomics, and two runs
//   give the same bits.
// - Order: the tile index is the grid's slow axis, so the heaviest causal
//   tiles (the last q tiles for dQ, the first key tiles for dK/dV) are
//   dispatched first. The inner loops are unrolled 4 times.
// What still bounds it: the three loops of dQ and the four of dK/dV take
// most of a warp's cycles (a clock64 count by phase, in an instrumented
// build that is not kept) and run well below the FMA rate: their 12
// LDS.128 per 128 FMAs keep the shared memory busy for most of the cycles
// the FMAs need, and two warps a scheduler do not hide the loads' latency.
// ptxas (sm_90a, fp32, D = 64): bwd_dq 240 registers, bwd_dkdv 230, no
// spills; 2 and 1 blocks an SM (flash_attn_bwd_blocks_per_sm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;     // q rows per tile
constexpr int BK = 64;     // kv rows per tile
constexpr int NT = 256;    // threads per block: a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int LDS = BK + 4;  // score-tile stride: the two row groups of a warp land 16 banks apart

static_assert(BQ == BK, "the backward's score tiles are 64 columns wide in both kernels");

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

// ----------------------------------------------------------------- backward
// Tiles in shared memory are fp32, row-major with rows of D floats, and
// chunk c4 (floats 4 c4 .. 4 c4 + 3) of row r stored at chunk
// c4 ^ ((r >> SH) & M): M = 7 where a row holds 8 chunks or more, else
// chunks - 1. SH = 2 for the tiles read by score column (a thread reads
// rows 4 ox + j, a warp 8 rows 4 apart), log2(MR) for those read by score
// row (rows MR ty + i, a warp 4 rows MR apart): the rows a warp reads at
// once get different keys, and all the rows one thread reads share one.
template <int D, int SH>
__device__ __forceinline__ int sw(int r, int c4) {
  constexpr int M = D / 4 >= 8 ? 7 : D / 4 - 1;
  return r * D + ((c4 ^ ((r >> SH) & M)) << 2);
}
template <int D, int SH>
__device__ __forceinline__ const float4& chunk(const float* tile, int r, int c4) {
  return *reinterpret_cast<const float4*>(tile + sw<D, SH>(r, c4));
}
template <int D, int SH>
__device__ __forceinline__ float4& chunk_ref(float* tile, int r, int c4) {
  return *reinterpret_cast<float4*>(tile + sw<D, SH>(r, c4));
}

// A block's warps tile its score tile WR x 2 (rows x columns), and the
// lanes of a warp are 4 x 8: lane (ty, tx) = (lane / 8, lane % 8) of warp
// (wr, wc) owns the MR score rows r0 + i, r0 = 4 MR wr + MR ty, the score
// columns of chunk ox = tx + 8 wc (columns 4 ox .. 4 ox + 3) and the output
// columns out_col(ox, e). A warp's loads then touch at most 8 different
// 16-byte chunks, which the shared memory serves at its floor of 2 cycles a
// load; P and dS move as float4. The two warps
// of a warp row share its rows of P and dS, and wait for each other only.
template <int D>
struct BwdCfg {
  static constexpr int MR = D <= 64 ? 8 : 4;      // score rows of a thread
  static constexpr int SH = MR == 8 ? 3 : 2;      // log2(MR): swizzle of row-read tiles
  static constexpr int NO = D / 16;               // output columns of a thread
  static constexpr int DQ_NT = 64 * BQ / (4 * MR);  // threads of a dQ block
  static constexpr int KR = D <= 64 ? 128 : 64;   // key rows of a dK/dV block
  static constexpr int KV_NT = 64 * KR / (4 * MR);  // threads of a dK/dV block
};
struct Place {
  int r0, ox, wr;
};
template <int D>
__device__ __forceinline__ Place place() {
  constexpr int MR = BwdCfg<D>::MR;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return {(w >> 1) * 4 * MR + (lane >> 3) * MR, (lane & 7) + 8 * (w & 1), w >> 1};
}

// Output column e of output chunk ox: whole chunks ox + 16 g where a thread
// owns 4 columns or more, else columns ox * NO + e.
template <int D>
__device__ __forceinline__ int out_col(int ox, int e) {
  constexpr int NO = D / 16;
  if constexpr (NO >= 4) return ((ox + 16 * (e >> 2)) << 2) + (e & 3);
  else return ox * NO + e;
}

// The 64 threads of the two warps of warp row wr wait for each other.
__device__ __forceinline__ void pair_sync(int wr) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wr), "r"(64) : "memory");
}

__device__ __forceinline__ float lane(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

template <typename T> struct is_f32 { static constexpr bool value = false; };
template <> struct is_f32<float> { static constexpr bool value = true; };

// Rows [r0, r0 + ROWS) of a row-major [L, D] matrix into a tile;
// rows at or past L are zero. Thread t copies chunks t + NTH m, whose places
// do not depend on r0. fp32 with 16-byte aligned rows goes by cp.async (the
// caller commits and waits); anything else is converted and stored by the
// threads.
template <typename T, int D, int ROWS, int NTH, int SH>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0, int L, bool async_ok) {
  constexpr int C4 = D / 4, N = ROWS * C4 / NTH;
  static_assert(ROWS * C4 % NTH == 0, "every thread copies the same number of chunks");
  const T* base = src + (size_t)r0 * D;
  const bool whole = r0 + ROWS <= L;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int idx = threadIdx.x + NTH * m, r = idx / C4, c4 = idx % C4;
    float* d = dst + sw<D, SH>(r, c4);
    const T* s = base + r * D + c4 * 4;
    if (!whole && r0 + r >= L) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (is_f32<T>::value && async_ok) {
      cp_async16(d, s);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(to_f<T>(s[0]), to_f<T>(s[1]), to_f<T>(s[2]),
                                                  to_f<T>(s[3]));
    }
  }
}

// s[i][j] = sum_d A[r0 + i][d] B[4 ox + j][d]: the score micro-tile.
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* B, const Place& pl,
                                          float (&s)[BwdCfg<D>::MR][4]) {
  constexpr int MR = BwdCfg<D>::MR, SH = BwdCfg<D>::SH;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 a[MR], b[4];
#pragma unroll
    for (int i = 0; i < MR; ++i) a[i] = chunk<D, SH>(A, pl.r0 + i, d4);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = chunk<D, 2>(B, 4 * pl.ox + j, d4);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][e] += sum_c P[r0 + i][c] X[c][out_col(ox, e)] over the 64 columns
// of the score tile P and the rows of the data tile X.
template <int D>
__device__ __forceinline__ void tile_product(const float* P, const float* X, const Place& pl,
                                             float (&acc)[BwdCfg<D>::MR][D / 16]) {
  constexpr int MR = BwdCfg<D>::MR, SH = BwdCfg<D>::SH, NO = D / 16;
#pragma unroll 4
  for (int c4 = 0; c4 < BK / 4; ++c4) {
    float4 a[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) a[i] = chunk<BK, SH>(P, pl.r0 + i, c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = c4 * 4 + cc;
      float x[NO];
      if constexpr (NO >= 4) {
#pragma unroll
        for (int g = 0; g < NO / 4; ++g) {
          const float4 v = chunk<D, 2>(X, c, pl.ox + 16 * g);
          x[4 * g] = v.x;
          x[4 * g + 1] = v.y;
          x[4 * g + 2] = v.z;
          x[4 * g + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < NO; ++e) {
          const int col = out_col<D>(pl.ox, e);
          x[e] = X[sw<D, 2>(c, col >> 2) + (col & 3)];
        }
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float p = lane(a[i], cc);
#pragma unroll
        for (int e = 0; e < NO; ++e) acc[i][e] = fmaf(p, x[e], acc[i][e]);
      }
    }
  }
}

// The block's tile index and its (batch, head) row. The tile is the grid's
// slow axis, walked from the heaviest end (``reverse`` when the work grows
// with the index), so the heaviest tile of every head is dispatched before
// any lighter one.
__device__ __forceinline__ void bwd_block(int n_tiles, bool reverse, int& tile, int& bh) {
  bh = blockIdx.x;
  tile = reverse ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
}
inline dim3 bwd_grid(int n_tiles, int n_heads) { return dim3(n_heads, n_tiles); }

// q tiles [lo, hi) that visit the KR keys starting at k0 (the pairs the
// forward visits).
template <int KR>
__device__ __forceinline__ void q_tiles(int k0, int Lq, int kv_len, int causal, int window,
                                        int& lo, int& hi) {
  hi = (Lq + BQ - 1) / BQ;
  lo = causal ? ceil_div_pos(k0 - BQ + 1, BQ) : 0;
  if (window > 0) hi = min(hi, (k0 + KR + window - 2) / BQ + 1);
  if (k0 >= kv_len) hi = lo;
}

// ------------------------------------------------------------ backward: dQ
// One block per (b, q head, 64-row q tile); Q and dO stay, K and V stream
// through the ring. A thread owns q rows r0 + i, the score columns of chunk
// ox and dQ columns out_col(ox, e). Also writes delta = rowsum(dO * O),
// which the dK/dV kernel (launched after it on the same stream) reads.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<D>::DQ_NT, 1) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale, int async_ok) {
  using C = BwdCfg<D>;
  constexpr int MR = C::MR, SH = C::SH, NO = C::NO, NTH = C::DQ_NT, TILE = BQ * D;
  extern __shared__ float4 bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);  // [BQ][D], read by row
  float* dOs = Qs + TILE;                           // [BQ][D], read by row
  float* KVs = dOs + TILE;                          // 2 stages of [BK][D] K, [BK][D] V
  float* dSs = KVs + 4 * TILE;                      // [BQ][BK]: P, then dS, read by row
  float* stat = dSs + BQ * BK;                      // [BQ] lse log2(e), [BQ] delta, [2][BQ]
  const int tid = threadIdx.x;
  const Place pl = place<D>();
  const float scale_log2 = scale * LOG2E;
  int u, bh;
  bwd_block((Lq + BQ - 1) / BQ, causal != 0, u, bh);
  const int q0 = u * BQ;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;

  int lo, hi;
  kv_tiles(q0, kv_len, causal, window, lo, hi);
  stage_tile<T, D, BQ, NTH, SH>(Qs, q + q_off, q0, Lq, async_ok);
  stage_tile<T, D, BQ, NTH, SH>(dOs, dout + q_off, q0, Lq, async_ok);
  if (lo < hi) {
    stage_tile<T, D, BK, NTH, 2>(KVs, k + kv_off, lo * BK, Lk, async_ok);
    stage_tile<T, D, BK, NTH, 2>(KVs + TILE, v + kv_off, lo * BK, Lk, async_ok);
  }
  cp_async_commit();

  // delta: each warp sums its half of a row's columns over its 8 lanes, and
  // the two halves are added in a fixed order
  float acc[MR][NO];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int qp = q0 + pl.r0 + i;
    float x = 0.f;
    if (qp < Lq) {
      const size_t row = q_off + (size_t)qp * D;
#pragma unroll
      for (int e = 0; e < NO; ++e) {
        const int c = out_col<D>(pl.ox, e);
        x = fmaf(to_f<T>(dout[row + c]), to_f<T>(o[row + c]), x);
      }
    }
    for (int m = 4; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    if ((tid & 7) == 0) stat[(2 + (pl.ox >> 3)) * BQ + pl.r0 + i] = x;
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();
  if (tid < BQ) {
    const int qp = q0 + tid;
    const float dl = stat[2 * BQ + tid] + stat[3 * BQ + tid];
    stat[tid] = qp < Lq ? lse[(size_t)bh * Lq + qp] * LOG2E : 0.f;
    stat[BQ + tid] = dl;
    if (qp < Lq) delta[(size_t)bh * Lq + qp] = dl;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    const float* Ks = KVs + ((t - lo) & 1) * 2 * TILE;
    const float* Vs = Ks + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    if (t + 1 < hi) {
      float* nxt = KVs + ((t + 1 - lo) & 1) * 2 * TILE;
      stage_tile<T, D, BK, NTH, 2>(nxt, k + kv_off, k0 + BK, Lk, async_ok);
      stage_tile<T, D, BK, NTH, 2>(nxt + TILE, v + kv_off, k0 + BK, Lk, async_ok);
    }
    cp_async_commit();

    // no mask inside the tile: every key before every query, none past kv_len
    const bool full = (!causal || k0 + BK - 1 <= q0) && window <= 0 && k0 + BK <= kv_len;
    float s[MR][4];
    tile_dots<D>(Qs, Ks, pl, s);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = pl.r0 + i, qp = q0 + r;
      const float ls = stat[r];
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = full || visible(qp, k0 + 4 * pl.ox + j, kv_len, causal, window);
        p[j] = exp2f(vis ? fmaf(s[i][j], scale_log2, -ls) : NEG_INF);
      }
      chunk_ref<BK, SH>(dSs, r, pl.ox) = make_float4(p[0], p[1], p[2], p[3]);  // P
    }
    tile_dots<D>(dOs, Vs, pl, s);  // dP
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = pl.r0 + i;
      const float dl = stat[BQ + r];
      float4& p = chunk_ref<BK, SH>(dSs, r, pl.ox);
      p = make_float4(p.x * (s[i][0] - dl), p.y * (s[i][1] - dl), p.z * (s[i][2] - dl),
                      p.w * (s[i][3] - dl));  // dS
    }
    pair_sync(pl.wr);  // a thread's rows of dS were written by its warp row
    tile_product<D>(dSs, Ks, pl, acc);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int qp = q0 + pl.r0 + i;
    if (qp >= Lq) continue;
#pragma unroll
    for (int e = 0; e < NO; ++e)
      dq[q_off + (size_t)qp * D + out_col<D>(pl.ox, e)] = from_f<T>(acc[i][e] * scale);
  }
}

// --------------------------------------------------------- backward: dK, dV
// One block per (b, kv head, KR-key tile); K and V stay, and the q tiles
// that see the keys, of each of the G q heads of the kv head, stream Q, dO,
// lse and delta through the ring. A thread owns key rows r0 + i, the score
// columns (queries) of chunk ox and dK/dV columns out_col(ox, e): it sums
// over every query that sees its keys, so no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<D>::KV_NT, 1) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale, int async_ok) {
  using C = BwdCfg<D>;
  constexpr int MR = C::MR, SH = C::SH, NO = C::NO, NTH = C::KV_NT, KR = C::KR;
  constexpr int QT = BQ * D;
  extern __shared__ float4 bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);  // [KR][D], read by row
  float* Vs = Ks + KR * D;                          // [KR][D], read by row
  float* QdO = Vs + KR * D;                         // 2 stages of [BQ][D] Q, [BQ][D] dO
  float* Ps = QdO + 4 * QT;                         // [KR][BQ], read by row
  float* dSs = Ps + KR * BQ;                        // [KR][BQ], read by row
  float* rows = dSs + KR * BQ;                      // 2 stages of [BQ] lse, [BQ] delta
  const int tid = threadIdx.x;
  const Place pl = place<D>();
  const float scale_log2 = scale * LOG2E;
  int kt, bhk;
  bwd_block((Lk + KR - 1) / KR, false, kt, bhk);
  const int k0 = kt * KR;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = Hq / Hkv;
  const size_t kv_off = (size_t)bhk * Lk * D;

  int lo, hi;
  q_tiles<KR>(k0, Lq, kv_len, causal, window, lo, hi);
  const int n_u = hi - lo, n_it = G * n_u;
  // step it is q tile lo + it % n_u of q head hk * G + it / n_u
  auto stage_step = [&](int it, int st) {
    const int bh = b * Hq + hk * G + it / n_u, q0 = (lo + it % n_u) * BQ;
    const size_t q_off = (size_t)bh * Lq * D;
    float* dst = QdO + st * 2 * QT;
    stage_tile<T, D, BQ, NTH, 2>(dst, q + q_off, q0, Lq, async_ok);
    stage_tile<T, D, BQ, NTH, 2>(dst + QT, dout + q_off, q0, Lq, async_ok);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      float* d = rows + st * 2 * BQ + tid;
      const float* src = (tid < BQ ? lse : delta) + (size_t)bh * Lq + q0 + r;
      if (q0 + r < Lq) cp_async4(d, src);
      else *d = 0.f;
    }
  };

  stage_tile<T, D, KR, NTH, SH>(Ks, k + kv_off, k0, Lk, async_ok);
  stage_tile<T, D, KR, NTH, SH>(Vs, v + kv_off, k0, Lk, async_ok);
  if (n_it > 0) stage_step(0, 0);
  cp_async_commit();

  float dka[MR][NO], dva[MR][NO];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int e = 0; e < NO; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (lo + it % n_u) * BQ;
    const float* Qs = QdO + st * 2 * QT;
    const float* dOs = Qs + QT;
    const float* lse_s = rows + st * 2 * BQ;
    const float* dl_s = lse_s + BQ;
    cp_async_wait_all();
    __syncthreads();  // step it is in; every thread is done with step it - 1
    if (it + 1 < n_it) stage_step(it + 1, st ^ 1);
    cp_async_commit();

    // no mask inside the tile: every key before every query, none past kv_len or Lq
    const bool full = (!causal || k0 + KR - 1 <= q0) && window <= 0 && k0 + KR <= kv_len &&
                      q0 + BQ <= Lq;
    const float4 ls = *reinterpret_cast<const float4*>(lse_s + 4 * pl.ox);
    const float ls2[4] = {ls.x * LOG2E, ls.y * LOG2E, ls.z * LOG2E, ls.w * LOG2E};
    float s[MR][4];
    tile_dots<D>(Ks, Qs, pl, s);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = pl.r0 + i, kp = k0 + r;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + 4 * pl.ox + j;
        const bool vis = full || (qp < Lq && visible(qp, kp, kv_len, causal, window));
        p[j] = exp2f(vis ? fmaf(s[i][j], scale_log2, -ls2[j]) : NEG_INF);
      }
      chunk_ref<BQ, SH>(Ps, r, pl.ox) = make_float4(p[0], p[1], p[2], p[3]);
    }
    tile_dots<D>(Vs, dOs, pl, s);  // dP
    const float4 dl = *reinterpret_cast<const float4*>(dl_s + 4 * pl.ox);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = pl.r0 + i;
      const float4 p = chunk<BQ, SH>(Ps, r, pl.ox);
      chunk_ref<BQ, SH>(dSs, r, pl.ox) =
          make_float4(p.x * (s[i][0] - dl.x), p.y * (s[i][1] - dl.y), p.z * (s[i][2] - dl.z),
                      p.w * (s[i][3] - dl.w));
    }
    pair_sync(pl.wr);  // a thread's rows of P and dS were written by its warp row
    tile_product<D>(Ps, dOs, pl, dva);
    tile_product<D>(dSs, Qs, pl, dka);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int kp = k0 + pl.r0 + i;
    if (kp >= Lk) continue;
#pragma unroll
    for (int e = 0; e < NO; ++e) {
      const size_t idx = kv_off + (size_t)kp * D + out_col<D>(pl.ox, e);
      dk[idx] = from_f<T>(dka[i][e] * scale);
      dv[idx] = from_f<T>(dva[i][e]);
    }
  }
}

constexpr size_t fwd_smem(int D) { return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * LDS); }

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


template <int D>
constexpr size_t bwd_dq_smem() { return sizeof(float) * (6 * BQ * D + BQ * BK + 4 * BQ); }
template <int D>
constexpr size_t bwd_dkdv_smem() {
  constexpr int KR = BwdCfg<D>::KR;
  return sizeof(float) * (2 * KR * D + 4 * BQ * D + 2 * KR * BQ + 4 * BQ);
}
static_assert(bwd_dq_smem<128>() <= 232448 && bwd_dkdv_smem<128>() <= 232448 &&
                  bwd_dkdv_smem<64>() <= 232448,
              "a backward block fits in the 227 KB of shared memory a block can use");

// The backward kernels ask for the largest shared-memory carveout, so that
// two dQ blocks of 112 KB share an SM.
template <typename K>
cudaError_t prepare_bwd(K kern, size_t smem) {
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// cp.async copies 16-byte chunks of fp32 rows: every streamed tensor must
// start on a 16-byte boundary (rows of D floats then do too).
template <typename T>
int can_copy_async(const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d;
  return is_f32<T>::value && (any & 15) == 0;
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, float* delta, int B, int Hq, int Hkv, int Lq,
                   int Lk, int kv_len, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = bwd_dq_smem<D>();
  cudaError_t e = prepare_bwd(bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = bwd_grid((Lq + BQ - 1) / BQ, B * Hq);
  bwd_dq_kernel<T, D><<<grid, BwdCfg<D>::DQ_NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, (T*)dq, delta, Hq,
      Hkv, Lq, Lk, kv_len, causal, window, scale, can_copy_async<T>(q, k, v, dout));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                     int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                     cudaStream_t st) {
  const size_t smem = bwd_dkdv_smem<D>();
  cudaError_t e = prepare_bwd(bwd_dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = bwd_grid((Lk + BwdCfg<D>::KR - 1) / BwdCfg<D>::KR, B * Hkv);
  bwd_dkdv_kernel<T, D><<<grid, BwdCfg<D>::KV_NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Hq, Hkv,
      Lq, Lk, kv_len, causal, window, scale, can_copy_async<T>(q, k, v, dout));
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

// Blocks of each backward kernel that fit on one SM at once, fp32 at
// head_dim 64 (the edl_paper path): the occupancy the design counts on.
int flash_attn_bwd_blocks_per_sm(int* dq_blocks, int* dkdv_blocks) {
  cudaError_t e = prepare_bwd(bwd_dq_kernel<float, 64>, bwd_dq_smem<64>());
  if (e == cudaSuccess) e = prepare_bwd(bwd_dkdv_kernel<float, 64>, bwd_dkdv_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dq_blocks, bwd_dq_kernel<float, 64>,
                                                      BwdCfg<64>::DQ_NT, bwd_dq_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dkdv_blocks, bwd_dkdv_kernel<float, 64>, BwdCfg<64>::KV_NT, bwd_dkdv_smem<64>());
  return (int)e;
}


}  // extern "C"
