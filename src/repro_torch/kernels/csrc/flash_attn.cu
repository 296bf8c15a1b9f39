// Flash attention for Hopper (sm_90a) in fp32: forward, and the backward as
// two kernels (dQ, then dK/dV), on the CUDA cores. bf16 inputs go to
// flash_attn_tc.cu.
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
// Offsets: every element offset into a global tensor is formed in size_t
// from a (batch, head) row (q_off, kv_off, the lse and delta rows, a row of
// a tile), so q, k and v may hold 2^31 elements or more; the int values are
// the dims themselves and the indices inside one tile.
//
// What bounds the forward on an H100: at the trainer's shapes (D = 64,
// L = 1024, causal, fp32) attention does ~130 (forward, dQ) to ~170 (dK/dV)
// flops per byte it must move, far above the fp32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20, so the bound is the fp32 CUDA-core rate, not HBM (TF32 is
// off). The forward is built from the backward's parts below: a block of 4
// warps owns a 64-row q tile and streams K and V through the two-stage
// cp.async ring (threads' own staging for unaligned rows), one
// block barrier a kv tile, heaviest q tiles first. A warp owns 16 whole q
// rows (lanes 4 x 8, a 4 x 8 score micro-tile a thread), so the online
// softmax's row max and row sum are three xor-shuffles over the 8 lanes of
// a row, P goes to shared memory and back within the warp (__syncwarp), and
// each thread sums its part of l, closed once at the end. S = Q K^T over d
// and O += P V over the tile's columns both read float4 operands, 12 LDS.128
// per 128 FMAs, from tiles swizzled so that a warp's loads hit different
// banks. ptxas (sm_90a, fp32, D = 64): 250 registers, no spills; 96 KB of
// shared memory, 2 blocks an SM. It takes 0.47 ms at B = 8, H = 12 (NVIDIA
// H100 80GB HBM3, 700 W; tools/torch_kernel_bench.py), 41 % of its bound, a
// little under SDPA's forward: the two products run below the FMA rate for
// the reason the backward's do (below), and the causal diagonal tiles
// compute 6 % masked pairs.
//
// The backward is bound by the same fp32 FMA rate (6 D flops a visible
// (query, key) pair for dQ, 8 D for dK/dV; TF32 is off, so no tensor core
// serves it). The first version read one float from shared memory per two
// FMAs, and shared memory, not the FMA units, set its pace. This one:
// - Register blocking with 16-byte shared loads. Every product reads both
//   operands as float4: the score loops along d (S = Q K^T and dP = dO V^T
//   contract over d, contiguous in both rows), the dQ/dV/dK loops along the
//   score tile's columns and along d of the data tile. A thread owns an
//   MR x 4 micro-tile of the score tile (MR = 8 for D <= 64, 4 for D = 96
//   and 128) and MR x D/16 outputs (out_col; at D = 96 four of its six
//   columns are a whole chunk and two are read one float at a time, since
//   16 threads cannot share 24 chunks evenly): 12 LDS.128 per 128 FMAs at
//   D = 64 (10.7 FMAs a load, against 2). S and dP take two passes over
//   d; P goes to shared memory between them, so only one score micro-tile
//   is live in registers.
//   On the H100 a warp-wide LDS.128 is cheapest when the warp touches at
//   most 8 different chunks, and costs more the more it touches beyond
//   that (measured on the card). The lanes of a warp are therefore 4
//   score rows by 8 score columns of threads, and the tiles are XOR-swizzled
//   by chunk with a key that is the same for all of a thread's rows, so that
//   every load in the inner loops touches at most 8 chunks, hits 8
//   different bank groups, and takes an immediate offset.
// - A two-stage ring filled with cp.async (16 bytes, .cg): the streamed
//   tiles (K, V for dQ; Q, dO, lse, delta for dK/dV) of step t + 1 load
//   while step t computes. Inputs that do not start on a 16-byte boundary
//   are stored by the threads instead, at the same point of the loop, so
//   they stay correct without the overlap. These kernels take fp32 only:
//   every bf16 product is a tensor-core kernel of flash_attn_tc.cu, and the
//   entry points below refuse bf16.
// - One block barrier a step in both kernels, after the wait for the step's
//   tiles (it also frees the other stage and the score buffers of the step
//   before), and one barrier of the two warps that share score rows after
//   P and dS are written (bar.sync with 64 threads). dK/dV keeps P and dS in
//   two buffers, so dV += P^T dO and dK += dS^T Q both follow that barrier.
// - Blocks: dQ, one per (b, q head, 64-row q tile), 128 threads at D <= 64,
//   113 KB of shared memory, two blocks an SM; dK/dV, one per (b, kv
//   head, 128-key tile) at D <= 64 (64 keys at D = 96 and 128), 256
//   threads, 193 KB at D = 64, one block an SM. dK/dV loops over the G q
//   heads of its kv head and the q tiles that see its keys and owns its
//   rows; dQ owns its rows and also writes delta = rowsum(dO * O): no
//   atomics, and two runs give the same bits.
// - Order: the tile index is the grid's slow axis, so the heaviest causal
//   tiles (the last q tiles for dQ, the first key tiles for dK/dV) are
//   dispatched first. The inner loops are unrolled 4 times.
// What still bounds it: the three loops of dQ and the four of dK/dV take
// most of a warp's cycles (a clock64 count by phase, in an instrumented
// build that is not kept) and run well below the FMA rate: their 12
// LDS.128 per 128 FMAs keep the shared memory busy for most of the cycles
// the FMAs need, and two warps a scheduler do not hide the loads' latency.
// ptxas (sm_90a, fp32, D = 64): bwd_dq 240 registers, bwd_dkdv 230, no
// spills; 2 and 1 blocks an SM (flash_attn_blocks_per_sm).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BQ = 64;     // q rows per tile
constexpr int BK = 64;     // kv rows per tile

static_assert(BQ == BK, "the score tiles are 64 columns wide in every kernel");

__device__ __forceinline__ bool visible(int qp, int kp, int kv_len, int causal, int window) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

__device__ __forceinline__ int ceil_div_pos(int n, int d) { return n <= 0 ? 0 : (n + d - 1) / d; }

// kv tiles [lo, hi) that the q tile starting at q0 visits.
__device__ __forceinline__ void kv_tiles(int q0, int kv_len, int causal, int window, int& lo,
                                         int& hi) {
  hi = (kv_len + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  lo = window > 0 ? ceil_div_pos(q0 - window + 2 - BK, BK) : 0;
}

// -------------------------------------------------------------------- tiles
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
  static constexpr int NW = NO >= 4 ? NO / 4 * 4 : 0;  // of them in whole chunks
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

// Output columns of a thread: NW of them in whole chunks ox + 16 g (NW = NO
// rounded down to a multiple of 4, 0 where NO < 4), then the other NO - NW
// as columns 16 NW + ox (NO - NW) + e - NW. D = 64 and 128 are whole chunks;
// D = 16 and 32 the columns ox NO + e; D = 96 takes chunk ox (columns 4 ox
// .. 4 ox + 3) and columns 64 + 2 ox and 64 + 2 ox + 1.
template <int D>
__device__ __forceinline__ int out_col(int ox, int e) {
  constexpr int NO = BwdCfg<D>::NO, NW = BwdCfg<D>::NW;
  if (e < NW) return ((ox + 16 * (e >> 2)) << 2) + (e & 3);
  return 16 * NW + ox * (NO - NW) + (e - NW);
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

// Rows [r0, r0 + ROWS) of a row-major [L, D] matrix into a tile;
// rows at or past L are zero. Thread t copies chunks t + NTH m, whose places
// do not depend on r0. 16-byte aligned rows go by cp.async (the caller
// commits and waits); others are stored by the threads.
template <int D, int ROWS, int NTH, int SH>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int r0, int L,
                                           bool async_ok) {
  constexpr int C4 = D / 4, N = ROWS * C4 / NTH;
  static_assert(ROWS * C4 % NTH == 0, "every thread copies the same number of chunks");
  const float* base = src + (size_t)r0 * D;
  const bool whole = r0 + ROWS <= L;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int idx = threadIdx.x + NTH * m, r = idx / C4, c4 = idx % C4;
    float* d = dst + sw<D, SH>(r, c4);
    const float* s = base + r * D + c4 * 4;
    if (!whole && r0 + r >= L) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (async_ok) {
      cp_async16(d, s);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
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
  constexpr int MR = BwdCfg<D>::MR, SH = BwdCfg<D>::SH;
  constexpr int NO = BwdCfg<D>::NO, NW = BwdCfg<D>::NW;
#pragma unroll 4
  for (int c4 = 0; c4 < BK / 4; ++c4) {
    float4 a[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) a[i] = chunk<BK, SH>(P, pl.r0 + i, c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = c4 * 4 + cc;
      float x[NO];
#pragma unroll
      for (int g = 0; g < NW / 4; ++g) {
        const float4 v = chunk<D, 2>(X, c, pl.ox + 16 * g);
        x[4 * g] = v.x;
        x[4 * g + 1] = v.y;
        x[4 * g + 2] = v.z;
        x[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int e = NW; e < NO; ++e) {
        const int col = out_col<D>(pl.ox, e);
        x[e] = X[sw<D, 2>(c, col >> 2) + (col & 3)];
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
__device__ __forceinline__ void tile_block(int n_tiles, bool reverse, int& tile, int& bh) {
  bh = blockIdx.x;
  tile = reverse ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
}
inline dim3 tile_grid(int n_tiles, int n_heads) { return dim3(n_heads, n_tiles); }

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

// ------------------------------------------------------------------ forward
// One block per (b, q head, 64-row q tile) of FWD_NT = 128 threads; Q stays
// and K, V stream through the ring. Warp w owns q rows 16 w .. 16 w + 15
// whole, so the online softmax's row max and row sum stay inside a warp and
// P is written and read by the same warp. Lane (ty, tx) = (lane / 8,
// lane % 8) owns q rows r0 + i, r0 = 16 w + 4 ty, the score columns of
// chunks tx and tx + 8 (fwd_kcol) and the output columns fwd_col(tx, e).
// Every tile is swizzled with SH = 2: the 4 rows of Q and P and the 8 rows
// of K that a warp reads at once get different keys.
constexpr int FWD_MR = 4;                        // q rows of a thread
constexpr int FWD_NT = 32 * BQ / (4 * FWD_MR);   // 128: 4 warps of 16 rows

// Score column j (of 8) of the thread in lane column tx.
__device__ __forceinline__ int fwd_kcol(int tx, int j) { return 4 * (tx + 8 * (j >> 2)) + (j & 3); }

// Output column e of the thread in lane column tx: whole chunks tx + 8 g
// where a thread owns 4 columns or more, else columns tx * NO + e.
template <int D>
__device__ __forceinline__ int fwd_col(int tx, int e) {
  constexpr int NO = D / 8;
  if constexpr (NO >= 4) return ((tx + 8 * (e >> 2)) << 2) + (e & 3);
  else return tx * NO + e;
}

// s[i][j] = sum_d Q[r0 + i][d] K[fwd_kcol(tx, j)][d]: 12 LDS.128 per 128
// FMAs.
template <int D>
__device__ __forceinline__ void fwd_dots(const float* Qs, const float* Ks, int r0, int tx,
                                         float (&s)[FWD_MR][8]) {
#pragma unroll
  for (int i = 0; i < FWD_MR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 a[FWD_MR], b[8];
#pragma unroll
    for (int i = 0; i < FWD_MR; ++i) a[i] = chunk<D, 2>(Qs, r0 + i, d4);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = chunk<D, 2>(Ks, fwd_kcol(tx, j), d4);
#pragma unroll
    for (int i = 0; i < FWD_MR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][e] += sum_c P[r0 + i][c] V[c][fwd_col(tx, e)] over the 64 columns
// of P: 12 LDS.128 per 128 FMAs at D = 64.
template <int D>
__device__ __forceinline__ void fwd_product(const float* Ps, const float* Vs, int r0, int tx,
                                            float (&acc)[FWD_MR][D / 8]) {
  constexpr int NO = D / 8;
#pragma unroll 4
  for (int c4 = 0; c4 < BK / 4; ++c4) {
    float4 a[FWD_MR];
#pragma unroll
    for (int i = 0; i < FWD_MR; ++i) a[i] = chunk<BK, 2>(Ps, r0 + i, c4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = c4 * 4 + cc;
      float x[NO];
      if constexpr (NO >= 4) {
#pragma unroll
        for (int g = 0; g < NO / 4; ++g) {
          const float4 v = chunk<D, 2>(Vs, c, tx + 8 * g);
          x[4 * g] = v.x;
          x[4 * g + 1] = v.y;
          x[4 * g + 2] = v.z;
          x[4 * g + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < NO; ++e) {
          const int col = fwd_col<D>(tx, e);
          x[e] = Vs[sw<D, 2>(c, col >> 2) + (col & 3)];
        }
      }
#pragma unroll
      for (int i = 0; i < FWD_MR; ++i) {
        const float p = lane(a[i], cc);
#pragma unroll
        for (int e = 0; e < NO; ++e) acc[i][e] = fmaf(p, x[e], acc[i][e]);
      }
    }
  }
}

// The scores are kept in log2 units, s * scale * log2(e), with masked ones
// at NEG_INF as they are (so a row that has seen no visible key yet weighs
// its masked keys alike, as the plain version does), and lse is written in
// natural units.
template <int D>
__global__ void __launch_bounds__(FWD_NT, 2) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale, int async_ok) {
  constexpr int MR = FWD_MR, NO = D / 8, NTH = FWD_NT, TILE = BQ * D;
  extern __shared__ float4 fwd_tiles[];
  float* Qs = reinterpret_cast<float*>(fwd_tiles);  // [BQ][D]
  float* KVs = Qs + TILE;                           // 2 stages of [BK][D] K, [BK][D] V
  float* Ps = KVs + 4 * TILE;                       // [BQ][BK]
  const int lane_id = threadIdx.x & 31, tx = lane_id & 7;
  const int r0 = 16 * (threadIdx.x >> 5) + 4 * (lane_id >> 3);
  const float scale_log2 = scale * LOG2E;
  int u, bh;
  tile_block((Lq + BQ - 1) / BQ, causal != 0, u, bh);
  const int q0 = u * BQ;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;

  int lo, hi;
  kv_tiles(q0, kv_len, causal, window, lo, hi);
  stage_tile<D, BQ, NTH, 2>(Qs, q + q_off, q0, Lq, async_ok);
  if (lo < hi) {
    stage_tile<D, BK, NTH, 2>(KVs, k + kv_off, lo * BK, Lk, async_ok);
    stage_tile<D, BK, NTH, 2>(KVs + TILE, v + kv_off, lo * BK, Lk, async_ok);
  }
  cp_async_commit();

  float m[MR], l[MR], acc[MR][NO];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[i][e] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    const float* Ks = KVs + ((t - lo) & 1) * 2 * TILE;
    const float* Vs = Ks + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    if (t + 1 < hi) {
      float* nxt = KVs + ((t + 1 - lo) & 1) * 2 * TILE;
      stage_tile<D, BK, NTH, 2>(nxt, k + kv_off, k0 + BK, Lk, async_ok);
      stage_tile<D, BK, NTH, 2>(nxt + TILE, v + kv_off, k0 + BK, Lk, async_ok);
    }
    cp_async_commit();

    // no mask inside the tile: every key before every query, none past kv_len
    const bool full = (!causal || k0 + BK - 1 <= q0) && window <= 0 && k0 + BK <= kv_len;
    float s[MR][8];
    fwd_dots<D>(Qs, Ks, r0, tx, s);
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int qp = q0 + r0 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool vis = full || visible(qp, k0 + fwd_kcol(tx, j), kv_len, causal, window);
        s[i][j] = vis ? s[i][j] * scale_log2 : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      // over the row's 8 lanes
#pragma unroll
      for (int x = 1; x < 8; x <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      const float mn = fmaxf(m[i], mt);
      const float corr = exp2f(m[i] - mn);
      float p[8], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j] = exp2f(s[i][j] - mn);
        rs += p[j];
      }
      l[i] = fmaf(l[i], corr, rs);  // this thread's columns only; summed at the end
      m[i] = mn;
      chunk_ref<BK, 2>(Ps, r0 + i, tx) = make_float4(p[0], p[1], p[2], p[3]);
      chunk_ref<BK, 2>(Ps, r0 + i, tx + 8) = make_float4(p[4], p[5], p[6], p[7]);
#pragma unroll
      for (int e = 0; e < NO; ++e) acc[i][e] *= corr;
    }
    __syncwarp();  // the warp's rows of P are written
    fwd_product<D>(Ps, Vs, r0, tx, acc);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    float li = l[i];
#pragma unroll
    for (int x = 1; x < 8; x <<= 1) li += __shfl_xor_sync(0xffffffffu, li, x);
    const int qp = q0 + r0 + i;
    if (qp >= Lq) continue;
    const float lm = fmaxf(li, 1e-30f);
#pragma unroll
    for (int e = 0; e < NO; ++e)
      o[q_off + (size_t)qp * D + fwd_col<D>(tx, e)] = acc[i][e] / lm;
    if (tx == 0) lse[(size_t)bh * Lq + qp] = (m[i] == NEG_INF ? NEG_INF : m[i] * LN2) + logf(li);
  }
}

// ------------------------------------------------------------ backward: dQ
// One block per (b, q head, 64-row q tile); Q and dO stay, K and V stream
// through the ring. A thread owns q rows r0 + i, the score columns of chunk
// ox and dQ columns out_col(ox, e). Also writes delta = rowsum(dO * O),
// which the dK/dV kernel (launched after it on the same stream) reads.
template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::DQ_NT, 1) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv, int Lq, int Lk, int kv_len,
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
  tile_block((Lq + BQ - 1) / BQ, causal != 0, u, bh);
  const int q0 = u * BQ;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;

  int lo, hi;
  kv_tiles(q0, kv_len, causal, window, lo, hi);
  stage_tile<D, BQ, NTH, SH>(Qs, q + q_off, q0, Lq, async_ok);
  stage_tile<D, BQ, NTH, SH>(dOs, dout + q_off, q0, Lq, async_ok);
  if (lo < hi) {
    stage_tile<D, BK, NTH, 2>(KVs, k + kv_off, lo * BK, Lk, async_ok);
    stage_tile<D, BK, NTH, 2>(KVs + TILE, v + kv_off, lo * BK, Lk, async_ok);
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
        x = fmaf(dout[row + c], o[row + c], x);
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
      stage_tile<D, BK, NTH, 2>(nxt, k + kv_off, k0 + BK, Lk, async_ok);
      stage_tile<D, BK, NTH, 2>(nxt + TILE, v + kv_off, k0 + BK, Lk, async_ok);
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
      dq[q_off + (size_t)qp * D + out_col<D>(pl.ox, e)] = acc[i][e] * scale;
  }
}

// --------------------------------------------------------- backward: dK, dV
// One block per (b, kv head, KR-key tile); K and V stay, and the q tiles
// that see the keys, of each of the G q heads of the kv head, stream Q, dO,
// lse and delta through the ring. A thread owns key rows r0 + i, the score
// columns (queries) of chunk ox and dK/dV columns out_col(ox, e): it sums
// over every query that sees its keys, so no atomics.
template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::KV_NT, 1) bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Lq, int Lk, int kv_len,
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
  tile_block((Lk + KR - 1) / KR, false, kt, bhk);
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
    stage_tile<D, BQ, NTH, 2>(dst, q + q_off, q0, Lq, async_ok);
    stage_tile<D, BQ, NTH, 2>(dst + QT, dout + q_off, q0, Lq, async_ok);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      float* d = rows + st * 2 * BQ + tid;
      const float* src = (tid < BQ ? lse : delta) + (size_t)bh * Lq + q0 + r;
      if (q0 + r < Lq) cp_async4(d, src);
      else *d = 0.f;
    }
  };

  stage_tile<D, KR, NTH, SH>(Ks, k + kv_off, k0, Lk, async_ok);
  stage_tile<D, KR, NTH, SH>(Vs, v + kv_off, k0, Lk, async_ok);
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
      dk[idx] = dka[i][e] * scale;
      dv[idx] = dva[i][e];
    }
  }
}

template <int D>
constexpr size_t bwd_dq_smem() { return sizeof(float) * (6 * BQ * D + BQ * BK + 4 * BQ); }
template <int D>
constexpr size_t bwd_dkdv_smem() {
  constexpr int KR = BwdCfg<D>::KR;
  return sizeof(float) * (2 * KR * D + 4 * BQ * D + 2 * KR * BQ + 4 * BQ);
}
static_assert(bwd_dq_smem<128>() <= 232448 && bwd_dkdv_smem<128>() <= 232448 &&
                  bwd_dq_smem<96>() <= 232448 && bwd_dkdv_smem<96>() <= 232448 &&
                  bwd_dkdv_smem<64>() <= 232448,
              "a backward block fits in the 227 KB of shared memory a block can use");

// The kernels ask for the largest shared-memory carveout, so that two
// forward blocks of 96 KB, or two dQ blocks of 112 KB, share an SM.
template <typename K>
cudaError_t prepare_max_shared(K kern, size_t smem) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// cp.async copies 16-byte chunks of fp32 rows: every streamed tensor must
// start on a 16-byte boundary (rows of D floats then do too).
int can_copy_async(const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d;
  return (any & 15) == 0;
}

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * (5 * BQ * D + BQ * BK); }
static_assert(fwd_smem<128>() <= 232448 && fwd_smem<96>() <= 232448,
              "a forward block fits in the 227 KB of shared memory a block can use");

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                cudaStream_t st) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = prepare_max_shared(fwd_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lq + BQ - 1) / BQ, B * Hq);
  fwd_kernel<D><<<grid, FWD_NT, smem, st>>>((const float*)q, (const float*)k, (const float*)v,
                                            (float*)o, lse, Hq, Hkv, Lq, Lk, kv_len, causal,
                                            window, scale, can_copy_async(q, k, v, q));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, float* delta, int B, int Hq, int Hkv, int Lq,
                   int Lk, int kv_len, int causal, int window, float scale, cudaStream_t st) {
  const size_t smem = bwd_dq_smem<D>();
  cudaError_t e = prepare_max_shared(bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lq + BQ - 1) / BQ, B * Hq);
  bwd_dq_kernel<D><<<grid, BwdCfg<D>::DQ_NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      lse, (float*)dq, delta, Hq, Hkv, Lq, Lk, kv_len, causal, window, scale,
      can_copy_async(q, k, v, dout));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                     int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                     cudaStream_t st) {
  const size_t smem = bwd_dkdv_smem<D>();
  cudaError_t e = prepare_max_shared(bwd_dkdv_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lk + BwdCfg<D>::KR - 1) / BwdCfg<D>::KR, B * Hkv);
  bwd_dkdv_kernel<D><<<grid, BwdCfg<D>::KV_NT, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, Hq, Hkv, Lq, Lk, kv_len, causal, window, scale,
      can_copy_async(q, k, v, dout));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, the only type these kernels take: every bf16 product
// is flash_attn_tc.cu's, on the tensor cores, so no bf16 call can land on a
// CUDA-core kernel (1 = bfloat16 is refused). head_dim: 16, 32, 64, 96 or
// 128. Every tensor is contiguous; the caller checks shapes. Returns a
// cudaError_t.
#define FA_DISPATCH_F32(FN, ...)                                              \
  do {                                                                        \
    if (dtype != 0) return (int)cudaErrorInvalidValue;                        \
    switch (head_dim) {                                                       \
      case 16: return (int)FN<16>(__VA_ARGS__);                               \
      case 32: return (int)FN<32>(__VA_ARGS__);                               \
      case 64: return (int)FN<64>(__VA_ARGS__);                               \
      case 96: return (int)FN<96>(__VA_ARGS__);                               \
      case 128: return (int)FN<128>(__VA_ARGS__);                             \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  } while (0)

extern "C" {

int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int Hq, int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                   int window, float scale, int dtype, void* stream) {
  FA_DISPATCH_F32(fwd, q, k, v, o, (float*)lse, B, Hq, Hkv, Lq, Lk, kv_len, causal, window,
                  scale, (cudaStream_t)stream);
}

int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int B, int Hq,
                      int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal, int window,
                      float scale, int dtype, void* stream) {
  FA_DISPATCH_F32(bwd_dq, q, k, v, o, dout, (const float*)lse, dq, (float*)delta, B, Hq, Hkv,
                  Lq, Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
                        int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                        int window, float scale, int dtype, void* stream) {
  FA_DISPATCH_F32(bwd_dkdv, q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, B,
                  Hq, Hkv, Lq, Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

const char* flash_attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Blocks of each kernel that fit on one SM at once, fp32 at head_dim 64 (the
// edl_paper path): the occupancy the design counts on.
int flash_attn_blocks_per_sm(int* fwd_blocks, int* dq_blocks, int* dkdv_blocks) {
  cudaError_t e = prepare_max_shared(fwd_kernel<64>, fwd_smem<64>());
  if (e == cudaSuccess) e = prepare_max_shared(bwd_dq_kernel<64>, bwd_dq_smem<64>());
  if (e == cudaSuccess) e = prepare_max_shared(bwd_dkdv_kernel<64>, bwd_dkdv_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fwd_blocks, fwd_kernel<64>, FWD_NT,
                                                      fwd_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dq_blocks, bwd_dq_kernel<64>,
                                                      BwdCfg<64>::DQ_NT, bwd_dq_smem<64>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dkdv_blocks, bwd_dkdv_kernel<64>, BwdCfg<64>::KV_NT, bwd_dkdv_smem<64>());
  return (int)e;
}

}  // extern "C"
