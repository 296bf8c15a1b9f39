// Flash attention in bf16 on Hopper's tensor cores (sm_90a): the forward and
// the backward as two kernels (dQ, then dK/dV), every product a wgmma with
// fp32 accumulation.
//
// Replaces, for bf16 inputs: src/repro/kernels/attention/kernel.py,
// flash_attention_bhld (pallas_call body _flash_kernel), the TPU
// flash-attention forward; and the dQ and dK/dV kernels of the backward the
// port adds to it (the reference has no backward kernel: the gradient is
// held against jax.vjp of its attention in the tests). fp32 inputs stay with
// the CUDA-core kernels of flash_attn.cu. The dK/dV kernel reads the delta
// that the dQ kernel writes, launched before it on the same stream.
//
// What it computes is what flash_attn.cu computes: q [B,Hq,Lq,D], k/v
// [B,Hkv,Lk,D], q head h reads kv head h / (Hq/Hkv); scores (q.k) * scale,
// masked by k < kv_len, causal q >= k and window (q - k) < window with the
// finite NEG_INF = -1e30; the online (m, l, acc) softmax over kv tiles; out
// = acc / max(l, 1e-30) in bf16 and lse = m + log(l) in fp32. Kv tiles
// past the causal frontier or before the window are skipped whole, and the
// heaviest causal tiles are dispatched first. dQ writes delta =
// rowsum(dO O), recomputes P = exp(S - lse) and dS = P (dP - delta) and sums
// dQ = scale dS K over the kv tiles that its rows see. dK/dV recomputes P^T
// = exp(S^T - lse) and dS^T = P^T (dP^T - delta) and sums dV = P^T dO and
// dK = scale dS^T Q over the G q heads of its kv head and every q tile that
// sees its keys.
//
// Rounding, a deliberate difference from the reference (which upcasts both
// operands of both products to fp32, kernel.py:54-56): the second product's
// A operand, P in the forward, dS in dQ and P^T, dS^T in dK/dV, is rounded
// to bf16 in registers, as every tensor-core flash attention does. Scores,
// the softmax statistics, delta and all sums stay fp32; l sums the
// unrounded P.
//
// The bound: the bf16 tensor-core rate, 989 TFLOP/s dense on an H100 SXM.
// The forward does 4 D flops a visible (query, key) pair (S = Q K^T and
// O += P V), dQ 6 D (S, dP, dQ), dK/dV 8 D (S^T, dP^T, dV, dK). At the
// zoo's shapes (B 4, L 1024, causal) the forward does 250-470 flops a byte
// it must move, dQ 250-370 and dK/dV 340-870, against the bf16 ridge of
// 989e12 / 3.35e12 = 295: the products bound every dK/dV and the GQA
// forwards and dQs (the MHA ones, phi3 and musicgen, sit at the ridge or
// below, bound by bytes), and only wgmma reaches that rate. What the design
// does about it:
// - Every product is a warpgroup wgmma (m64nNk16, N = 16 to 64, fp32
//   accumulators in registers). The first product reads both operands from
//   shared memory through descriptors; the second reads its A operand from
//   registers: P (or dS, P^T, dS^T) is converted from the accumulator layout to
//   wgmma's bf16 A-fragment layout in place (the two layouts agree for
//   16-bit types: accumulator elements (8j .. 8j + 7) of a thread are the
//   A fragment of k-slice j), so no score tile goes through shared memory.
// - Tiles sit in shared memory in panels of 64 bf16 columns, rows of 128
//   bytes, 16-byte chunk c of row r at chunk c ^ (r & 7): the 128-byte
//   swizzle that the descriptors name (layout type 1). D 96 is a whole panel
//   and half of a second; D 16 and 32 fill part of one. The first product
//   reads its operands K-major (rows along d); the second reads V, K, dO or
//   Q MN-major (the same tile, its rows as the contraction), one instruction a
//   panel so that N <= 64 and one 128-byte row spans an instruction's N.
// - cp.async (16 bytes) fills a two-stage ring: the next kv tile (forward,
//   dQ) or q tile (dK/dV) loads while this one computes. After the copies
//   land, fence.proxy.async makes them visible to wgmma, which reads shared
//   memory through the async proxy. The wrapper hands the kernels 16-byte aligned
//   tensors (ops.py copies any that are not); the entry points refuse the
//   rest.
// - The online softmax runs in the accumulator's own layout: a row of S is
//   held by the 4 lanes of a quad, so the row max and row sum are two
//   xor-shuffles.
// - Forward blocks: two consumer warpgroups (256 threads) own 128 q rows of
//   one (b, q head) and share each K and V tile; 64 keys a tile. At D 128
//   that is 32 KB of Q and two stages of 32 KB of K and V, so two blocks
//   share an SM, and the launch bounds hold a thread to 128 registers so
//   that they do: with each warpgroup waiting for its own products, the
//   four warpgroups of an SM are what keeps the tensor cores fed (one block
//   an SM, 150 registers and no spill, took 1.2-1.4x as long at the zoo's D 96-128
//   shapes; tools/torch_kernel_bench.py on an H100 80GB HBM3 at 700 W,
//   which also prints the registers and spills of each build).
// - dK/dV blocks: one warpgroup owns 64 keys of one (b, kv head) and walks
//   the G q heads and the q tiles (64 rows) that see them. Every block owns
//   its output rows, so no atomics: two runs give the same bits. 64-key
//   tiles give 256 blocks at starcoder2's B 4 x Hkv 4 x L 1024, two an SM
//   (255 registers a thread at D 128).
// - dQ blocks: as the forward's, two warpgroups own 128 q rows of one (b, q
//   head), Q and dO stay in shared memory and each K and V tile is shared;
//   a thread's two rows are fixed, so lse and delta are two registers each.
//   32 keys a tile (DQ_BN): at D 128, 97 KB of shared memory and 126
//   registers (launch bounds (256, 2)), two blocks an SM. 64-key tiles (129
//   KB, 167 registers, one block an SM) took 1.07-1.17x as long at the
//   zoo's shapes (tools/torch_kernel_bench.py --variant, in turns, on an H100
//   80GB HBM3 at 700 W). delta is summed first, from O in global memory and
//   the staged dO, over each row's quad in a fixed order; every block owns
//   its rows, so two runs give the same bits.
// TMA and warp specialisation are left out: the loads are the threads' own
// cp.async, and each warpgroup waits for its products before the softmax.
//
// Offsets: every element offset into a global tensor is formed in size_t
// from a (batch, head) row, so q, k and v may hold 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG = 128;            // threads of a warpgroup
constexpr int FWD_WGS = 2;         // warpgroups of a forward block
constexpr int BM = 64 * FWD_WGS;   // q rows of a forward or dQ block
constexpr int FWD_BN = 64;         // keys of a forward kv tile
constexpr int BN = 64;             // q rows of a dK/dV q tile
constexpr int KT = 64;             // keys of a dK/dV block
constexpr int DQ_WGS = FWD_WGS;    // warpgroups of a dQ block, 64 of its BM rows each
constexpr int DQ_BN = 32;          // keys of a dQ kv tile
// dQ blocks an SM that the launch bounds hold registers for: two at 32-key
// tiles (97 KB of shared memory at D 128), one at 64 (129 KB)
constexpr int DQ_MIN_BLOCKS = DQ_BN <= 32 ? 2 : 1;

using bf16 = __nv_bfloat16;

// A row of D bf16 in 64-column panels: panel p holds columns 64 p .. 64 p
// + W(p) - 1.
template <int D>
struct Panels {
  static constexpr int N = (D + 63) / 64;
  static constexpr int W0 = D < 64 ? D : 64;
  static constexpr int W1 = D > 64 ? D - 64 : 0;
  // accumulator registers of a thread for panel 1 (8 where there is none,
  // so that the array exists)
  static constexpr int R1 = W1 > 0 ? W1 / 2 : 8;
};

// Byte offset of 16-byte chunk c (columns 8 c .. 8 c + 7) of row r in a tile
// of R rows: panel c / 8, then the 128-byte swizzle inside the panel.
template <int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (uint32_t)((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ bool visible(int qp, int kp, int kv_len, int causal, int window) {
  bool ok = kp < kv_len;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

__device__ __forceinline__ int ceil_div_pos(int n, int d) { return n <= 0 ? 0 : (n + d - 1) / d; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory from its first 1024-byte boundary, where the
// 128-byte swizzle's pattern starts (the launch asks for 1 KB more).
__device__ __forceinline__ char* smem_1k(void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<char*>(p) + (((a + 1023u) & ~1023u) - a);
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

// The threads' shared-memory writes (cp.async included) visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers that a wgmma in flight reads or writes: the compiler may not
// move their other uses across these points (each is placed after a wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows r0 .. of a tile of R rows (64 of them for A, N for
// B), columns 16 j .. 16 j + 15 (k-slice j). Eight-row groups are 1024 bytes
// apart; a k-slice is 32 bytes into its panel's rows.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int j) {
  return make_desc(tile + (j >> 2) * R * 128 + r0 * 128 + (j & 3) * 32, 16, 1024);
}
// MN-major operand: rows k0 .. k0 + 15 of a tile of R rows as the
// contraction, the columns of panel p as N (at most 64, one 128-byte row).
// Eight-row groups along the contraction are 1024 bytes apart; both offsets
// hold it, since N never reaches the next panel.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k0, int p) {
  return make_desc(tile + p * R * 128 + k0 * 128, 1024, 1024);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32, N = 2 x the accumulator registers.
// wgmma_ss: A and B from shared memory, both K-major. wgmma_rs: A from
// registers, B from shared memory, MN-major. acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragments of a 64 x 2N score tile held in a thread's accumulator
// registers s (m64n{2N} layout), k-slice j = columns 16 j .. 16 j + 15, in
// bf16: registers 8 j .. 8 j + 7 are rows (g, g + 8) x columns (2 t, 2 t + 8)
// of the slice, in the order the A fragment wants them.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

// Rows [r0, r0 + R) of a row-major [L, D] bf16 matrix into a tile of R rows
// by cp.async; rows at or past L are zero. Thread t of NTH copies chunks t,
// t + NTH, ...; the caller commits and waits.
template <int D, int R, int NTH>
__device__ __forceinline__ void stage_rows(char* tile, const bf16* rows, int r0, int L, int t) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = t; idx < R * CH; idx += NTH) {
    const int r = idx / CH, c = idx % CH;
    char* dst = tile + chunk_off<R>(r, c);
    if (r0 + r < L) cp_async16(dst, rows + (size_t)(r0 + r) * D + c * 8);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The block's tile index and its (batch, head) row; the tile is the grid's
// slow axis, walked from the heaviest end with ``reverse``.
__device__ __forceinline__ void tile_block(int n_tiles, bool reverse, int& tile, int& bh) {
  bh = blockIdx.x;
  tile = reverse ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
}
inline dim3 tile_grid(int n_tiles, int n_heads) { return dim3(n_heads, n_tiles); }

// Accumulator element e of a thread of an m64nN wgmma (warp w of the
// warpgroup, lane 4 g + t): row 16 w + g + 8 ((e / 2) & 1), column
// 8 (e / 4) + 2 t + (e & 1).
__device__ __forceinline__ int acc_col(int e, int t) { return 8 * (e >> 2) + 2 * t + (e & 1); }
__device__ __forceinline__ int acc_half(int e) { return (e >> 1) & 1; }

// ------------------------------------------------------------------ forward
template <int D>
constexpr size_t fwd_tc_smem() {
  return 1024 + (size_t)Panels<D>::N * 128 * (BM + 4 * FWD_BN);
}

template <int D>
__global__ void __launch_bounds__(FWD_WGS * WG, 2) fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale) {
  using P = Panels<D>;
  constexpr int NTH = FWD_WGS * WG, QB = P::N * 128 * BM, KB = P::N * 128 * FWD_BN;
  constexpr int NS = FWD_BN / 2;   // score registers of a thread
  extern __shared__ float4 fa_tc_smem[];
  char* Qs = smem_1k(fa_tc_smem);  // [BM][D]
  char* KVs = Qs + QB;             // 2 stages of [FWD_BN][D] K, [FWD_BN][D] V
  const uint32_t Qa = smem_u32(Qs), KVa = smem_u32(KVs);
  const int tid = threadIdx.x, wg = tid / WG, w = (tid % WG) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;
  int u, bh;
  tile_block((Lq + BM - 1) / BM, causal != 0, u, bh);
  const int q0 = u * BM;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;
  // this thread's two q rows
  const int qrow[2] = {q0 + 64 * wg + 16 * w + g, q0 + 64 * wg + 16 * w + g + 8};

  // kv tiles [lo, hi) that some row of the block sees
  int hi = (kv_len + FWD_BN - 1) / FWD_BN;
  if (causal) hi = min(hi, (q0 + BM - 1) / FWD_BN + 1);
  const int lo = window > 0 ? ceil_div_pos(q0 - window + 2 - FWD_BN, FWD_BN) : 0;

  stage_rows<D, BM, NTH>(Qs, q + q_off, q0, Lq, tid);
  if (lo < hi) {
    stage_rows<D, FWD_BN, NTH>(KVs, k + kv_off, lo * FWD_BN, Lk, tid);
    stage_rows<D, FWD_BN, NTH>(KVs + KB, v + kv_off, lo * FWD_BN, Lk, tid);
  }
  cp_async_commit();

  float o0[P::W0 / 2], o1[P::R1], m[2], l[2];
#pragma unroll
  for (int e = 0; e < P::W0 / 2; ++e) o0[e] = 0.f;
#pragma unroll
  for (int e = 0; e < P::R1; ++e) o1[e] = 0.f;
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * FWD_BN, st = (t - lo) & 1;
    const uint32_t Ka = KVa + st * 2 * KB, Va = Ka + KB;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in; every warpgroup is done with tile t - 1
    if (t + 1 < hi) {
      char* nxt = KVs + (st ^ 1) * 2 * KB;
      stage_rows<D, FWD_BN, NTH>(nxt, k + kv_off, k0 + FWD_BN, Lk, tid);
      stage_rows<D, FWD_BN, NTH>(nxt + KB, v + kv_off, k0 + FWD_BN, Lk, tid);
    }
    cp_async_commit();

    // S = Q K^T over d
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss(s, desc_k<BM>(Qa, 64 * wg, j), desc_k<FWD_BN>(Ka, 0, j), j > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // no mask inside the tile: every key before every query, none past kv_len
    const bool full =
        (!causal || k0 + FWD_BN - 1 <= q0) && window <= 0 && k0 + FWD_BN <= kv_len;
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int hf = acc_half(e);
      const bool vis = full || visible(qrow[hf], k0 + acc_col(e, t4), kv_len, causal, window);
      s[e] = vis ? s[e] * scale_log2 : NEG_INF;
      mt[hf] = fmaxf(mt[hf], s[e]);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // over the row's quad
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
      const float mn = fmaxf(m[hf], mt[hf]);
      corr[hf] = exp2f(m[hf] - mn);
      m[hf] = mn;
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      s[e] = exp2f(s[e] - m[acc_half(e)]);
      rs[acc_half(e)] += s[e];
    }
    // this thread's columns only; summed over the quad at the end
    l[0] = fmaf(l[0], corr[0], rs[0]);
    l[1] = fmaf(l[1], corr[1], rs[1]);
#pragma unroll
    for (int e = 0; e < P::W0 / 2; ++e) o0[e] *= corr[acc_half(e)];
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int e = 0; e < P::R1; ++e) o1[e] *= corr[acc_half(e)];
    }

    // O += P V over the tile's keys, P in bf16 from registers
    uint32_t pa[NS / 8][4];
    to_a_frags(s, pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) wgmma_rs(o0, pa[j], desc_mn<FWD_BN>(Va, 16 * j, 0), 1);
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) wgmma_rs(o1, pa[j], desc_mn<FWD_BN>(Va, 16 * j, 1), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o0);
    fence_regs(o1);
    fence_regs(pa);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qrow[hf];
    if (qp >= Lq) continue;
    const float inv = 1.f / fmaxf(l[hf], 1e-30f);
    bf16* orow = o + q_off + (size_t)qp * D;
#pragma unroll
    for (int e = 2 * hf; e < P::W0 / 2; e += 4)
      *reinterpret_cast<uint32_t*>(orow + acc_col(e, t4)) = pack_bf16(o0[e] * inv, o0[e + 1] * inv);
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int e = 2 * hf; e < P::R1; e += 4)
        *reinterpret_cast<uint32_t*>(orow + 64 + acc_col(e, t4)) =
            pack_bf16(o1[e] * inv, o1[e + 1] * inv);
    }
    if (t4 == 0)
      lse[(size_t)bh * Lq + qp] = (m[hf] == NEG_INF ? NEG_INF : m[hf] * LN2) + logf(l[hf]);
  }
}

// --------------------------------------------------------- backward: dK, dV
template <int D>
constexpr size_t bwd_dkdv_tc_smem() {
  return 1024 + (size_t)Panels<D>::N * 128 * (2 * KT + 4 * BN) + 4 * 4 * BN;
}

template <int D>
__global__ void __launch_bounds__(WG, 2) bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv, int Lq, int Lk, int kv_len,
    int causal, int window, float scale) {
  using P = Panels<D>;
  constexpr int KB = P::N * 128 * KT, QB = P::N * 128 * BN;
  extern __shared__ float4 fa_tc_smem[];
  char* Ks = smem_1k(fa_tc_smem);  // [KT][D]
  char* Vs = Ks + KB;              // [KT][D]
  char* QdO = Vs + KB;             // 2 stages of [BN][D] Q, [BN][D] dO
  float* rows = reinterpret_cast<float*>(QdO + 4 * QB);  // 2 stages of [BN] lse, [BN] delta
  const uint32_t Ka = smem_u32(Ks), Va = smem_u32(Vs), QdOa = smem_u32(QdO);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;
  int kt, bhk;
  tile_block((Lk + KT - 1) / KT, false, kt, bhk);
  const int k0 = kt * KT;
  const int b = bhk / Hkv, hk = bhk % Hkv, G = Hq / Hkv;
  const size_t kv_off = (size_t)bhk * Lk * D;
  const int krow[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};  // this thread's two keys

  // q tiles [lo, hi) that see some key of the block (the pairs the forward
  // visits)
  int hi = (Lq + BN - 1) / BN;
  const int lo = causal ? ceil_div_pos(k0 - BN + 1, BN) : 0;
  if (window > 0) hi = min(hi, (k0 + KT + window - 2) / BN + 1);
  if (k0 >= kv_len) hi = lo;
  const int n_u = hi - lo, n_it = G * n_u;
  // step it is q tile lo + it % n_u of q head hk G + it / n_u
  auto stage_step = [&](int it, int st) {
    const int bh = b * Hq + hk * G + it / n_u, q0 = (lo + it % n_u) * BN;
    const size_t q_off = (size_t)bh * Lq * D;
    char* Qd = QdO + st * 2 * QB;
    stage_rows<D, BN, WG>(Qd, q + q_off, q0, Lq, tid);
    stage_rows<D, BN, WG>(Qd + QB, dout + q_off, q0, Lq, tid);
    const int r = tid % BN;
    float* dst = rows + st * 2 * BN + tid;
    const float* src = (tid < BN ? lse : delta) + (size_t)bh * Lq + q0 + r;
    if (q0 + r < Lq) cp_async4(dst, src);
    else *dst = 0.f;
  };

  stage_rows<D, KT, WG>(Ks, k + kv_off, k0, Lk, tid);
  stage_rows<D, KT, WG>(Vs, v + kv_off, k0, Lk, tid);
  if (n_it > 0) stage_step(0, 0);
  cp_async_commit();

  float dk0[P::W0 / 2], dk1[P::R1], dv0[P::W0 / 2], dv1[P::R1];
#pragma unroll
  for (int e = 0; e < P::W0 / 2; ++e) dk0[e] = dv0[e] = 0.f;
#pragma unroll
  for (int e = 0; e < P::R1; ++e) dk1[e] = dv1[e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (lo + it % n_u) * BN;
    const uint32_t Qa = QdOa + st * 2 * QB, dOa = Qa + QB;
    const float* lse_s = rows + st * 2 * BN;
    const float* dl_s = lse_s + BN;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // step it is in; the products of step it - 1 are done
    if (it + 1 < n_it) stage_step(it + 1, st ^ 1);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T over d: rows are keys, columns queries
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wgmma_ss(s, desc_k<KT>(Ka, 0, j), desc_k<BN>(Qa, 0, j), j > 0);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss(dp, desc_k<KT>(Va, 0, j), desc_k<BN>(dOa, 0, j), j > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta), lse and delta by column
    const bool full = (!causal || k0 + KT - 1 <= q0) && window <= 0 && k0 + KT <= kv_len &&
                      q0 + BN <= Lq;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = acc_col(e, t4), qp = q0 + c;
      const bool vis =
          full || (qp < Lq && visible(qp, krow[acc_half(e)], kv_len, causal, window));
      const float p = exp2f(vis ? fmaf(s[e], scale_log2, -lse_s[c] * LOG2E) : NEG_INF);
      s[e] = p;
      dp[e] = p * (dp[e] - dl_s[c]);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries, A in bf16 from
    // registers
    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(dv0, pa[j], desc_mn<BN>(dOa, 16 * j, 0), 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(dk0, da[j], desc_mn<BN>(Qa, 16 * j, 0), 1);
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(dv1, pa[j], desc_mn<BN>(dOa, 16 * j, 1), 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(dk1, da[j], desc_mn<BN>(Qa, 16 * j, 1), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv0);
    fence_regs(dk0);
    fence_regs(dv1);
    fence_regs(dk1);
    fence_regs(pa);
    fence_regs(da);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = krow[hf];
    if (kp >= Lk) continue;
    const size_t row = kv_off + (size_t)kp * D;
#pragma unroll
    for (int e = 2 * hf; e < P::W0 / 2; e += 4) {
      const int c = acc_col(e, t4);
      *reinterpret_cast<uint32_t*>(dk + row + c) = pack_bf16(dk0[e] * scale, dk0[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + c) = pack_bf16(dv0[e], dv0[e + 1]);
    }
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int e = 2 * hf; e < P::R1; e += 4) {
        const int c = 64 + acc_col(e, t4);
        *reinterpret_cast<uint32_t*>(dk + row + c) =
            pack_bf16(dk1[e] * scale, dk1[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + c) = pack_bf16(dv1[e], dv1[e + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ backward: dQ
template <int D>
constexpr size_t bwd_dq_tc_smem() {
  return 1024 + (size_t)Panels<D>::N * 128 * (2 * BM + 4 * DQ_BN);
}

template <int D>
__global__ void __launch_bounds__(DQ_WGS * WG, DQ_MIN_BLOCKS) bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv, int Lq, int Lk,
    int kv_len, int causal, int window, float scale) {
  using P = Panels<D>;
  constexpr int NTH = DQ_WGS * WG, QB = P::N * 128 * BM, KB = P::N * 128 * DQ_BN;
  constexpr int NS = DQ_BN / 2;    // score registers of a thread
  extern __shared__ float4 fa_tc_smem[];
  char* Qs = smem_1k(fa_tc_smem);  // [BM][D]
  char* dOs = Qs + QB;             // [BM][D]
  char* KVs = dOs + QB;            // 2 stages of [DQ_BN][D] K, [DQ_BN][D] V
  const uint32_t Qa = smem_u32(Qs), dOa = smem_u32(dOs), KVa = smem_u32(KVs);
  const int tid = threadIdx.x, wg = tid / WG, w = (tid % WG) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;
  int u, bh;
  tile_block((Lq + BM - 1) / BM, causal != 0, u, bh);
  const int q0 = u * BM;
  const int b = bh / Hq, h = bh % Hq, G = Hq / Hkv;
  const size_t q_off = (size_t)bh * Lq * D;
  const size_t kv_off = ((size_t)b * Hkv + h / G) * Lk * D;
  // this thread's two q rows, fixed for the whole block, and their rows in
  // the block's tiles
  const int rloc[2] = {64 * wg + 16 * w + g, 64 * wg + 16 * w + g + 8};
  const int qrow[2] = {q0 + rloc[0], q0 + rloc[1]};

  // kv tiles [lo, hi) that some row of the block sees
  int hi = (kv_len + DQ_BN - 1) / DQ_BN;
  if (causal) hi = min(hi, (q0 + BM - 1) / DQ_BN + 1);
  const int lo = window > 0 ? ceil_div_pos(q0 - window + 2 - DQ_BN, DQ_BN) : 0;

  stage_rows<D, BM, NTH>(Qs, q + q_off, q0, Lq, tid);
  stage_rows<D, BM, NTH>(dOs, dout + q_off, q0, Lq, tid);
  if (lo < hi) {
    stage_rows<D, DQ_BN, NTH>(KVs, k + kv_off, lo * DQ_BN, Lk, tid);
    stage_rows<D, DQ_BN, NTH>(KVs + KB, v + kv_off, lo * DQ_BN, Lk, tid);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) over each of the thread's rows: its columns 8 j +
  // 2 t4 and 8 j + 2 t4 + 1 (the ones it stores dQ at), O from global memory
  // and dO from the staged tile, then over the row's quad in a fixed order;
  // lse in log2 units
  float dl[2], lse2[2];
  {
    __nv_bfloat162 ov[2][D / 8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const bf16* orow = o + q_off + (size_t)qrow[hf] * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        ov[hf][j] = qrow[hf] < Lq ? *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * j)
                                  : __floats2bfloat162_rn(0.f, 0.f);
      lse2[hf] = qrow[hf] < Lq ? lse[(size_t)bh * Lq + qrow[hf]] * LOG2E : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // Q, dO and kv tile lo are in
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 a =
            *reinterpret_cast<const __nv_bfloat162*>(dOs + chunk_off<BM>(rloc[hf], j) + 4 * t4);
        x = fmaf(__bfloat162float(a.x), __bfloat162float(ov[hf][j].x), x);
        x = fmaf(__bfloat162float(a.y), __bfloat162float(ov[hf][j].y), x);
      }
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      dl[hf] = x;
      if (t4 == 0 && qrow[hf] < Lq) delta[(size_t)bh * Lq + qrow[hf]] = x;
    }
  }

  float dq0[P::W0 / 2], dq1[P::R1];
#pragma unroll
  for (int e = 0; e < P::W0 / 2; ++e) dq0[e] = 0.f;
#pragma unroll
  for (int e = 0; e < P::R1; ++e) dq1[e] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * DQ_BN, st = (t - lo) & 1;
    const uint32_t Ka = KVa + st * 2 * KB, Va = Ka + KB;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in; every warpgroup is done with tile t - 1
    if (t + 1 < hi) {
      char* nxt = KVs + (st ^ 1) * 2 * KB;
      stage_rows<D, DQ_BN, NTH>(nxt, k + kv_off, k0 + DQ_BN, Lk, tid);
      stage_rows<D, DQ_BN, NTH>(nxt + KB, v + kv_off, k0 + DQ_BN, Lk, tid);
    }
    cp_async_commit();

    // S = Q K^T and dP = dO V^T over d
    float s[NS], dp[NS];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss(s, desc_k<BM>(Qa, 64 * wg, j), desc_k<DQ_BN>(Ka, 0, j), j > 0);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wgmma_ss(dp, desc_k<BM>(dOa, 64 * wg, j), desc_k<DQ_BN>(Va, 0, j), j > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S - lse), dS = P (dP - delta); no mask inside the tile: every
    // key before every query, none past kv_len
    const bool full =
        (!causal || k0 + DQ_BN - 1 <= q0) && window <= 0 && k0 + DQ_BN <= kv_len;
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int hf = acc_half(e);
      const bool vis = full || visible(qrow[hf], k0 + acc_col(e, t4), kv_len, causal, window);
      const float p = exp2f(vis ? fmaf(s[e], scale_log2, -lse2[hf]) : NEG_INF);
      dp[e] = p * (dp[e] - dl[hf]);
    }

    // dQ += dS K over the tile's keys, dS in bf16 from registers, K read
    // MN-major
    uint32_t da[NS / 8][4];
    to_a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) wgmma_rs(dq0, da[j], desc_mn<DQ_BN>(Ka, 16 * j, 0), 1);
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) wgmma_rs(dq1, da[j], desc_mn<DQ_BN>(Ka, 16 * j, 1), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(da);
  }
  cp_async_wait_all();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qrow[hf];
    if (qp >= Lq) continue;
    bf16* row = dq + q_off + (size_t)qp * D;
#pragma unroll
    for (int e = 2 * hf; e < P::W0 / 2; e += 4)
      *reinterpret_cast<uint32_t*>(row + acc_col(e, t4)) =
          pack_bf16(dq0[e] * scale, dq0[e + 1] * scale);
    if constexpr (P::W1 > 0) {
#pragma unroll
      for (int e = 2 * hf; e < P::R1; e += 4)
        *reinterpret_cast<uint32_t*>(row + 64 + acc_col(e, t4)) =
            pack_bf16(dq1[e] * scale, dq1[e + 1] * scale);
    }
  }
}

static_assert(fwd_tc_smem<128>() <= 232448 && bwd_dkdv_tc_smem<128>() <= 232448 &&
                  bwd_dq_tc_smem<128>() <= 232448,
              "a block fits in the 227 KB of shared memory a block can use");

template <typename K>
cudaError_t prepare_max_shared(K kern, size_t smem) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// cp.async copies 16-byte chunks of bf16 rows, and the epilogues store
// pairs of bf16: every bf16 tensor must start on a 16-byte boundary.
bool aligned16(const void* a, const void* b, const void* c, const void* d, const void* e,
               const void* f) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d |
                        (uintptr_t)e | (uintptr_t)f;
  return (any & 15) == 0;
}

template <int D>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Hq, int Hkv, int Lq, int Lk, int kv_len, int causal, int window,
                   float scale, cudaStream_t st) {
  if (!aligned16(q, k, v, o, q, q)) return cudaErrorMisalignedAddress;
  const size_t smem = fwd_tc_smem<D>();
  cudaError_t e = prepare_max_shared(fwd_tc_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lq + BM - 1) / BM, B * Hq);
  fwd_tc_kernel<D><<<grid, FWD_WGS * WG, smem, st>>>((const bf16*)q, (const bf16*)k,
                                                      (const bf16*)v, (bf16*)o, lse, Hq, Hkv,
                                                      Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, float* delta, int B, int Hq,
                      int Hkv, int Lq, int Lk, int kv_len, int causal, int window, float scale,
                      cudaStream_t st) {
  if (!aligned16(q, k, v, o, dout, dq)) return cudaErrorMisalignedAddress;
  const size_t smem = bwd_dq_tc_smem<D>();
  cudaError_t e = prepare_max_shared(bwd_dq_tc_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lq + BM - 1) / BM, B * Hq);
  bwd_dq_tc_kernel<D><<<grid, DQ_WGS * WG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, lse,
      (bf16*)dq, delta, Hq, Hkv, Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv_tc(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B,
                        int Hq, int Hkv, int Lq, int Lk, int kv_len, int causal, int window,
                        float scale, cudaStream_t st) {
  if (!aligned16(q, k, v, dout, dk, dv)) return cudaErrorMisalignedAddress;
  const size_t smem = bwd_dkdv_tc_smem<D>();
  cudaError_t e = prepare_max_shared(bwd_dkdv_tc_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid = tile_grid((Lk + KT - 1) / KT, B * Hkv);
  bwd_dkdv_tc_kernel<D><<<grid, WG, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dk,
      (bf16*)dv, Hq, Hkv, Lq, Lk, kv_len, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, the only type these kernels take (0 = float32 goes to
// flash_attn.cu). head_dim: 16, 32, 64, 96 or 128. Every tensor is
// contiguous and starts on a 16-byte boundary; the caller checks shapes.
// Returns a cudaError_t.
#define FA_TC_DISPATCH(FN, ...)                                \
  do {                                                         \
    if (dtype != 1) return (int)cudaErrorInvalidValue;         \
    switch (head_dim) {                                        \
      case 16: return (int)FN<16>(__VA_ARGS__);                \
      case 32: return (int)FN<32>(__VA_ARGS__);                \
      case 64: return (int)FN<64>(__VA_ARGS__);                \
      case 96: return (int)FN<96>(__VA_ARGS__);                \
      case 128: return (int)FN<128>(__VA_ARGS__);              \
      default: return (int)cudaErrorInvalidValue;              \
    }                                                          \
  } while (0)

extern "C" {

int flash_attn_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                      int Hq, int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                      int window, float scale, int dtype, void* stream) {
  FA_TC_DISPATCH(fwd_tc, q, k, v, o, (float*)lse, B, Hq, Hkv, Lq, Lk, kv_len, causal, window,
                 scale, (cudaStream_t)stream);
}

int flash_attn_bwd_dq_tc(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* dq, void* delta, int B,
                         int Hq, int Hkv, int Lq, int Lk, int head_dim, int kv_len, int causal,
                         int window, float scale, int dtype, void* stream) {
  FA_TC_DISPATCH(bwd_dq_tc, q, k, v, o, dout, (const float*)lse, dq, (float*)delta, B, Hq, Hkv,
                 Lq, Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

int flash_attn_bwd_dkdv_tc(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int Hq, int Hkv, int Lq, int Lk, int head_dim, int kv_len,
                           int causal, int window, float scale, int dtype, void* stream) {
  FA_TC_DISPATCH(bwd_dkdv_tc, q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, B,
                 Hq, Hkv, Lq, Lk, kv_len, causal, window, scale, (cudaStream_t)stream);
}

const char* flash_attn_tc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of each kernel that fit on one SM at once, at head_dim.
int flash_attn_tc_blocks_per_sm(int head_dim, int* fwd_blocks, int* dkdv_blocks,
                                int* dq_blocks) {
  cudaError_t e = cudaErrorInvalidValue;
#define FA_TC_OCC(DIM)                                                                     \
  if (head_dim == DIM) {                                                                   \
    e = prepare_max_shared(fwd_tc_kernel<DIM>, fwd_tc_smem<DIM>());                        \
    if (e == cudaSuccess)                                                                  \
      e = prepare_max_shared(bwd_dkdv_tc_kernel<DIM>, bwd_dkdv_tc_smem<DIM>());            \
    if (e == cudaSuccess)                                                                  \
      e = prepare_max_shared(bwd_dq_tc_kernel<DIM>, bwd_dq_tc_smem<DIM>());                \
    if (e == cudaSuccess)                                                                  \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(fwd_blocks, fwd_tc_kernel<DIM>,    \
                                                        FWD_WGS * WG, fwd_tc_smem<DIM>()); \
    if (e == cudaSuccess)                                                                  \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                   \
          dkdv_blocks, bwd_dkdv_tc_kernel<DIM>, WG, bwd_dkdv_tc_smem<DIM>());              \
    if (e == cudaSuccess)                                                                  \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                   \
          dq_blocks, bwd_dq_tc_kernel<DIM>, DQ_WGS * WG, bwd_dq_tc_smem<DIM>());           \
  }
  FA_TC_OCC(16)
  FA_TC_OCC(32)
  FA_TC_OCC(64)
  FA_TC_OCC(96)
  FA_TC_OCC(128)
#undef FA_TC_OCC
  return (int)e;
}

}  // extern "C"
