"""The hand-written CUDA kernels' sources, run on the CPU.

``flash_attn_fwd``, ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkdv`` of
``src/repro_torch/kernels/csrc/flash_attn.cu`` (and, for the bf16 cases,
the forward, dQ and dK/dV of ``flash_attn_tc.cu``, as ``ops.kernel_names``
picks them) and the WKV6 forward and
backward kernels of ``src/repro_torch/kernels/csrc/wkv6.cu`` are
translated into C++
(each CUDA thread a ``std::thread``; ``__syncthreads``, the 64-thread
``bar.sync`` and warp shuffles as barriers; ``cp.async`` as copies done at
the wait, or at the issue, so that a ring stage read too early or
overwritten too soon shows), built with g++, and held against the plain
PyTorch versions at small shapes: for attention tile edges, GQA, windows,
``kv_len``, head dims 16 to 128 and bf16; for WKV6 ragged L, head dims 16
to 64, extreme decays and a nonzero s0 and dsT; for both rows that are not 16-byte
aligned, and two runs that must give the same bits. It checks the kernels'
indexing and synchronisation, not their speed, and knows only the CUDA
features those sources use: a new asm construct there needs a stand-in in
``REWRITES``. The stand-ins for ``wgmma`` (``flash_attn_tc.cu``) are
here too; ``test_torch_cuda_emulate_tc.py`` holds those kernels at more
shapes. The AdamW update and the gradient norm's square-sum of
``adamw.cu`` are held at small ragged sizes, on grids of a few blocks so
that the grid-stride loops wrap: the update bit for bit against the
eager formula, the square-sum against the eager one.
Run from the repo root:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_emulate.py
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops
from repro_torch.kernels.optim import ops as optim_ops
from repro_torch.kernels.rwkv import ops as wops

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

CUDA_RUNTIME_H = r"""// CPU emulation of the CUDA features the kernels use: one std::thread per
// CUDA thread, barriers for __syncthreads and warp shuffles, cp.async as
// copies deferred to the wait (or done at issue with EMU_COPY_AT_ISSUE).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include <memory>
#include <map>
#include <mutex>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 gridDim;
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<float> xch;
  std::vector<float4> smem;
  std::mutex mu;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};
inline thread_local EmuBlock* emu_blk = nullptr;
struct EmuCopy { void* d; const void* s; int n; };
inline thread_local std::vector<EmuCopy> emu_pending;
inline void* emu_smem() { return emu_blk->smem.data(); }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
#define exp2f(x) std::exp2((float)(x))
inline float __shfl_xor_sync(unsigned, float x, int o) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  emu_blk->xch[t] = x;
  emu_blk->warp_bar[w]->arrive_and_wait();
  const float y = emu_blk->xch[w * 32 + (l ^ o)];
  emu_blk->warp_bar[w]->arrive_and_wait();
  return y;
}
inline void emu_bar_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(emu_blk->mu);
    auto& slot = emu_blk->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(n);
    b = slot.get();
  }
  b->arrive_and_wait();
}
inline void __syncwarp() { emu_blk->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
// the round-to-nearest intrinsics (adamw.cu): one IEEE fp32 operation each
// (built with -ffp-contract=off, so that none is fused into another)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
// a shared-memory address is the offset into the block's shared memory
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const char*)p - (const char*)emu_smem());
}
inline void emu_cp(void* d, const void* s, int n) {
#ifdef EMU_COPY_AT_ISSUE
  std::memcpy(d, s, n);
#else
  emu_pending.push_back({d, s, n});
#endif
}
inline void emu_commit() {}
inline void emu_wait() {
  for (auto& c : emu_pending) std::memcpy(c.d, c.s, c.n);
  emu_pending.clear();
}
// wgmma (flash_attn_tc.cu): fence, commit and wait as barriers of the
// warpgroup; mma_async computes each thread's accumulator elements in the
// layout of the PTX ISA (warp w, lane 4 g + t: element e is row 16 w + g +
// 8 ((e / 2) & 1), column 8 (e / 4) + 2 t + (e & 1)) from the operands that
// its descriptors address (start, leading and stride byte offsets, the
// 128-byte swizzle) and, for A in registers, from the other lanes'
// fragments through a per-block scratch. The product is formed at the wait
// (reading shared memory and the A registers then, and leaving the
// accumulators alone until then), or at the issue with EMU_COPY_AT_ISSUE.
inline uint32_t emu_wg_a[1024][4];
struct EmuWgOp { int n; const uint32_t* a; float* d; uint64_t da, db; int acc; };
inline thread_local std::vector<EmuWgOp> emu_wg_ops;
inline void emu_wg_bar() { emu_bar_sync(100 + (int)threadIdx.x / 128, 128); }
[[noreturn]] inline void emu_fail(const char* what) { std::fprintf(stderr, "wgmma: %s\n", what); std::abort(); }
inline float emu_bf16(uint16_t u) { uint32_t x = (uint32_t)u << 16; float f; std::memcpy(&f, &x, 4); return f; }
inline float emu_smem_bf16(uint32_t off) {
  if (off % 2 || off + 2 > emu_blk->smem.size() * sizeof(float4)) emu_fail("operand outside shared memory");
  uint16_t u; std::memcpy(&u, (const char*)emu_smem() + off, 2); return emu_bf16(u);
}
inline void emu_desc_check(uint64_t desc) {
  if ((desc >> 62) != 1) emu_fail("layout type is not the 128-byte swizzle");
  if ((desc >> 49) & 7) emu_fail("base offset is not 0");
}
inline uint32_t emu_sw128(uint32_t off) { return off ^ (((off >> 7) & 7u) << 4); }
// element (row r, column k) of a K-major operand: rows in groups of 8 of
// 128-byte rows, the groups SBO apart
inline uint32_t emu_kmajor(uint64_t desc, int r, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4, sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  return emu_sw128(start + (r / 8) * sbo + (r % 8) * 128 + k * 2);
}
// element (k, n) of an MN-major operand: n along a 128-byte row, 64 a row
// and the next 64 LBO on; k in groups of 8 rows, the groups SBO apart
inline uint32_t emu_mnmajor(uint64_t desc, int k, int n) {
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4, sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  return emu_sw128(start + (n / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + (n % 64) * 2);
}
inline void emu_wg_run(const EmuWgOp& op) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  float A[2][16];
  if (op.a) {   // rows g and g + 8 of the warp from the fragments of lanes 4 g .. 4 g + 3
    for (int i = 0; i < 4; ++i) emu_wg_a[threadIdx.x][i] = op.a[i];
    emu_wg_bar();
    for (int tt = 0; tt < 4; ++tt) {
      const uint32_t* f = emu_wg_a[threadIdx.x - lane + 4 * g + tt];
      for (int i = 0; i < 8; ++i) {   // element i: register i / 2, half i % 2
        const uint16_t u = (uint16_t)(f[i / 2] >> (16 * (i % 2)));
        A[(i / 2) % 2][8 * (i / 4) + 2 * tt + i % 2] = emu_bf16(u);
      }
    }
    emu_wg_bar();
  } else {
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < 16; ++k) A[h][k] = emu_smem_bf16(emu_kmajor(op.da, 16 * w + g + 8 * h, k));
  }
  for (int e = 0; e < op.n / 2; ++e) {
    const int h = (e / 2) % 2, col = 8 * (e / 4) + 2 * q + e % 2;
    float sum = 0.f;
    for (int k = 0; k < 16; ++k)
      sum += A[h][k] * emu_smem_bf16(op.a ? emu_mnmajor(op.db, k, col) : emu_kmajor(op.db, col, k));
    op.d[e] = op.acc ? op.d[e] + sum : sum;
  }
}
inline void emu_wg_issue(const EmuWgOp& op) {
  if (op.da) emu_desc_check(op.da);
  emu_desc_check(op.db);
#ifdef EMU_COPY_AT_ISSUE
  emu_wg_run(op);
#else
  emu_wg_ops.push_back(op);
#endif
}
template <int N> void emu_wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
  emu_wg_issue({N, nullptr, d, da, db, acc});
}
template <int N> void emu_wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  emu_wg_issue({N, a, d, 0, db, acc});
}
inline void emu_wg_fence() { emu_wg_bar(); }
inline void emu_wg_commit() { emu_wg_bar(); }
inline void emu_wg_wait() {
  for (auto& op : emu_wg_ops) emu_wg_run(op);
  emu_wg_ops.clear();
  emu_wg_bar();
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2,
       cudaFuncAttributePreferredSharedMemoryCarveout = 3, cudaSharedmemCarveoutMaxShared = 100,
       cudaErrorMisalignedAddress = 716 };
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <typename K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <typename F, typename... A>
void emu_launch(dim3 grid, int nt, size_t smem, cudaStream_t, F f, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock blk;
      blk.bar = std::make_unique<std::barrier<>>(nt);
      for (int w = 0; w < (nt + 31) / 32; ++w)
        blk.warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
      blk.xch.assign(nt, 0.f);
      // garbage, so that a read of unstaged shared memory shows
      blk.smem.assign(smem / 16 + 1, float4{NAN, NAN, NAN, NAN});
      std::vector<std::thread> ths;
      for (int t = 0; t < nt; ++t)
        ths.emplace_back([&, t] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {bx, by, 0};
          gridDim = grid;
          emu_blk = &blk;
          f(args...);
          emu_wait();
        });
      for (auto& th : ths) th.join();
    }
}
"""

CUDA_BF16_H = r"""#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.x << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1); return {(uint16_t)(u >> 16)}; }
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
"""

# the rest of one asm statement: text that does not start another
_REST = r"(?:(?!asm volatile).)*?"

# CUDA constructs of the sources and their C++ stand-ins. A static
# __shared__ array becomes a static one: blocks run one at a time.
REWRITES = [
    (r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu_launch(\2, \1, "),
    (r'asm volatile\("bar\.sync.*?"r"\((.*?)\), "r"\((.*?)\).*?"memory"\);',
     r"emu_bar_sync(\1, \2);"),
    (r'asm volatile\("cp\.async\.cg.*?"memory"\);', "emu_cp(dst, src, 16);"),
    (r'asm volatile\("cp\.async\.ca.*?"memory"\);', "emu_cp(dst, src, 4);"),
    (r'asm volatile\("cp\.async\.commit_group.*?"memory"\);', "emu_commit();"),
    (r'asm volatile\("cp\.async\.wait_group.*?"memory"\);', "emu_wait();"),
    (r"extern __shared__ (float4?) (\w+)\[\];", r"\1* \2 = (\1*)emu_smem();"),
    (r"__shared__ float ", "static float "),
    # flash_attn_tc.cu: wgmma, the proxy fence, and the compiler's fences on
    # the registers a wgmma in flight holds
    (r'asm volatile\("fence\.proxy\.async\.shared::cta;\\n" ::: "memory"\);', "(void)0;"),
    (r'asm volatile\("wgmma\.fence\.sync\.aligned;\\n" ::: "memory"\);', "emu_wg_fence();"),
    (r'asm volatile\("wgmma\.commit_group\.sync\.aligned;\\n" ::: "memory"\);',
     "emu_wg_commit();"),
    (r'asm volatile\("wgmma\.wait_group\.sync\.aligned 0;\\n" ::: "memory"\);',
     "emu_wg_wait();"),
    (r'asm volatile\("" : "\+[fr]"\(([^()]*)\)::"memory"\);', r"(void)\1;"),
    (r"asm volatile\(" + _REST + r"m64n(\d+)k16\.f32\.bf16\.bf16" + _REST
     + r"p, 1, 1, 0, 0;" + _REST + r"\);", r"emu_wgmma_ss<\1>(d, da, db, acc);"),
    (r"asm volatile\(" + _REST + r"m64n(\d+)k16\.f32\.bf16\.bf16" + _REST
     + r"p, 1, 1, 1;" + _REST + r"\);", r"emu_wgmma_rs<\1>(d, a, db, acc);"),
]


def build(source: str, out: Path, flags: list[str]) -> Path:
    """The translated ``csrc/<source>.cu`` as a shared library, built into
    ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    src = (CSRC / f"{source}.cu").read_text()
    for pat, rep in REWRITES:
        src = re.sub(pat, rep, src, flags=re.S)
    left = [m for m in ("asm", "<<<", "__shared__") if m in src]
    assert not left, f"no CPU stand-in for {left} in {source}.cu"
    cpp, lib = out / f"{source}_emu.cpp", out / f"lib{source}_emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{out}", "-Wno-unknown-pragmas", *flags, "-o", str(lib),
                    str(cpp)], check=True)
    return lib


def load(request, tmp_path_factory, source: str, signatures: dict):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the translated kernels")
    flags = ["-DEMU_COPY_AT_ISSUE"] if request.param == "copy_at_issue" else []
    lib = ctypes.CDLL(str(build(source, tmp_path_factory.mktemp(
        f"{source}-{request.param}"), flags)))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


class AttentionLibs:
    """The translated ``flash_attn.cu`` and, built at the first call of one
    of its entry points, ``flash_attn_tc.cu``: ``libs.<entry point>``."""

    def __init__(self, request, tmp_path_factory):
        self._args = (request, tmp_path_factory)
        self._fa = load(request, tmp_path_factory, "flash_attn",
                        ops._SIGNATURES)
        self._tc = None

    def __getattr__(self, name):
        if name not in ops.TC_SIGNATURES:
            return getattr(self._fa, name)
        if self._tc is None:
            self._tc = load(*self._args, "flash_attn_tc", ops.TC_SIGNATURES)
        return getattr(self._tc, name)


@pytest.fixture(scope="module", params=["copy_at_wait", "copy_at_issue"])
def emu(request, tmp_path_factory):
    return AttentionLibs(request, tmp_path_factory)


@pytest.fixture(scope="module", params=["copy_at_wait", "copy_at_issue"])
def wkv_emu(request, tmp_path_factory):
    return load(request, tmp_path_factory, "wkv6", wops._SIGNATURES)


def unaligned(x):
    """A copy of x as a view one element into its storage, so that its rows
    do not start on a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def randn(gen, shape, dtype=torch.float32, offset=False, scale=1.0):
    """Seeded normal values, ``unaligned`` with ``offset``."""
    x = (torch.randn(shape, generator=gen) * scale).to(dtype)
    return unaligned(x) if offset else x


def within(pairs, tol) -> tuple[float, bool]:
    """(worst |a - b|, whether every a is finite and within tol (1 + |b|))
    over (kernel, plain) output pairs."""
    worst, ok = 0.0, True
    for a, b in pairs:
        a, b = a.float(), b.float()
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        ok &= bool((err <= tol * (1 + b.abs())).all()) and bool(a.isfinite().all())
    return worst, ok


def run(lib, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype, tol,
        offset=False, seed=0):
    """Both backward kernels on seeded inputs. Returns (worst |error|,
    whether every output is finite and within tol (1 + |plain|), outputs)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return randn(gen, shape, dtype, offset)

    q, do = rnd(B, Hq, Lq, D), rnd(B, Hq, Lq, D)
    k, v = rnd(B, Hkv, Lk, D), rnd(B, Hkv, Lk, D)
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5
    opts = dict(causal=causal, window=window, scale=scale, kv_len=kv_len)
    o, lse = ops.flash_attn_fwd_plain(q, k, v, **opts)
    dims = [B, Hq, Hkv, Lq, Lk, D, kv_len, int(causal), window]
    dq, delta = torch.empty_like(q), torch.empty(B, Hq, Lq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _, dq_name, dkdv_name = ops.kernel_names(dtype)
    if dq_name in ops.TC_SIGNATURES:   # as the wrappers hand them over
        q, k, v, o, do = (ops.aligned16(t) for t in (q, k, v, o, do))
    for fn, ts in ((dq_name, (q, k, v, o, do, lse, dq, delta)),
                   (dkdv_name, (q, k, v, do, lse, delta, dk, dv))):
        err = getattr(lib, fn)(*[t.data_ptr() for t in ts], *dims, scale,
                               DTYPES[dtype], None)
        assert err == 0, f"{fn} returned {err}"
    dq_p, delta_p = ops.flash_attn_bwd_dq_plain(q, k, v, o, lse, do, **opts)
    dk_p, dv_p = ops.flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do, **opts)
    worst, ok = within(((dq, dq_p), (delta, delta_p), (dk, dk_p), (dv, dv_p)),
                       tol)
    return worst, ok, (dq, delta, dk, dv)


# chip_smoke.py's forward tolerances
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def run_fwd(lib, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype,
            offset=False, seed=0):
    """The forward kernel on seeded inputs, against the plain version: o
    and lse. Returns (worst |error|, whether within tolerance, outputs)."""
    gen = torch.Generator().manual_seed(seed)
    q = randn(gen, (B, Hq, Lq, D), dtype, offset)
    k, v = (randn(gen, (B, Hkv, Lk, D), dtype, offset) for _ in range(2))
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5
    name = ops.kernel_names(dtype)[0]
    if name in ops.TC_SIGNATURES:   # as the wrapper hands them over
        q, k, v = (ops.aligned16(t) for t in (q, k, v))
    o, lse = torch.empty_like(q), torch.empty(B, Hq, Lq)
    err = getattr(lib, name)(*[t.data_ptr() for t in (q, k, v, o, lse)], B,
                             Hq, Hkv, Lq, Lk, D, kv_len, int(causal), window,
                             scale, DTYPES[dtype], None)
    assert err == 0, f"{name} returned {err}"
    o_p, lse_p = ops.flash_attn_fwd_plain(q, k, v, causal=causal,
                                          window=window, scale=scale,
                                          kv_len=kv_len)
    worst, ok = within(((o, o_p), (lse, lse_p)), FWD_TOL[dtype])
    return worst, ok, (o, lse)


F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {F32: 0, BF16: 1}
CASES = [  # B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype, tol
    (1, 2, 2, 256, 256, 64, True, 0, None, F32, 1e-4),
    (1, 8, 2, 128, 128, 64, True, 0, None, F32, 1e-4),     # GQA, G = 4
    (1, 2, 2, 300, 300, 64, True, 100, None, F32, 1e-4),   # window ends in a tile
    (1, 2, 1, 200, 200, 64, True, 0, None, F32, 1e-4),
    (1, 4, 2, 150, 192, 32, False, 0, 166, F32, 1e-4),     # kv_len, Lq != Lk
    (1, 2, 2, 130, 130, 128, True, 0, None, F32, 1e-4),
    (1, 2, 2, 130, 130, 128, True, 0, None, BF16, 2e-2),
    (1, 4, 2, 100, 100, 16, True, 32, None, F32, 1e-4),
    (1, 2, 2, 200, 200, 64, True, 0, None, BF16, 2e-2),
    # at the 64-row (dQ) and 128-key (dK/dV) tiles' edges
    *[(1, 2, 2, n, n, 64, True, 0, None, F32, 1e-4)
      for n in (63, 64, 65, 127, 128, 129)],
    (1, 2, 2, 64, 129, 64, False, 0, None, F32, 1e-4),
    (1, 2, 2, 129, 64, 64, False, 0, None, F32, 1e-4),
    # head_dim 96 (phi3): six output columns a thread in the backward, at a
    # tile's edge, across tiles and in bf16
    (1, 2, 2, 65, 65, 96, True, 0, None, F32, 1e-4),
    (1, 2, 2, 130, 130, 96, True, 0, None, F32, 1e-4),
    (1, 2, 2, 130, 130, 96, True, 0, None, BF16, 2e-2),
    # GQA at G = 5 (qwen SMOKE's 5 q heads on 1) and G = 12 (starcoder2)
    (1, 5, 1, 100, 100, 64, True, 0, None, F32, 1e-4),
    (1, 12, 1, 80, 80, 128, True, 0, None, F32, 1e-4),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c[:10]))
def test_backward_kernels_match_plain(emu, case):
    worst, ok, _ = run(emu, *case)
    assert ok, f"max_abs_err {worst:.2e} over tolerance {case[-1]}"


def test_backward_kernels_on_unaligned_rows(emu):
    """fp32 inputs that do not start on a 16-byte boundary go through the
    threads' own staging instead of cp.async."""
    worst, ok, _ = run(emu, 1, 2, 2, 130, 130, 64, True, 0, None, F32, 1e-4,
                       offset=True)
    assert ok, f"max_abs_err {worst:.2e} over tolerance 1e-4"


def test_backward_kernels_give_the_same_bits_twice(emu):
    runs = [run(emu, 1, 4, 2, 192, 192, 64, True, 0, None, F32, 1e-4,
                seed=3)[2] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c[:10]))
def test_forward_kernel_matches_plain(emu, case):
    worst, ok, _ = run_fwd(emu, *case[:10])
    assert ok, f"max_abs_err {worst:.2e} over tolerance {FWD_TOL[case[9]]}"


def test_forward_kernel_on_unaligned_rows(emu):
    """The threads' own staging instead of cp.async, as for the backward."""
    worst, ok, _ = run_fwd(emu, 1, 4, 2, 130, 130, 64, True, 0, None, F32,
                           offset=True)
    assert ok, f"max_abs_err {worst:.2e} over tolerance 2e-5"


def test_forward_kernel_gives_the_same_bits_twice(emu):
    runs = [run_fwd(emu, 1, 4, 2, 192, 192, 64, True, 0, None, F32,
                    seed=3)[2] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# chip_smoke.py's WKV6 tolerance: each output within this share of the plain
# output's largest entry
WKV_TOL = 1e-4


def wkv_inputs(B, L, H, hd, logw_kind, offset=False, seed=0):
    """r, k, v, logw, u, s0, dy and dsT from a seeded generator; every
    [B, L, H, hd] tensor ``unaligned`` with ``offset``."""
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (randn(gen, (B, L, H, hd), offset=offset) for _ in range(3))
    if logw_kind == "model":   # the range the model's clip allows
        logw = -torch.exp(torch.clamp(randn(gen, (B, L, H, hd), scale=2.0),
                                      -8.0, 4.0))
    else:
        logw = torch.full((B, L, H, hd), float(logw_kind))
    if offset:
        logw = unaligned(logw)
    u = randn(gen, (H, hd), scale=0.5)
    s0 = randn(gen, (B, H, hd, hd), scale=0.1)
    dy = randn(gen, (B, L, H, hd), offset=offset)
    dsT = randn(gen, (B, H, hd, hd), scale=0.1)
    return r, k, v, logw, u, s0, dy, dsT


def rel_error(pairs) -> float:
    """The worst error over the plain output's largest entry, across
    (kernel, plain) output pairs; inf where a kernel output is not
    finite."""
    if not all(bool(a.isfinite().all()) for a, _ in pairs):
        return float("inf")
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)


def run_wkv(lib, B, L, H, hd, logw_kind, offset=False, seed=0):
    """``wkv6_fwd`` on seeded inputs with a nonzero s0, against the plain
    version: y and sT. Returns (worst error over the plain output's largest
    entry, outputs)."""
    r, k, v, logw, u, s0, _, _ = wkv_inputs(B, L, H, hd, logw_kind, offset,
                                            seed)
    y, sT = torch.empty(B, L, H, hd), torch.empty(B, H, hd, hd)
    err = lib.wkv6_fwd(*[t.data_ptr() for t in (r, k, v, logw, u, s0, y, sT)],
                       B, L, H, hd, None)
    assert err == 0, f"wkv6_fwd returned {err}"
    y_p, sT_p = wops.wkv6_fwd_plain(r, k, v, logw, u, s0)
    return rel_error(((y, y_p), (sT, sT_p))), (y, sT)


def run_wkv_bwd(lib, B, L, H, hd, logw_kind, offset=False, seed=0):
    """The backward kernels on seeded inputs with a nonzero s0 and dsT, in
    the order the port launches them: ``wkv6_bwd_dr``, ``wkv6_bwd_dk`` on
    dr's a terms and du partials (writing du too), and ``wkv6_bwd_dv``;
    each against its plain version on the same inputs. Returns (worst error
    over the plain output's largest entry, outputs)."""
    r, k, v, logw, u, s0, dy, dsT = wkv_inputs(B, L, H, hd, logw_kind,
                                               offset, seed)
    if offset:
        s0, dsT = unaligned(s0), unaligned(dsT)
    seq = lambda: torch.empty(B, L, H, hd)  # noqa: E731
    dr, a, dk, dlogw, dv = seq(), seq(), seq(), seq(), seq()
    du_part, du, ds0 = (torch.empty(B, H, hd), torch.empty(H, hd),
                        torch.empty(B, H, hd, hd))
    for fn, ts in (
            ("wkv6_bwd_dr", (r, k, v, logw, u, s0, dy, dsT, dr, a, du_part)),
            ("wkv6_bwd_dk", (r, k, v, logw, u, dy, dsT, a, du_part, dk, dlogw,
                             ds0, du)),
            ("wkv6_bwd_dv", (r, k, logw, u, dy, dsT, dv))):
        err = getattr(lib, fn)(*[t.data_ptr() for t in ts], B, L, H, hd, None)
        assert err == 0, f"{fn} returned {err}"
    want = (*wops.wkv6_bwd_dr_plain(r, k, v, logw, u, s0, dy, dsT),
            *wops.wkv6_bwd_dk_plain(r, k, v, logw, u, dy, dsT, a, du_part),
            wops.wkv6_bwd_dv_plain(r, k, logw, u, dy, dsT))
    got = (dr, a, du_part, dk, dlogw, ds0, du, dv)
    return rel_error(tuple(zip(got, want))), got


WKV_CASES = [  # B, L, H, hd, logw
    (1, 37, 2, 64, "model"),      # two stages and a ragged third
    # three b for du's order; four stages, the one scanned first in reverse
    # a single step
    (3, 49, 2, 64, "model"),
    (2, 16, 1, 64, "model"),      # one whole stage
    (1, 1, 2, 64, "model"),
    (1, 17, 1, 64, -20.0),
    (1, 33, 1, 64, -1e-4),
    (2, 41, 2, 32, "model"),
    (2, 50, 3, 16, "model"),
    (1, 20, 2, 16, -20.0),
]


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wkv6_forward_kernel_matches_plain(wkv_emu, case):
    rel, _ = run_wkv(wkv_emu, *case)
    assert rel <= WKV_TOL, f"error {rel:.2e} of the largest plain entry"


def test_wkv6_forward_kernel_on_unaligned_rows(wkv_emu):
    """Tensors that do not start on a 16-byte boundary: the threads' own
    staging instead of cp.async."""
    rel, _ = run_wkv(wkv_emu, 1, 37, 2, 64, "model", offset=True)
    assert rel <= WKV_TOL, f"error {rel:.2e} of the largest plain entry"


def test_wkv6_forward_kernel_gives_the_same_bits_twice(wkv_emu):
    runs = [run_wkv(wkv_emu, 2, 35, 2, 64, "model", seed=5)[1] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wkv6_backward_kernels_match_plain(wkv_emu, case):
    """dr (with the a terms and du partials), dk (with dlogw, ds0 and du)
    and dv."""
    rel, _ = run_wkv_bwd(wkv_emu, *case)
    assert rel <= WKV_TOL, f"error {rel:.2e} of the largest plain entry"


def test_wkv6_backward_kernels_on_unaligned_rows(wkv_emu):
    """Tensors that do not start on a 16-byte boundary: the threads' own
    staging instead of cp.async."""
    rel, _ = run_wkv_bwd(wkv_emu, 1, 37, 2, 64, "model", offset=True)
    assert rel <= WKV_TOL, f"error {rel:.2e} of the largest plain entry"


def test_wkv6_backward_kernels_give_the_same_bits_twice(wkv_emu):
    runs = [run_wkv_bwd(wkv_emu, 2, 35, 2, 64, "model", seed=5)[1]
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ----------------------------------------------------------- adamw.cu
@pytest.fixture(scope="module")
def optim_emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the translated kernels")
    lib = ctypes.CDLL(str(build("adamw", tmp_path_factory.mktemp("adamw"),
                                ["-ffp-contract=off"])))
    for name, argtypes in optim_ops._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


OPTIM_DTYPES = {F32: 0, BF16: 1}
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def adamw_ieee(p, g, m, v, bc1, bc2, *, lr, b1, b2, eps, weight_decay):
    """``optim_ops.adamw_update_plain``'s operations in its order, each
    rounded correctly in fp32 (numpy's), as they are on the card: torch's
    vectorised sqrt on a CPU is off by one unit in the last place now and
    then. Returns (p', m', v') as torch tensors, p' in p's dtype."""
    f = np.float32
    g32, p32 = g.float().numpy(), p.float().numpy()
    bc1, bc2 = f(bc1.item()), f(bc2.item())
    m1 = f(b1) * m.numpy() + f(1 - b1) * g32
    v1 = f(b2) * v.numpy() + f(1 - b2) * (g32 * g32)
    step = (f(lr) * (m1 / bc1)) / (np.sqrt(v1 / bc2) + f(eps))
    if weight_decay:
        step = step + f(lr * weight_decay) * p32
    return (torch.from_numpy(p32 - step).to(p.dtype), torch.from_numpy(m1),
            torch.from_numpy(v1))


def optim_inputs(n, p_dtype, g_dtype, count, seed=0, offset=False):
    """Seeded p, g, m (signed) and v (positive) of n elements, and the bias
    corrections after ``count`` steps as the optimizer forms them."""
    gen = torch.Generator().manual_seed(seed)
    p = randn(gen, (n,), p_dtype, offset)
    g = randn(gen, (n,), g_dtype, offset, scale=1e-2)
    m = randn(gen, (n,), F32, offset, scale=1e-3)
    v = randn(gen, (n,), F32, scale=1e-3).square()
    v = unaligned(v) if offset else v
    cf = torch.tensor(float(count))
    bc1 = 1.0 - torch.full((), HYPER["b1"]) ** cf
    bc2 = 1.0 - torch.full((), HYPER["b2"]) ** cf
    return p, g, m, v, bc1, bc2


def run_update(lib, p, g, m, v, bc1, bc2, weight_decay, cap):
    """The translated ``adamw_update`` on one leaf, the grid as the wrapper
    plans it under a cap of ``cap`` blocks. Returns (p', m', v')."""
    outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
    ts = (p, g, m, v, *outs)
    n_vec, blocks = optim_ops.launch_shape(p.numel(), ts, cap)
    h = HYPER
    err = lib.adamw_update(*(t.data_ptr() for t in ts), p.numel(), n_vec,
                           blocks, bc1.data_ptr(), bc2.data_ptr(), h["b1"],
                           1 - h["b1"], h["b2"], 1 - h["b2"], h["lr"],
                           h["eps"], h["lr"] * weight_decay,
                           int(bool(weight_decay)), OPTIM_DTYPES[p.dtype],
                           None)
    assert err == 0, f"adamw_update returned {err}"
    return outs


OPTIM_CASES = [  # n, p dtype, g dtype, weight decay, count, unaligned
    *[(n, dt, dt, wd, count, False)
      for n, count in ((1, 1), (7, 1000), (9, 1), (1023, 1000), (4099, 1))
      for dt in (F32, BF16) for wd in (0.0, 0.01)],
    (1023, F32, F32, 0.01, 2, True),        # not 16-byte aligned: one by one
    (1023, BF16, BF16, 0.01, 2, True),
]


@pytest.mark.parametrize("case", OPTIM_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_adamw_kernel_gives_the_eager_formulas_bits(optim_emu, case):
    """p', m' and v' bit for bit, on grids of at most 2 blocks (the
    grid-stride loop wraps from 2 048 elements); the inputs untouched."""
    n, p_dtype, g_dtype, wd, count, offset = case
    ins = optim_inputs(n, p_dtype, g_dtype, count, offset=offset)
    before = [t.clone() for t in ins]
    got = run_update(optim_emu, *ins, wd, cap=2)
    want = adamw_ieee(*ins, **HYPER, weight_decay=wd)
    for name, a, b in zip(("p", "m", "v"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            f"{name}: {int((a != b).sum())} of {n} elements differ"
    assert all(torch.equal(a, b) for a, b in zip(ins, before))


def run_sq_sum(lib, xs, cap):
    """The translated ``grad_sq_sum`` on each of ``xs`` into its slice of
    the partials, then ``grad_sq_sum_final``, as ``sq_sum_cuda`` launches
    them. Returns the 0-d sum."""
    plans = [optim_ops.launch_shape(x.numel(), (x,), cap) for x in xs]
    partial = torch.empty(sum(b for _, b in plans))
    out, at = torch.empty(()), 0
    for x, (n_vec, blocks) in zip(xs, plans):
        err = lib.grad_sq_sum(x.data_ptr(), x.numel(), n_vec, blocks,
                              partial.data_ptr() + 4 * at,
                              OPTIM_DTYPES[x.dtype], None)
        assert err == 0, f"grad_sq_sum returned {err}"
        at += blocks
    assert lib.grad_sq_sum_final(partial.data_ptr(), at, out.data_ptr(),
                                 None) == 0
    return out


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_grad_sq_sum_kernels_match_eager_and_repeat_their_bits(optim_emu,
                                                               dtype):
    """Leaves of 1, 1023, 4099 and 9000 elements (one unaligned), on grids
    of at most 3 blocks: within 1e-6 of the eager sum, the same bits
    twice."""
    gen = torch.Generator().manual_seed(1)
    xs = [randn(gen, (n,), dtype, offset=n == 1023) for n in (1, 1023, 4099,
                                                             9000)]
    got = [run_sq_sum(optim_emu, xs, cap=3) for _ in range(2)]
    want = optim_ops.sq_sum_plain(xs, "cpu")
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)
