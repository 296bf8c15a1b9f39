"""The flash-attention backward kernels' CUDA source, run on the CPU.

``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkdv`` of
``src/repro_torch/kernels/csrc/flash_attn.cu`` are translated into C++
(each CUDA thread a ``std::thread``; ``__syncthreads``, the 64-thread
``bar.sync`` and warp shuffles as barriers; ``cp.async`` as copies done at
the wait, or at the issue, so that a ring stage read too early or
overwritten too soon shows), built with g++, and held against the plain
PyTorch versions at small shapes: tile edges, GQA, windows, ``kv_len``,
head dims 16 to 128, bf16, rows that are not 16-byte aligned, and two runs
that must give the same bits. It checks the kernels' indexing and
synchronisation, not their speed, and knows only the CUDA features that
source uses: a new asm construct there needs a stand-in in ``REWRITES``.
Run from the repo root:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_emulate.py
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_attn.cu")

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
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local uint3 threadIdx, blockIdx;
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
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
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
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2,
       cudaFuncAttributePreferredSharedMemoryCarveout = 3, cudaSharedmemCarveoutMaxShared = 100 };
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
"""

# CUDA constructs of flash_attn.cu and their C++ stand-ins
REWRITES = [
    (r"(\w+<T, D>)<<<(.*?)>>>\(", r"emu_launch(\2, \1, "),
    (r'asm volatile\("bar\.sync.*?"r"\((.*?)\), "r"\((.*?)\).*?"memory"\);',
     r"emu_bar_sync(\1, \2);"),
    (r'asm volatile\("cp\.async\.cg.*?"memory"\);', "emu_cp(dst, src, 16);"),
    (r'asm volatile\("cp\.async\.ca.*?"memory"\);', "emu_cp(dst, src, 4);"),
    (r'asm volatile\("cp\.async\.commit_group.*?"memory"\);', "emu_commit();"),
    (r'asm volatile\("cp\.async\.wait_group.*?"memory"\);', "emu_wait();"),
    (r"extern __shared__ (float4?) (\w+)\[\];", r"\1* \2 = (\1*)emu_smem();"),
]


def build(out: Path, flags: list[str]) -> Path:
    """The translated source as a shared library, built into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    src = SOURCE.read_text()
    for pat, rep in REWRITES:
        src = re.sub(pat, rep, src, flags=re.S)
    left = [m for m in ("asm", "<<<") if m in src]
    assert not left, f"no CPU stand-in for {left} in {SOURCE.name}"
    cpp, lib = out / "flash_attn_emu.cpp", out / "libflash_attn_emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{out}", "-Wno-unknown-pragmas", *flags, "-o", str(lib),
                    str(cpp)], check=True)
    return lib


@pytest.fixture(scope="module", params=["copy_at_wait", "copy_at_issue"])
def emu(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the translated kernels")
    flags = ["-DEMU_COPY_AT_ISSUE"] if request.param == "copy_at_issue" else []
    lib = ctypes.CDLL(str(build(tmp_path_factory.mktemp(request.param),
                                flags)))
    for name, argtypes in ops._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def run(lib, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype, tol,
        offset=False, seed=0):
    """Both backward kernels on seeded inputs. Returns (worst |error|,
    whether every output is finite and within tol (1 + |plain|), outputs)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(shape, generator=gen).to(dtype)
        if offset:   # one element into its storage: rows not 16-byte aligned
            buf = torch.empty(x.numel() + 1, dtype=dtype)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(shape)
        return x

    q, do = rnd(B, Hq, Lq, D), rnd(B, Hq, Lq, D)
    k, v = rnd(B, Hkv, Lk, D), rnd(B, Hkv, Lk, D)
    kv_len = Lk if kv_len is None else kv_len
    scale = D ** -0.5
    opts = dict(causal=causal, window=window, scale=scale, kv_len=kv_len)
    o, lse = ops.flash_attn_fwd_plain(q, k, v, **opts)
    dims = [B, Hq, Hkv, Lq, Lk, D, kv_len, int(causal), window]
    dq, delta = torch.empty_like(q), torch.empty(B, Hq, Lq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for fn, ts in (("flash_attn_bwd_dq", (q, k, v, o, do, lse, dq, delta)),
                   ("flash_attn_bwd_dkdv", (q, k, v, do, lse, delta, dk, dv))):
        err = getattr(lib, fn)(*[t.data_ptr() for t in ts], *dims, scale,
                               DTYPES[dtype], None)
        assert err == 0, f"{fn} returned {err}"
    dq_p, delta_p = ops.flash_attn_bwd_dq_plain(q, k, v, o, lse, do, **opts)
    dk_p, dv_p = ops.flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do, **opts)
    worst, ok = 0.0, True
    for a, b in ((dq, dq_p), (delta, delta_p), (dk, dk_p), (dv, dv_p)):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        ok &= bool((err <= tol * (1 + b.abs())).all()) and bool(a.isfinite().all())
    return worst, ok, (dq, delta, dk, dv)


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
