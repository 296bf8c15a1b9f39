// AdamW for Hopper (sm_90a): the update of one leaf in a single pass, and
// the gradient norm's square-sum in two deterministic stages.
//
// Replaces no TPU kernel. The reference's update (src/repro/optim/
// optimizers.py: adam) is plain jnp, which XLA fuses into one loop a leaf;
// the port's eager formula (optim/optimizers.py before this kernel) ran ~20
// aten kernels a leaf, each reading and writing a whole fp32 tensor: ~168
// bytes a parameter where the update needs 22.
//
// What adamw_update_kernel computes, element by element, in fp32, in the
// eager formula's order, each operation rounded on its own (the _rn
// intrinsics, which nvcc never contracts into an FMA), so that its bits are
// the formula's on the card (kernels/optim/ops.py: adamw_update_plain):
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) (g g)
//   step = (lr (m' / bc1)) / (sqrt(v' / bc2) + eps)   [ + (lr wd) p ]
//   p' = p - step, rounded to p's dtype (bf16: to nearest even)
// g and p are read in their dtype (bf16 or fp32, the same for both, as
// autograd gives each gradient its parameter's) and widened exactly; the
// moments are fp32. bc1 and bc2 are the bias corrections, 0-d fp32 tensors
// on the device that torch computes from the step count (read through a
// pointer, so the step copies nothing from the host); the other constants
// are the host's doubles rounded to fp32, as torch rounds a Python scalar.
// The weight-decay term is added only where wd != 0, as the formula does.
// Nothing is written in place: p', m' and v' go to new tensors.
//
// What bounds it on an H100: bytes. Each parameter reads g, p, m and v and
// writes p', m' and v' once: 22 bytes for bf16 params and grads, 28 for
// fp32. phi3-mini at 16 layers (2.01 B parameters, bf16) moves 44.2 GB a
// step, 13.2 ms at 3.35 TB/s.
//
// Design. A thread takes 8 consecutive elements a step, as 16-byte loads
// and stores (one of a bf16 tensor, two of an fp32 one), in a grid-stride
// loop over the leaf, 256 threads a block; the caller caps the grid at 2
// blocks an SM (kernels/optim/ops.py), which keeps ~48 KB of loads in
// flight on each SM. The elements past the last whole 8, or every element
// where a tensor does not start on a 16-byte boundary, are taken one at a
// time. The arithmetic is elementwise, so an element's bits do not depend
// on the leaf's layout, its split into FSDP boxes or the grid. ptxas
// (sm_90a, __launch_bounds__ capping it at 64): 52 registers (bf16), 56
// (fp32), no spills. Over phi3-mini-16l's
// tree (tools/torch_kernel_bench.py --parts optim; NVIDIA H100 80GB HBM3,
// 700 W) the update takes 17.80, 15.59, 15.85, 16.14 and 16.50 ms at 1, 2,
// 3, 4 and 8 blocks an SM (bound 13.19: 85 % at 2), the eager formula
// 123.1 ms; evict-first loads and stores (__ldcs, __stcs) took 15.74 ms at
// 2. The square-sum (2 bytes a bf16 parameter, bound 1.20 ms) takes 3.30,
// 1.92, 1.44 and 1.35 ms at 1, 2, 4 and 8 blocks an SM, so its cap is 8.
//
// The gradient norm: grad_sq_sum_kernel reads one gradient once in its own
// dtype; each thread sums the squares of its elements in fp32 in a fixed
// order, each block its threads' sums by a tree in shared memory, into one
// partial a block; grad_sq_sum_final_kernel sums a device's partials, in
// one block, the same way. No atomics: for a given size and grid the order
// is fixed, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads a block
constexpr int VEC = 8;    // elements a thread takes a step

struct AdamConsts {
  float b1, one_minus_b1, b2, one_minus_b2, lr, eps, lr_wd;
  int decay;   // 0: no weight-decay term
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float& d, float x) { d = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16& d, float x) { d = __float2bfloat16_rn(x); }

// 16 bytes of T
template <typename T>
struct alignas(16) Chunk {
  T x[16 / sizeof(T)];
};

// VEC elements from src (16-byte aligned), widened
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float (&out)[VEC]) {
  constexpr int W = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < VEC / W; ++c) {
    const Chunk<T> ch = reinterpret_cast<const Chunk<T>*>(src)[c];
#pragma unroll
    for (int j = 0; j < W; ++j) out[c * W + j] = widen(ch.x[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, const float (&in)[VEC]) {
  constexpr int W = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < VEC / W; ++c) {
    Chunk<T> ch;
#pragma unroll
    for (int j = 0; j < W; ++j) narrow(ch.x[j], in[c * W + j]);
    reinterpret_cast<Chunk<T>*>(dst)[c] = ch;
  }
}

// One element: m and v in, m' and v' out; returns p' before its rounding.
__device__ __forceinline__ float adam_element(float p, float g, float& m, float& v, float bc1,
                                              float bc2, const AdamConsts& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.one_minus_b2, __fmul_rn(g, g)));
  float step = __fdiv_rn(__fmul_rn(c.lr, __fdiv_rn(m, bc1)),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps));
  if (c.decay) step = __fadd_rn(step, __fmul_rn(c.lr_wd, p));
  return __fsub_rn(p, step);
}

// Elements [0, n_vec) in steps of VEC (n_vec a multiple of VEC, 0 where a
// pointer is not 16-byte aligned), then [n_vec, n) one at a time.
template <typename T>
__global__ void __launch_bounds__(NT, 4)
    adamw_update_kernel(const T* __restrict__ p, const T* __restrict__ g,
                        const float* __restrict__ m, const float* __restrict__ v,
                        T* __restrict__ p_out, float* __restrict__ m_out,
                        float* __restrict__ v_out, long long n, long long n_vec,
                        const float* __restrict__ bias1, const float* __restrict__ bias2,
                        AdamConsts c) {
  const float bc1 = *bias1, bc2 = *bias2;
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = t * VEC; i < n_vec; i += stride * VEC) {
    float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
    load_vec(p + i, pv);
    load_vec(g + i, gv);
    load_vec(m + i, mv);
    load_vec(v + i, vv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) pv[j] = adam_element(pv[j], gv[j], mv[j], vv[j], bc1, bc2, c);
    store_vec(p_out + i, pv);
    store_vec(m_out + i, mv);
    store_vec(v_out + i, vv);
  }
  for (long long i = n_vec + t; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    const float pi = adam_element(widen(p[i]), widen(g[i]), mi, vi, bc1, bc2, c);
    narrow(p_out[i], pi);
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

// The block's sum of each thread's acc, by a tree in shared memory (thread
// 0's is the block's).
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float red[NT];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

// partial[blockIdx.x] = the sum of the squares of this block's elements of x.
template <typename T>
__global__ void __launch_bounds__(NT)
    grad_sq_sum_kernel(const T* __restrict__ x, long long n, long long n_vec,
                       float* __restrict__ partial) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  float acc = 0.f;
  for (long long i = t * VEC; i < n_vec; i += stride * VEC) {
    float xv[VEC];
    load_vec(x + i, xv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc = __fadd_rn(acc, __fmul_rn(xv[j], xv[j]));
  }
  for (long long i = n_vec + t; i < n; i += stride) {
    const float xi = widen(x[i]);
    acc = __fadd_rn(acc, __fmul_rn(xi, xi));
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// *out = the sum of partial[0, n), one block.
__global__ void __launch_bounds__(NT)
    grad_sq_sum_final_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) acc = __fadd_rn(acc, partial[i]);
  const float total = block_sum(acc);
  if (threadIdx.x == 0) *out = total;
}

template <typename T>
int launch_update(const void* p, const void* g, const void* m, const void* v, void* p_out,
                  void* m_out, void* v_out, long long n, long long n_vec, int blocks,
                  const void* bc1, const void* bc2, const AdamConsts& c, cudaStream_t stream) {
  adamw_update_kernel<T><<<blocks, NT, 0, stream>>>(
      (const T*)p, (const T*)g, (const float*)m, (const float*)v, (T*)p_out, (float*)m_out,
      (float*)v_out, n, n_vec, (const float*)bc1, (const float*)bc2, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sq_sum(const void* x, long long n, long long n_vec, int blocks, void* partial,
                  cudaStream_t stream) {
  grad_sq_sum_kernel<T><<<blocks, NT, 0, stream>>>((const T*)x, n, n_vec, (float*)partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16 (the update's p and g share theirs).
// Every tensor is contiguous, of n elements; the caller checks dtypes and
// shapes, and picks n_vec (a multiple of 8, 0 unless every pointer is
// 16-byte aligned) and the grid. Each launch goes on the given stream;
// returns a cudaError_t.
int adamw_update(const void* p, const void* g, const void* m, const void* v, void* p_out,
                 void* m_out, void* v_out, long long n, long long n_vec, int blocks,
                 const void* bc1, const void* bc2, float b1, float one_minus_b1, float b2,
                 float one_minus_b2, float lr, float eps, float lr_wd, int decay, int dtype,
                 void* stream) {
  const AdamConsts c{b1, one_minus_b1, b2, one_minus_b2, lr, eps, lr_wd, decay};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_update<__nv_bfloat16>(p, g, m, v, p_out, m_out, v_out, n, n_vec, blocks, bc1,
                                        bc2, c, s);
  if (dtype == 0)
    return launch_update<float>(p, g, m, v, p_out, m_out, v_out, n, n_vec, blocks, bc1, bc2, c,
                                s);
  return (int)cudaErrorInvalidValue;
}

// partial[0, blocks) = the square-sums of the grid's blocks over x.
int grad_sq_sum(const void* x, long long n, long long n_vec, int blocks, void* partial, int dtype,
                void* stream) {
  if (dtype == 1)
    return launch_sq_sum<__nv_bfloat16>(x, n, n_vec, blocks, partial, (cudaStream_t)stream);
  if (dtype == 0) return launch_sq_sum<float>(x, n, n_vec, blocks, partial, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// *out = the sum of partial[0, n).
int grad_sq_sum_final(const void* partial, int n, void* out, void* stream) {
  grad_sq_sum_final_kernel<<<1, NT, 0, (cudaStream_t)stream>>>((const float*)partial, n,
                                                               (float*)out);
  return (int)cudaGetLastError();
}

const char* adamw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
