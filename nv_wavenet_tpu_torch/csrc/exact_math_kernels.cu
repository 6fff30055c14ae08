// Standalone launches of the exact-math device library (exact_math.cuh).
//
// K0a exact_fn_kernel: elementwise canonical exp / tanh / sigmoid over a flat
//   fp32 tensor.  Replaces the TPU probe kernels of
//   tools/probe_exact_math_tpu.py:90 (exact exp/tanh/sigmoid) and :135
//   (2^k from exponent bits, which em_exp builds the same way).
// K0b sample_kernel: the canonical sampler, one block per row of za [N, A]:
//   max, exp(za - max), fixed-tree prefix sum, count of bins <= sel * sum,
//   silence fallback.  Replaces tools/probe_exact_math_tpu.py:107.
//
// Both are memory-bound streams (a few tens of fp32 ops per element read);
// the grid-stride loop and one block per row keep every load coalesced.  They
// exist to hold the device library bit for bit against the plain torch
// versions; the generation kernel (persistent.cu) inlines the same functions.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
exact_fn_kernel(const float* __restrict__ x, float* __restrict__ y, long long n, int fn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = x[i];
    y[i] = fn == 0 ? nvw::em_exp(v) : (fn == 1 ? nvw::em_tanh(v) : nvw::em_sigmoid(v));
  }
}

// dynamic shared memory: 2 * A floats (e and the prefix-sum ping-pong buffer)
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ za, const float* __restrict__ sel, int* __restrict__ y,
              int A, int silence_bin) {
  extern __shared__ float smem[];
  float* e = smem;
  float* c = smem + A;
  const float* row = za + (size_t)blockIdx.x * A;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < A; i += blockDim.x) m = fmaxf(m, row[i]);
  m = nvw::block_max(m);   // exact: max does not round
  for (int i = threadIdx.x; i < A; i += blockDim.x) e[i] = nvw::em_exp(row[i] - m);
  __syncthreads();
  const float* cum = nvw::block_fixed_tree_cumsum(e, c, A);
  const int v = nvw::block_select_from_cumsum(cum, sel[blockIdx.x], A, silence_bin);
  if (threadIdx.x == 0) y[blockIdx.x] = v;
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// fn: 0 exp, 1 tanh, 2 sigmoid
int nvw_exact_fn(const float* x, float* y, long long n, int fn, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  exact_fn_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(x, y, n, fn);
  return (int)cudaGetLastError();
}

int nvw_sample(const float* za, const float* sel, int* y, int rows, int A, int silence_bin,
               void* stream) {
  const size_t smem = 2 * (size_t)A * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sample_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(za, sel, y, A, silence_bin);
  return (int)cudaGetLastError();
}

}  // extern "C"
