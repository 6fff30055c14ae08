// Standalone launches of the exact-math device library (exact_math.cuh).
//
// K0a exact_fn_kernel: elementwise canonical exp / tanh / sigmoid over a flat
//   fp32 tensor.  Replaces the TPU probe kernels of
//   tools/probe_exact_math_tpu.py:90 (exact exp/tanh/sigmoid) and :135
//   (2^k from exponent bits, which em_exp builds the same way).
// K0b sample_kernel: the canonical sampler, one block per row of za [N, A]:
//   max, exp(za - max), fixed-tree prefix sum, count of bins <= sel * sum,
//   silence fallback.  Replaces tools/probe_exact_math_tpu.py:107.
// K0c softmax_p_warp_kernel<A / 32>: the canonical softmax, one warp per row
//   of za [N, A] for A a multiple of 32 up to 1024: max, e = exp(za - max),
//   fixed-tree prefix sum, p = e / cum[A-1] (IEEE division; -prec-div stays
//   on).  No Pallas counterpart: the JAX time-parallel scorer computes it in
//   XLA (persistent.py:64-71, softmax_canonical); K2 writes the same p per
//   step, so the scorer's p_seq equals K2's bit for bit.  Any other A takes
//   the block instance softmax_p_kernel (one block per row, shared memory),
//   chosen by the wrapper from A.
//
// All three are memory-bound streams (a few tens of fp32 ops per element
// read).  K0a's grid-stride loop and K0b's block per row keep every load
// coalesced.  The block-per-row form spends a row's ~30 operations an
// element against 10+ block barriers (block_max, 8 prefix-sum rounds at
// A = 256), so K0c holds a row in one warp's registers instead: element
// i = r * 32 + lane in register r of lane `lane` (128-byte coalesced loads
// and stores), the max by shuffles, and the Hillis-Steele rounds without
// shared memory or a barrier: an offset k < 32 takes its partner from lane
// (lane - k) mod 32 by one shuffle a register (register r - 1 for the lanes
// below k), an offset 32 q adds register r - q of the lane itself.  Every
// round pairs the same two partial sums as the shared-memory rounds, so p
// is unchanged to the bit.  K0a and K0b exist to hold the device library
// bit for bit against the plain torch versions; the generation kernel
// (persistent.cu) inlines the same functions.  K0a and K0c are on the
// scorer's path.

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

// dynamic shared memory: 3 * A floats (e, and the prefix-sum ping-pong pair)
__global__ void __launch_bounds__(kThreads)
softmax_p_kernel(const float* __restrict__ za, float* __restrict__ p, int A) {
  extern __shared__ float smem[];
  float* e = smem;
  float* c0 = smem + A;
  float* c1 = c0 + A;
  const float* row = za + (size_t)blockIdx.x * A;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < A; i += blockDim.x) m = fmaxf(m, row[i]);
  m = nvw::block_max(m);
  for (int i = threadIdx.x; i < A; i += blockDim.x) c0[i] = e[i] = nvw::em_exp(row[i] - m);
  __syncthreads();
  const float total = nvw::block_fixed_tree_cumsum(c0, c1, A)[A - 1];
  float* out = p + (size_t)blockIdx.x * A;
  for (int i = threadIdx.x; i < A; i += blockDim.x) out[i] = e[i] / total;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRowThreads = 256;   // 8 rows a block

// NR = A / 32 registers a lane
template <int NR>
__global__ void __launch_bounds__(kWarpRowThreads)
softmax_p_warp_kernel(const float* __restrict__ za, float* __restrict__ p, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kWarpRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp: its shuffles stay full
  const float* in = za + (size_t)row * (NR * 32);
  float e[NR], c[NR];
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    e[r] = in[r * 32 + lane];
    m = fmaxf(m, e[r]);
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));   // exact
#pragma unroll
  for (int r = 0; r < NR; ++r) c[r] = e[r] = nvw::em_exp(e[r] - m);
  // round k: c[i] + (i >= k ? c[i - k] : 0), registers from the top down so
  // that each round reads the previous round's values
#pragma unroll
  for (int lg = 0; (1 << lg) < NR * 32; ++lg) {
    const int k = 1 << lg;
    if (k < 32) {
#pragma unroll
      for (int r = NR - 1; r >= 0; --r) {
        // lane s sends what lane s + k needs: its register r, or r - 1 to
        // the lanes that wrap below k
        const float send = lane < 32 - k ? c[r] : (r > 0 ? c[r - 1] : 0.0f);
        const float t = __shfl_sync(kFull, send, (lane - k) & 31);
        c[r] = c[r] + (r > 0 || lane >= k ? t : 0.0f);
      }
    } else {
      const int q = k >> 5;
#pragma unroll
      for (int r = NR - 1; r >= 0; --r) c[r] = c[r] + (r >= q ? c[r >= q ? r - q : 0] : 0.0f);
    }
  }
  const float total = __shfl_sync(kFull, c[NR - 1], 31);
  float* out = p + (size_t)row * (NR * 32);
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r * 32 + lane] = e[r] / total;
}

template <int NR>
int launch_softmax_warp(const float* za, float* p, int rows, cudaStream_t stream) {
  const int per_block = kWarpRowThreads / 32;
  softmax_p_warp_kernel<NR><<<(rows + per_block - 1) / per_block, kWarpRowThreads, 0, stream>>>(
      za, p, rows);
  return (int)cudaGetLastError();
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

// K0c: A a multiple of 32, at most 1024 (anything else: cudaErrorInvalidValue)
int nvw_softmax_p(const float* za, float* p, int rows, int A, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (A) {
#define NVW_SOFTMAX_CASE(NR) \
  case NR * 32:              \
    return launch_softmax_warp<NR>(za, p, rows, st);
    NVW_SOFTMAX_CASE(1) NVW_SOFTMAX_CASE(2) NVW_SOFTMAX_CASE(3) NVW_SOFTMAX_CASE(4)
    NVW_SOFTMAX_CASE(5) NVW_SOFTMAX_CASE(6) NVW_SOFTMAX_CASE(7) NVW_SOFTMAX_CASE(8)
    NVW_SOFTMAX_CASE(9) NVW_SOFTMAX_CASE(10) NVW_SOFTMAX_CASE(11) NVW_SOFTMAX_CASE(12)
    NVW_SOFTMAX_CASE(13) NVW_SOFTMAX_CASE(14) NVW_SOFTMAX_CASE(15) NVW_SOFTMAX_CASE(16)
    NVW_SOFTMAX_CASE(17) NVW_SOFTMAX_CASE(18) NVW_SOFTMAX_CASE(19) NVW_SOFTMAX_CASE(20)
    NVW_SOFTMAX_CASE(21) NVW_SOFTMAX_CASE(22) NVW_SOFTMAX_CASE(23) NVW_SOFTMAX_CASE(24)
    NVW_SOFTMAX_CASE(25) NVW_SOFTMAX_CASE(26) NVW_SOFTMAX_CASE(27) NVW_SOFTMAX_CASE(28)
    NVW_SOFTMAX_CASE(29) NVW_SOFTMAX_CASE(30) NVW_SOFTMAX_CASE(31) NVW_SOFTMAX_CASE(32)
#undef NVW_SOFTMAX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K0c's block instance: any A
int nvw_softmax_p_block(const float* za, float* p, int rows, int A, void* stream) {
  const size_t smem = 3 * (size_t)A * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        softmax_p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  softmax_p_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(za, p, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
