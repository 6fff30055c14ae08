// Standalone launches of the exact-math device library (exact_math.cuh).
//
// K0a exact_fn_kernel<kFn>: elementwise canonical exp / tanh / sigmoid over
//   a flat fp32 tensor.  Replaces the TPU probe kernels of
//   tools/probe_exact_math_tpu.py:90 (exact exp/tanh/sigmoid) and :135
//   (2^k from exponent bits, which em_exp builds the same way).  One
//   instance per function (no per-element branch on it), 16-byte loads and
//   stores of four elements a thread with a scalar tail, and a grid of a
//   few blocks an SM striding over the tensor.
// K0b sample_warp_kernel<A / 32>: the canonical sampler, one warp per row
//   of za [N, A] for A a multiple of 32 up to 1024: max, exp(za - max),
//   fixed-tree prefix sum, count of bins <= sel * sum, silence fallback.
//   Replaces tools/probe_exact_math_tpu.py:107.  Any other A takes the
//   block instance sample_kernel (one block per row, shared memory), chosen
//   by the wrapper from A.
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
// read; K0a's tanh and sigmoid up to ~50, still under the card's ~80
// operations a byte).  K0a's grid-stride loop of float4s and K0b's block
// per row keep every load coalesced.  The block-per-row form spends a row's ~30 operations an
// element against 10+ block barriers (block_max, 8 prefix-sum rounds at
// A = 256), so K0b and K0c hold a row in one warp's registers instead: element
// i = r * 32 + lane in register r of lane `lane` (128-byte coalesced loads
// and stores), the max by shuffles, and the Hillis-Steele rounds without
// shared memory or a barrier: an offset k < 32 takes its partner from lane
// (lane - k) mod 32 by one shuffle a register (register r - 1 for the lanes
// below k), an offset 32 q adds register r - q of the lane itself.  Every
// round pairs the same two partial sums as the shared-memory rounds, so p
// is unchanged to the bit.  Both share those rounds (warp_row_cumsum).
// K0b's select is one fp32 multiply (thr = sel * cum[A-1], the total taken
// from lane 31 by a shuffle), a count of c[r] <= thr over each lane's
// registers and one integer __reduce_add_sync (exact).  K0a and K0b exist
// to hold the device library bit for bit against the plain torch versions;
// the generation kernels inline the same functions.  K0a and K0c are on the
// scorer's path, K0b on speculative decode's (select_window).

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"

namespace {

constexpr int kThreads = 256;

// K0a's functions (the entry point's fn)
constexpr int kExp = 0, kTanh = 1, kSigmoid = 2;

template <int kFn>
__device__ __forceinline__ float exact_fn(float v) {
  if constexpr (kFn == kExp) {
    return nvw::em_exp(v);
  } else if constexpr (kFn == kTanh) {
    return nvw::em_tanh(v);
  } else {
    return nvw::em_sigmoid(v);
  }
}

// y = fn(x) over n elements: n4 float4s from x4 / y4 (16-byte aligned, or
// n4 = 0), then the elements [4 n4, n) one at a time
template <int kFn>
__global__ void __launch_bounds__(kThreads)
exact_fn_kernel(const float* __restrict__ x, float* __restrict__ y, long long n, long long n4) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  auto fn4 = [](const float4 v) {
    return make_float4(exact_fn<kFn>(v.x), exact_fn<kFn>(v.y), exact_fn<kFn>(v.z),
                       exact_fn<kFn>(v.w));
  };
  long long i = first;
  // two float4s in flight a thread
  for (; i + stride < n4; i += 2 * stride) {
    const float4 a = x4[i], b = x4[i + stride];
    y4[i] = fn4(a);
    y4[i + stride] = fn4(b);
  }
  if (i < n4) y4[i] = fn4(x4[i]);
  for (long long k = 4 * n4 + first; k < n; k += stride) y[k] = exact_fn<kFn>(x[k]);
}

template <int kFn>
int launch_exact_fn(const float* x, float* y, long long n, cudaStream_t stream) {
  // float4s where both pointers are 16-byte aligned; a grid of
  // kFnBlocksPerSM blocks an SM at most, each thread striding on
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int kFnBlocksPerSM = 8;   // 2048 threads an SM
  const long long n4 = (((uintptr_t)x | (uintptr_t)y) & 15) ? 0 : n / 4;
  const long long work = n4 + (n - 4 * n4);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kFnBlocksPerSM) blocks = (long long)sms * kFnBlocksPerSM;
  exact_fn_kernel<kFn><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, n4);
  return (int)cudaGetLastError();
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

// The fixed-tree Hillis-Steele prefix sum of a row held in one warp's
// registers (element r * 32 + lane in c[r] of lane `lane`): round k adds
// c[i - k] to c[i] for i >= k, registers from the top down so that each
// round reads the previous round's values
template <int NR>
__device__ __forceinline__ void warp_row_cumsum(float (&c)[NR], int lane) {
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
}

// a row's max over the warp (exact: max does not round)
template <int NR>
__device__ __forceinline__ float warp_row_max(const float (&v)[NR]) {
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < NR; ++r) m = fmaxf(m, v[r]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

// NR = A / 32 registers a lane
template <int NR>
__global__ void __launch_bounds__(kWarpRowThreads)
softmax_p_warp_kernel(const float* __restrict__ za, float* __restrict__ p, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kWarpRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp: its shuffles stay full
  const float* in = za + (size_t)row * (NR * 32);
  float e[NR], c[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) e[r] = in[r * 32 + lane];
  const float m = warp_row_max<NR>(e);
#pragma unroll
  for (int r = 0; r < NR; ++r) c[r] = e[r] = nvw::em_exp(e[r] - m);
  warp_row_cumsum<NR>(c, lane);
  const float total = __shfl_sync(kFull, c[NR - 1], 31);
  float* out = p + (size_t)row * (NR * 32);
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r * 32 + lane] = e[r] / total;
}

// NR = A / 32 registers a lane; y = #{i : cum[i] <= sel * cum[A-1]}, or
// silence_bin where that is A
template <int NR>
__global__ void __launch_bounds__(kWarpRowThreads)
sample_warp_kernel(const float* __restrict__ za, const float* __restrict__ sel,
                   int* __restrict__ y, int rows, int silence_bin) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kWarpRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp: its shuffles stay full
  const float u = sel[row];  // one broadcast load, in flight beside the row
  const float* in = za + (size_t)row * (NR * 32);
  float c[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) c[r] = in[r * 32 + lane];
  const float m = warp_row_max<NR>(c);
#pragma unroll
  for (int r = 0; r < NR; ++r) c[r] = nvw::em_exp(c[r] - m);
  warp_row_cumsum<NR>(c, lane);
  const float thr = u * __shfl_sync(kFull, c[NR - 1], 31);
  int n = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) n += c[r] <= thr ? 1 : 0;
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) y[row] = n < NR * 32 ? n : silence_bin;
}

template <int NR>
int launch_sample_warp(const float* za, const float* sel, int* y, int rows, int silence_bin,
                       cudaStream_t stream) {
  const int per_block = kWarpRowThreads / 32;
  sample_warp_kernel<NR><<<(rows + per_block - 1) / per_block, kWarpRowThreads, 0, stream>>>(
      za, sel, y, rows, silence_bin);
  return (int)cudaGetLastError();
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (fn == kExp) return launch_exact_fn<kExp>(x, y, n, s);
  if (fn == kTanh) return launch_exact_fn<kTanh>(x, y, n, s);
  if (fn == kSigmoid) return launch_exact_fn<kSigmoid>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

// K0b: A a multiple of 32, at most 1024 (anything else: cudaErrorInvalidValue)
int nvw_sample(const float* za, const float* sel, int* y, int rows, int A, int silence_bin,
               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (A) {
#define NVW_SAMPLE_CASE(NR) \
  case NR * 32:             \
    return launch_sample_warp<NR>(za, sel, y, rows, silence_bin, st);
    NVW_SAMPLE_CASE(1) NVW_SAMPLE_CASE(2) NVW_SAMPLE_CASE(3) NVW_SAMPLE_CASE(4)
    NVW_SAMPLE_CASE(5) NVW_SAMPLE_CASE(6) NVW_SAMPLE_CASE(7) NVW_SAMPLE_CASE(8)
    NVW_SAMPLE_CASE(9) NVW_SAMPLE_CASE(10) NVW_SAMPLE_CASE(11) NVW_SAMPLE_CASE(12)
    NVW_SAMPLE_CASE(13) NVW_SAMPLE_CASE(14) NVW_SAMPLE_CASE(15) NVW_SAMPLE_CASE(16)
    NVW_SAMPLE_CASE(17) NVW_SAMPLE_CASE(18) NVW_SAMPLE_CASE(19) NVW_SAMPLE_CASE(20)
    NVW_SAMPLE_CASE(21) NVW_SAMPLE_CASE(22) NVW_SAMPLE_CASE(23) NVW_SAMPLE_CASE(24)
    NVW_SAMPLE_CASE(25) NVW_SAMPLE_CASE(26) NVW_SAMPLE_CASE(27) NVW_SAMPLE_CASE(28)
    NVW_SAMPLE_CASE(29) NVW_SAMPLE_CASE(30) NVW_SAMPLE_CASE(31) NVW_SAMPLE_CASE(32)
#undef NVW_SAMPLE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K0b's block instance: any A
int nvw_sample_block(const float* za, const float* sel, int* y, int rows, int A,
                     int silence_bin, void* stream) {
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
