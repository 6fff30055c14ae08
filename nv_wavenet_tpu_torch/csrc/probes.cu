// The port's two probe kernels, counterparts of the JAX package's TPU probes.
// This source is built twice (utils/build.py FMAD_SOURCES): unit `probes.cu`
// with the port's -fmad=false, and unit `probes.cu@fmad` with -fmad=true and
// NVW_FMAD=1, the one library of the port where nvcc may contract a*b+c into
// an FMA.  The entry points of the second carry a suffix, so both libraries
// can be loaded into one process.
//
// P1 fma_probe_kernel<kGuarded>: o = a*b + c elementwise.  Replaces
//   tools/probe_exact_math_tpu.py:69 (kern_plain, kern_bar at :61-65), which
//   asked whether the TPU's compiler contracts mul+add.  kGuarded=false
//   writes it plainly: one FMA (one rounding) under -fmad=true, a rounded
//   multiply and a rounded add under -fmad=false.  kGuarded=true writes
//   __fadd_rn(__fmul_rn(a, b), c), which nvcc never contracts, whatever the
//   flag: the guarded form the TPU probe's barrier stood for.  So one run
//   shows the contraction that -fmad=false prevents in every other kernel
//   of the port.  Bound: bytes (three 4-byte reads and a write per element);
//   a grid-stride loop keeps every load coalesced.
//
// P5 stage_chain_kernel<kGate, kSmemW>: T steps, each a chain of D dependent
//   products x <- g(x W_d), x [rows, R], W_d [R, 2R], g the gate
//   tanh(z[:R]) * sigmoid(z[R:]) or, without the gate, z[:R] + z[R:]; G
//   independent chains advanced in the same loop body.  Replaces
//   tools/probe_stage.py:65 (make_chain): the per-stage latency floor of the
//   generation kernels, whose step is a chain of 2L+3 such stages (K1) or
//   L+5 (K6).  As there, t is folded into x at each step (x + (t == -1)), so
//   the loop cannot be hoisted.  Layout: `rows` batch rows per CTA (1 is K1's
//   layout, one CTA per row; B runs the whole batch in one CTA), 256
//   threads, one output column per thread and task; x and z live in shared
//   memory.  W_d is read from global memory (L2), as K1 reads its weights
//   (kSmemW=false), or from a copy staged into shared memory once per
//   launch, as K4 stages its stacks (kSmemW=true; needs D R 2R 4 bytes of
//   shared memory).  The exact precision (unit probes.cu) is K1's: its
//   column product (step_common.cuh dot_column, every product and sum
//   rounded) and the canonical tanh and sigmoid (exact_math.cuh), so it
//   equals the plain torch version bit for bit.  The fast precision (unit
//   probes.cu@fmad) contracts the products to FMAs and takes tanhf and
//   __expf: the counterpart of the TPU probe's precision=DEFAULT.  Bound:
//   the latency of the dependent chain (each stage waits for the last one's
//   x through shared memory and two barriers), far above its operations.

#include <cuda_runtime.h>

#include "exact_math.cuh"
#include "step_common.cuh"

#ifndef NVW_FMAD
#define NVW_FMAD 0
#endif
#if NVW_FMAD
#define NVW_FMA_PROBE nvw_fma_probe_fmad
#define NVW_STAGE_CHAIN nvw_stage_chain_fast
#else
#define NVW_FMA_PROBE nvw_fma_probe
#define NVW_STAGE_CHAIN nvw_stage_chain
#endif

namespace {

constexpr int kThreads = 256;
constexpr bool kFast = NVW_FMAD != 0;

template <bool kGuarded>
__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if constexpr (kGuarded) {
      o[i] = __fadd_rn(__fmul_rn(a[i], b[i]), c[i]);
    } else {
      o[i] = a[i] * b[i] + c[i];
    }
  }
}

// x[0, K) . w[0], w[stride], ... from shared memory, k in order
__device__ __forceinline__ float dot_column_shared(const float* v, const float* w, int K,
                                                   int stride) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = acc + v[k] * w[k * stride];
  return acc;
}

__device__ __forceinline__ float gate(float zt, float zs) {
  if constexpr (kFast) {
    return tanhf(zt) * (1.0f / (1.0f + __expf(-zs)));
  } else {
    return nvw::em_tanh(zt) * nvw::em_sigmoid(zs);
  }
}

// dynamic shared memory: x [G, rows, R], z [G, rows, 2R], then W [D, R, 2R]
// when kSmemW
template <bool kGate, bool kSmemW>
__global__ void __launch_bounds__(kThreads)
stage_chain_kernel(const float* __restrict__ w, const float* __restrict__ x_in,
                   float* __restrict__ x_out, int B, int R, int D, int T, int G, int rows) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * rows;
  const int n_rows = min(rows, B - row0);
  const int C = 2 * R;
  float* xs = smem;                       // [G, rows, R]
  float* zs = smem + (size_t)G * rows * R;  // [G, rows, 2R]
  float* ws = zs + (size_t)G * rows * C;    // [D, R, 2R] (kSmemW)
  const int nx = G * n_rows * R, nz = G * n_rows * C;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int g = i / (n_rows * R), rj = i % (n_rows * R);
    xs[i] = x_in[((size_t)g * B + row0) * R + rj];
  }
  if constexpr (kSmemW) {
    for (int i = threadIdx.x; i < D * R * C; i += blockDim.x) ws[i] = w[i];
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float tf = (float)(t == -1);
    for (int i = threadIdx.x; i < nx; i += blockDim.x) xs[i] = xs[i] + tf;
    __syncthreads();
    for (int d = 0; d < D; ++d) {
      for (int i = threadIdx.x; i < nz; i += blockDim.x) {
        const int gr = i / C, c = i % C;
        const float* v = xs + (size_t)gr * R;
        if constexpr (kSmemW) {
          zs[i] = dot_column_shared(v, ws + (size_t)d * R * C + c, R, C);
        } else {
          zs[i] = nvw::dot_column(v, w + (size_t)d * R * C + c, R, C);
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nx; i += blockDim.x) {
        const int gr = i / R, j = i % R;
        const float* z = zs + (size_t)gr * C;
        xs[i] = kGate ? gate(z[j], z[R + j]) : z[j] + z[R + j];
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const int g = i / (n_rows * R), rj = i % (n_rows * R);
    x_out[((size_t)g * B + row0) * R + rj] = xs[i];
  }
}

template <bool kGate, bool kSmemW>
int launch_chain(const float* w, const float* x, float* out, int B, int R, int D, int T, int G,
                 int rows, cudaStream_t stream) {
  auto kernel = stage_chain_kernel<kGate, kSmemW>;
  const size_t floats = (size_t)G * rows * 3 * R + (kSmemW ? (size_t)D * R * 2 * R : 0);
  const size_t bytes = floats * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + rows - 1) / rows, kThreads, bytes, stream>>>(w, x, out, B, R, D, T, G, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// a, b, c, o: [n] fp32
int NVW_FMA_PROBE(const float* a, const float* b, const float* c, float* o, long long n,
                  int guarded, void* stream) {
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 4096 ? need : 4096);
  if (guarded) {
    fma_probe_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, o, n);
  } else {
    fma_probe_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, o, n);
  }
  return (int)cudaGetLastError();
}

// w [D, R, 2R], x [G, B, R] -> out [G, B, R], fp32, contiguous; `rows`
// batch rows per CTA; gate and smem_w select the instance
int NVW_STAGE_CHAIN(const float* w, const float* x, float* out, int B, int R, int D, int T,
                    int G, int rows, int gate, int smem_w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (gate) {
    return smem_w ? launch_chain<true, true>(w, x, out, B, R, D, T, G, rows, s)
                  : launch_chain<true, false>(w, x, out, B, R, D, T, G, rows, s);
  }
  return smem_w ? launch_chain<false, true>(w, x, out, B, R, D, T, G, rows, s)
                : launch_chain<false, false>(w, x, out, B, R, D, T, G, rows, s);
}

}  // extern "C"
