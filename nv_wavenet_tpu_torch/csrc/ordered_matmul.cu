// K7: y[m, n] = sum_k x[m, k] W[k, n] in K1's summation order.
//
// No Pallas counterpart: the JAX time-parallel scorer leaves its products to
// XLA (nv_wavenet_tpu/ops/score_parallel.py:135-139, 150-151, 163-168).  The
// port's scorer needs them in the order of K1's dot_column
// (persistent.cu): each output accumulated from 0.0f over k = 0, 1, ...,
// K-1, every product and every sum rounded once (-fmad=false, utils/
// build.py).  cuBLAS keeps no such order, so a scorer on it would leave a
// FIFO ring that differs from K1's in the last ulps, and a score -> feed
// handoff would stop being exact.  With this kernel the scorer's
// distributions, ring and y_state equal the forced kernel K2's bit for bit.
//
// Design (simple first): a block computes a 64 x 64 tile of y; each of its
// 256 threads holds 4 x 4 outputs in registers (rows ty + 16 i, columns
// tx + 16 j, so a warp's shared-memory reads are broadcasts or consecutive).
// x and W tiles of 16 k-steps at a time are staged through shared memory;
// every output walks k in order across the tiles.
//
// What bounds it: 2 M N K fp32 operations issued as separate FMUL and FADD
// (no FMA, so twice the instructions of a fused product) on the CUDA cores,
// never the tensor cores; at the scorer's shapes (K <= 256) the operations,
// not the bytes, bound it.  Register tiles wider than 4 x 4, double-buffered
// staging and cp.async are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;   // outputs per thread: rows x columns

__global__ void __launch_bounds__(kThreads)
ordered_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[kBK][kBM];   // x tile, k-major
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, k = e % kBK;
      xs[k][m] = (m0 + m < M && k0 + k < K) ? x[(size_t)(m0 + m) * K + k0 + k] : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e % kBN;
      ws[k][n] = (k0 + k < K && n0 + n < N) ? w[(size_t)(k0 + k) * N + n0 + n] : 0.0f;
    }
    __syncthreads();
    const int kn = min(kBK, K - k0);   // never add the zero padding
    for (int k = 0; k < kn; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [M, K], w [K, N], y [M, N], all fp32, row-major and contiguous
int nvw_ordered_matmul(const float* x, const float* w, float* y, int M, int N, int K,
                       void* stream) {
  // row tiles on x (up to 2^31 - 1 of them), column tiles on y
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  ordered_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, w, y, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
