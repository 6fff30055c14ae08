// Bit-identical fp32 transcendentals and the canonical sampler pieces for
// CUDA: the device twin of nv_wavenet_tpu_torch/ops/exact_math.py (and of
// the JAX package's ops/exact_math.py, its numpy twins and csrc/exact_math.h).
//
// Every operation is an exactly-rounded fp32 add / sub / mul / min / max /
// floor / int shift / bitcast, in the NORMATIVE op order and Estrin
// association of exact_math.py.  The library MUST be compiled with
// -fmad=false (utils/build.py): nvcc otherwise contracts a*b+c into an FMA,
// which rounds once instead of twice and breaks the cross-implementation
// bit-identity the exact-match contract rests on.  No --use_fast_math
// (approximate expf and division), no flush-to-zero.
//
// The block-level helpers (max, argmax, integer sum, fixed-tree prefix sum,
// counting select) must be called by every thread of the block; blockDim.x
// must be a multiple of 32 and at most 1024.

#ifndef NVW_TORCH_EXACT_MATH_CUH_
#define NVW_TORCH_EXACT_MATH_CUH_

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace nvw {

__host__ __device__ __forceinline__ float bits_to_float(int b) {
#ifdef __CUDA_ARCH__
  return __int_as_float(b);
#else
  float f;
  memcpy(&f, &b, 4);
  return f;
#endif
}

// canonical fp32 e^x, input clamped to [-87, 88]
__host__ __device__ __forceinline__ float em_exp(float x) {
  const float kLog2e = 0x1.715476p+0f;
  const float kLn2Hi = 0x1.62e400p-1f;   // 12 trailing zero mantissa bits
  const float kLn2Lo = 0x1.7f7d1cp-20f;
  x = fminf(fmaxf(x, -87.0f), 88.0f);
  const float k = floorf(x * kLog2e + 0.5f);
  const float r = (x - k * kLn2Hi) - k * kLn2Lo;
  const float r2 = r * r;
  const float r4 = r2 * r2;
  // pA = E6 r2 + (E5 r + E4); pB = E3 r + E2; pC = r + 1
  const float pA = 0x1.6d7536p-10f * r2 + (0x1.123d86p-7f * r + 0x1.5554acp-5f);
  const float pB = 0x1.55547cp-3f * r + 0x1.000000p-1f;
  const float pC = r + 1.0f;
  const float p = pA * r4 + (pB * r2 + pC);
  const int ki = (int)k;
  return p * bits_to_float((ki + 127) << 23);
}

// 1/(1+e) for e in [0, 1], division-free: one degree-9 polynomial (Estrin)
__host__ __device__ __forceinline__ float em_recip_1p(float e) {
  const float e2 = e * e;
  const float e4 = e2 * e2;
  const float e8 = e4 * e4;
  const float q0 = -0x1.fffef8p-1f * e + 0x1.fffffep-1f;    // R1 e + R0
  const float q1 = -0x1.fe110ap-1f * e + 0x1.ffdbfcp-1f;    // R3 e + R2
  const float q2 = -0x1.c4ffa4p-1f * e + 0x1.f22c3cp-1f;    // R5 e + R4
  const float q3 = -0x1.90ca58p-2f * e + 0x1.5ccfdap-1f;    // R7 e + R6
  const float q4 = -0x1.874680p-6f * e + 0x1.235bd0p-3f;    // R9 e + R8
  const float h0 = q1 * e2 + q0;
  const float h1 = q3 * e2 + q2;
  return q4 * e8 + (h1 * e4 + h0);
}

// canonical fp32 tanh
__host__ __device__ __forceinline__ float em_tanh(float x) {
  const float s = fabsf(x);
  if (s < 0.5f) {
    const float u = x * x;
    const float u2 = u * u;
    const float a = 0x1.5f814ep-9f * u + -0x1.1a8ffap-7f;   // D5 u + D4
    const float b = 0x1.65d0fap-6f * u + -0x1.ba1802p-5f;   // D3 u + D2
    const float c = 0x1.11110cp-3f * u + -0x1.555556p-2f;   // D1 u + D0
    const float q = (a * u2 + b) * u2 + c;
    return x + (x * u) * q;
  }
  const float e2 = em_exp(s * -2.0f);
  const float tb = 1.0f - (e2 + e2) * em_recip_1p(e2);
  return x < 0.0f ? -tb : tb;
}

// canonical fp32 logistic sigmoid
__host__ __device__ __forceinline__ float em_sigmoid(float x) {
  const float e = em_exp(-fabsf(x));
  const float r = em_recip_1p(e);
  return x >= 0.0f ? r : e * r;
}

#ifdef __CUDACC__

// max over the block; every thread gets the result (order-free: max is exact)
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < nw; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

// integer sum over the block (exact); every thread gets the result
__device__ __forceinline__ int block_sum_int(int v) {
  __shared__ int red[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < nw; ++w) v += red[w];
  __syncthreads();
  return v;
}

// index of the FIRST maximal element of v[0, n) (jnp.argmax's tie rule)
__device__ __forceinline__ int block_argmax(const float* v, int n) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = v[i];
    if (x > best || (x == best && i < bi)) { best = x; bi = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { rv[warp] = best; ri[warp] = bi; }
  __syncthreads();
  best = rv[0];
  bi = ri[0];
  for (int w = 1; w < nw; ++w) {
    if (rv[w] > best || (rv[w] == best && ri[w] < bi)) { best = rv[w]; bi = ri[w]; }
  }
  __syncthreads();
  return bi;
}

// Inclusive prefix sum of a[0, n) with the FIXED Hillis-Steele association
// of exact_math.fixed_tree_cumsum: log2(n) rounds of
// x[i] + (i >= k ? x[i-k] : 0), ping-ponging between a and b with one
// __syncthreads per round.  a must be complete (synced) on entry; returns
// the buffer holding the result (a or b), synced.
__device__ __forceinline__ float* block_fixed_tree_cumsum(float* a, float* b, int n) {
  for (int k = 1; k < n; k <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) b[i] = a[i] + (i >= k ? a[i - k] : 0.0f);
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// canonical inverse-CDF pick over the UNNORMALIZED prefix sum: the count of
// bins with cum <= sel * cum[n-1], silence_bin when that count is n
__device__ __forceinline__ int block_select_from_cumsum(const float* cum, float sel, int n,
                                                        int silence_bin) {
  const float thr = sel * cum[n - 1];
  int c = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) c += cum[i] <= thr ? 1 : 0;
  c = block_sum_int(c);
  return c < n ? c : silence_bin;
}

#endif  // __CUDACC__

}  // namespace nvw

#endif  // NVW_TORCH_EXACT_MATH_CUH_
