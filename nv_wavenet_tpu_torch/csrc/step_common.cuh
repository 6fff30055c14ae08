// Device code shared by the generation kernels (staged_generate.cu,
// generic_generate.cu, stream_generate.cu, fused_chain.cu and the others):
// the modes and the selector sources, the precisions and their roundings,
// the fixed-order column products and K3's Philox draw.  One copy, so the
// kernels that chip_smoke.py holds to one another bit for bit compile the
// same sums, roundings and draws.
// Everything is force-inlined.
//
// Compiled with -fmad=false (utils/build.py): every a*b+c rounds twice, as
// in the plain torch version.

#ifndef NVW_TORCH_STEP_COMMON_CUH_
#define NVW_TORCH_STEP_COMMON_CUH_

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nvw {

// the entry points' modes (ops/persistent.py _MODE_IDS)
constexpr int kModeSample = 0;
constexpr int kModeArgmax = 1;
constexpr int kModeForced = 2;
constexpr int kModePrng = 3;
// where a step's selector comes from
constexpr int kSelInjected = 0;   // sel[j, b], a uniform (K1, K5)
constexpr int kSelForced = 1;     // sel[j, b], the symbol to emit (K2)
constexpr int kSelPrng = 2;       // Philox4x32-10 on the card (K3)

// The precision of a step's products (ops/scan_generate.py PRECISIONS):
//   exact  fp32 throughout;
//   fast   fast_math, the TPU's DEFAULT matrix precision: every activation
//          enters a product rounded to bf16 (the weights arrive rounded),
//          products and sums stay fp32, the residual stream x and the FIFO
//          ring stay fp32;
//   bf16   compute_dtype=bfloat16: fast, and x is stored rounded (after the
//          embedding and after each residual add, which is done in fp32) and
//          the ring holds bf16.
// A bf16 x bf16 product is exact in fp32, so the order of the sums is the
// only freedom left, and it is the exact kernels' order.
constexpr int kPrecExact = 0;
constexpr int kPrecFast = 1;
constexpr int kPrecBF16 = 2;

// v rounded to bf16, round to nearest even (torch's .to(torch.bfloat16))
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v as a product operand
template <int kPrec>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kPrec == kPrecExact) {
    return v;
  } else {
    return round_bf16(v);
  }
}

// v as the residual stream stores it
template <int kPrec>
__device__ __forceinline__ float stored(float v) {
  if constexpr (kPrec == kPrecBF16) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// Element i of the FIFO ring: bf16 under kPrecBF16 (the pointer is the
// ring's, passed as float* through the entry points), else fp32.  The ring
// only ever stores values of x, which are bf16 values there, so the store
// is exact.
template <int kPrec>
__device__ __forceinline__ float ring_get(const float* ring, size_t i) {
  if constexpr (kPrec == kPrecBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(ring)[i]);
  } else {
    return ring[i];
  }
}

template <int kPrec>
__device__ __forceinline__ void ring_put(float* ring, size_t i, float v) {
  if constexpr (kPrec == kPrecBF16) {
    reinterpret_cast<__nv_bfloat16*>(ring)[i] = __float2bfloat16_rn(v);
  } else {
    ring[i] = v;
  }
}

// v[0, K) . w[0], w[stride], ... in the fixed order k = 0, 1, ..., K-1
__device__ __forceinline__ float dot_column(const float* v, const float* __restrict__ w,
                                            int K, int stride) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = acc + v[k] * __ldg(w + (size_t)k * stride);
  return acc;
}

// dot_column's sums in the same order, with the weights of eight k-steps
// loaded before their products, so eight L2 loads are in flight at once.
// In the first K2 instance ptxas interleaved dot_column's loads with the
// dependent adds, exposing each load's latency alone (295 us per flagship
// step on an H100 against K1's 183; PERF.md).  The first K4 and the
// generic K2/K3 use this form; the generic K1/K5 and P5's stage chain
// (probes.cu) use dot_column.
__device__ __forceinline__ float dot_column_batched(const float* v, const float* __restrict__ w,
                                                    int K, int stride) {
  float acc = 0.0f;
  int k = 0;
  for (; k + 8 <= K; k += 8) {
    float wk[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) wk[u] = __ldg(w + (size_t)(k + u) * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = acc + v[k + u] * wk[u];
  }
  for (; k < K; ++k) acc = acc + v[k] * __ldg(w + (size_t)k * stride);
  return acc;
}

// Philox4x32-10 word 0 for counter (t_lo, t_hi, row, 0), key (seed_lo,
// seed_hi), mapped to [0, 1) by its top 24 bits: the kernel's uniform for
// absolute step t of row `row`
__device__ __forceinline__ float philox_uniform(unsigned long long seed, long long t, int row) {
  unsigned c0 = (unsigned)t, c1 = (unsigned)((unsigned long long)t >> 32);
  unsigned c2 = (unsigned)row, c3 = 0u;
  unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return (float)(c0 >> 8) * 0x1.0p-24f;
}

}  // namespace nvw

#endif  // NVW_TORCH_STEP_COMMON_CUH_
