// Device primitives of the staged step (K1, K5, K2, K3 and K4,
// staged_generate.cu; also K1 card-wide, K6 and the probes): the
// mbarriers, the 1D bulk copies (TMA) and cp.async, named barriers, the
// sampler's reductions over the chain's threads, and the ring of equal
// slots.  Each source that includes it holds its own copy in an anonymous
// namespace; a source built with -DNVW_TRACE defines NVW_TW before
// including it.
//
// Compiled with -fmad=false (utils/build.py).

#ifndef NVW_TORCH_STAGED_COMMON_CUH_
#define NVW_TORCH_STAGED_COMMON_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

using namespace nvw;

constexpr int kMaxThreads = 512;  // chain + prev + producer warps
constexpr int kMaxNC = 4;         // columns a thread owns in one product
constexpr int kChainBar = 1;      // named barrier of the chain's warps
constexpr int kPrevBar = 2;       // named barrier of the prev warps
// the stream's matrices
constexpr int kPrev = 0, kCur = 1, kRs = 2, kOut = 3, kEnd = 4;

struct Mat {
  long long offset;   // bytes from the stream's start (layer 0 for per-layer ones)
  int row_bytes;      // one quad-row: Np * 4 elements
  int rows;           // quad-rows per chunk
  int chunks;
  int kq;             // quad-rows in all, ceil(K / 4)
};

// ---- mbarriers, bulk copies, cp.async, named barriers (sm_90 PTX) ---------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of parity `parity` to complete.  A copy that never
// lands would spin forever: after ~2^34 cycles (~10 s) the block traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- the sampler's reductions over the chain's threads ---------------------
// exact_math.cuh's block helpers with bar.sync 1 over `nt` threads in place
// of __syncthreads: the same association, the same results.

__device__ __forceinline__ float chain_max(float v, int tid, int nt) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  named_sync(kChainBar, nt);
  v = red[0];
  for (int w = 1; w < nt >> 5; ++w) v = fmaxf(v, red[w]);
  named_sync(kChainBar, nt);
  return v;
}

__device__ __forceinline__ int chain_sum_int(int v, int tid, int nt) {
  __shared__ int red[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  named_sync(kChainBar, nt);
  v = 0;
  for (int w = 0; w < nt >> 5; ++w) v += red[w];
  named_sync(kChainBar, nt);
  return v;
}

// index of the FIRST maximal element of v[0, n) (jnp.argmax's tie rule)
__device__ __forceinline__ int chain_argmax(const float* v, int n, int tid, int nt) {
  __shared__ float rv[32];
  __shared__ int ri[32];
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = tid; i < n; i += nt) {
    const float x = v[i];
    if (x > best || (x == best && i < bi)) { best = x; bi = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  if ((tid & 31) == 0) { rv[tid >> 5] = best; ri[tid >> 5] = bi; }
  named_sync(kChainBar, nt);
  best = rv[0];
  bi = ri[0];
  for (int w = 1; w < nt >> 5; ++w) {
    if (rv[w] > best || (rv[w] == best && ri[w] < bi)) { best = rv[w]; bi = ri[w]; }
  }
  named_sync(kChainBar, nt);
  return bi;
}

// the fixed Hillis-Steele prefix sum of exact_math.fixed_tree_cumsum
__device__ __forceinline__ float* chain_cumsum(float* a, float* b, int n, int tid, int nt) {
  for (int k = 1; k < n; k <<= 1) {
    for (int i = tid; i < n; i += nt) b[i] = a[i] + (i >= k ? a[i - k] : 0.0f);
    named_sync(kChainBar, nt);
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// One ring of equal slots and the position of its next chunk: consumers and
// the producer each keep their own.
struct Ring {
  unsigned char* slots;
  uint64_t* full;    // [n] one arrival (the producer's expect_tx) + the bytes
  uint64_t* empty;   // [n] one arrival per consuming warp
  int n;
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// Wait for the chunk in the ring's current slot
__device__ __forceinline__ void ring_wait(Ring& r) {
#ifdef NVW_TRACE
  const long long w0 = clock64();
  bar_wait(r.full + r.slot, r.phase);
  NVW_TW(clock64() - w0);
#else
  bar_wait(r.full + r.slot, r.phase);
#endif
}

__device__ __forceinline__ void ring_release(Ring& r, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(r.empty + r.slot);
  r.advance();
}

// Whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool bar_done(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ int ceil4(int n) { return (n + 3) & ~3; }

}  // namespace

#endif  // NVW_TORCH_STAGED_COMMON_CUH_
