// The grid barrier of K1 card-wide (wide_generate.cu), which its probe
// (probes.cu P6) times alone: one count of arrivals in global memory,
// zeroed before the launch (cooperative groups' grid sync, split so that
// the count of barrier n is n times the grid).  After the CTA's threads
// sync, one thread adds the CTA's arrival with release semantics and polls
// the count with acquire loads; other threads of the CTA may poll it too.
//
// On an H100 this one level costs ~1.0 us a barrier over 128 CTAs, one an
// SM, and a second poller a CTA ~0.08 us more.  A two-level form (a
// cluster's CTAs gathering on their leader's mbarrier, one global arrival
// and one global poller a cluster; probes.cu) costs ~1.9 us: every release
// at cluster or gpu scope compiles to MEMBAR.ALL.GPU, and it puts three of
// them in series where this form has one.
//
// A barrier that never completes traps after ~2^34 cycles (~10 s), so the
// launch fails instead of hanging the card.

#ifndef NVW_TORCH_GRID_BARRIER_CUH_
#define NVW_TORCH_GRID_BARRIER_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kBarrierTrapCycles = 1ll << 34;

__device__ __forceinline__ unsigned int grid_count(const unsigned int* sync) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(sync) : "memory");
  return v;
}

// Spin until barrier n has all its arrivals
__device__ __forceinline__ void grid_wait(const unsigned int* sync, unsigned int n) {
  const unsigned int target = n * gridDim.x;
  const long long start = clock64();
  while (grid_count(sync) < target) {
    if (clock64() - start > kBarrierTrapCycles) __trap();
  }
}

__device__ __forceinline__ void grid_arrive(unsigned int* sync) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(sync) : "memory");
}

}  // namespace

#endif  // NVW_TORCH_GRID_BARRIER_CUH_
