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
//   of the port.  Bound: bytes (three 4-byte reads and a write per
//   element).  The design is K0a's (exact_math_kernels.cu): 16-byte loads
//   and stores of four elements where all four pointers are 16-byte
//   aligned (the wrapper passes the count of float4s, n4; 0 for an offset
//   view, which takes the scalar loop alone), two float4s in flight a
//   thread, a scalar tail, and a grid of at most 64 blocks an SM striding
//   over the tensor (with K0a's 8, chip_smoke.py phase 28 read it 1.6%
//   behind torch.addcmul at 2^24 elements on an H100; with 64, about one
//   trip a thread there, 0.15%).
//
// P5: T steps, each a chain of D dependent products x <- g(x W_d), x
//   [rows, R], W_d [R, 2R], g the gate tanh(z[:R]) * sigmoid(z[R:]) or,
//   without the gate, z[:R] + z[R:]; G independent chains advanced in the
//   same loop body.  Replaces tools/probe_stage.py:65 (make_chain): the
//   per-stage latency floor of the generation kernels, whose step is a
//   chain of 2L+3 such stages (K1) or L+5 (K6).  As there, t is folded into
//   x at each step (x + (t == -1)), so the loop cannot be hoisted.  The
//   exact precision (unit probes.cu) is K1's: its column product (k in
//   order from 0, every product and sum rounded once, step_common.cuh
//   dot_column) and the canonical tanh and sigmoid (exact_math.cuh), so it
//   equals the plain torch version bit for bit.  The fast precision (unit
//   probes.cu@fmad) contracts the products to FMAs and takes tanhf and
//   __expf: the counterpart of the TPU probe's precision=DEFAULT.  Bound:
//   the latency of the dependent chain, far above its operations.  Four
//   layouts (tools/probe_stage.py WEIGHTS):
//
//   * stage_chain_kernel<kGate, kSmemW> ("l2", "smem"), the first design:
//     `rows` batch rows per CTA, 256 threads, one output column per thread
//     and task, x and z in shared memory, two __syncthreads a stage; W_d
//     read from global memory (L2) inside the chain, or from a copy staged
//     into shared memory once per launch with plain loads (D R 2R 4 bytes,
//     so D <= 6 at R=64).
//   * stage_stream_kernel ("stream"), W staged by TMA, K1's layout.  One CTA
//     per `rows` rows.  The wrapper lays W out as k-quads [D][R/4][2R][4]
//     (tools/probe_stage.py quad_weights), so a stage is one contiguous
//     8 R^2 bytes; lane 0 of a producer warp copies stage after stage with
//     cp.async.bulk through an mbarrier ring of `slots` slots
//     (staged_common.cuh), on across steps, while the consumer warps work.
//     A worker thread owns the column pair (i, R+i) of NP rows (K1's
//     ownership): one 16-byte load brings four k-terms of a column, the NP
//     rows' sums run side by side, and the gate is done where the sums are,
//     so z never goes through shared memory.  Each worker writes its x
//     entries into the other of two x buffers; one named barrier among the
//     consumers a stage.  Any D runs.
//   * stage_cluster_kernel ("cluster"), W resident across a thread-block
//     cluster, the cluster K6's layout (fused_chain.cu).  A cluster of
//     kClusterCTAs = 8 CTAs (the portable size) per group of `rows` rows;
//     CTA c holds for the whole launch the column pairs (i, R+i), i in
//     [c R/8, (c+1) R/8), of every W_d (quad_weights with 8 slices: D R 2R
//     4 / 8 bytes, 176,128 at the flagship's D=43), copied once by TMA.
//     Each stage: the CTA's pairs for its rows, the gate, its slice of the
//     new x sent into every CTA's shared memory by st.async (mapa +
//     st.async.shared::cluster), each store completing on an mbarrier of
//     the receiving CTA, one a buffer, which expects the stage's nr R 4
//     bytes.  A CTA waits only for its next x: no cluster barrier a stage
//     (with one, the stage read 1.7x slower on an H100; PERF.md).  Two x
//     buffers suffice: a CTA can send stage d+1's x only once it holds
//     every slice of stage d's, and each worker sends its slice after its
//     reads.
//
// P6 barrier_probe_kernel<kForm, kPoller>: K grid barriers with no work
//   between them, over a cooperative grid of one CTA an SM in clusters, so
//   that a barrier's own cost shows apart from the skew between CTAs that
//   K1 card-wide's stamps count in its waits.  Timed by
//   tools/barrier_probe.py.  The forms: K1 card-wide's barrier
//   (grid_barrier.cuh: every CTA adds its arrival to one count and polls
//   it), and in two levels (a cluster's CTAs gather on their leader's
//   mbarrier, one global arrival and one global poller a cluster).  kPoller
//   adds a second waiting thread a CTA, in a warp of its own, that waits for
//   every barrier as K1 card-wide's prev warps do: on the count (flat) or on
//   a word of its CTA's shared memory (two levels).

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"
#include "grid_barrier.cuh"
#include "staged_common.cuh"
#include "step_common.cuh"

#ifndef NVW_FMAD
#define NVW_FMAD 0
#endif
#if NVW_FMAD
#define NVW_FMA_PROBE nvw_fma_probe_fmad
#define NVW_STAGE_CHAIN nvw_stage_chain_fast
#define NVW_STAGE_STREAM nvw_stage_stream_fast
#define NVW_STAGE_CLUSTER nvw_stage_cluster_fast
#define NVW_STAGE_CLUSTER_FIT nvw_stage_cluster_fit_fast
#define NVW_BARRIER_PROBE nvw_barrier_probe_fast
#define NVW_BARRIER_PROBE_FIT nvw_barrier_probe_fit_fast
#else
#define NVW_FMA_PROBE nvw_fma_probe
#define NVW_STAGE_CHAIN nvw_stage_chain
#define NVW_STAGE_STREAM nvw_stage_stream
#define NVW_STAGE_CLUSTER nvw_stage_cluster
#define NVW_STAGE_CLUSTER_FIT nvw_stage_cluster_fit
#define NVW_BARRIER_PROBE nvw_barrier_probe
#define NVW_BARRIER_PROBE_FIT nvw_barrier_probe_fit
#endif

extern __shared__ __align__(128) unsigned char p5_smem[];

namespace {

constexpr int kThreads = 256;
constexpr bool kFast = NVW_FMAD != 0;
constexpr int kP1BlocksPerSM = 64;  // the grid's cap: 8 resident an SM, the rest in waves
constexpr int kMaxWorkers = 256;    // P5 threads that own column pairs
constexpr int kCopyBytes = 32768;   // the cluster layout's bulk copies
constexpr int kClusterCTAs = 8;     // the cluster layout's CTAs a cluster

// ---- P1 ---------------------------------------------------------------------

template <bool kGuarded>
__device__ __forceinline__ float fma_form(float a, float b, float c) {
  if constexpr (kGuarded) {
    return __fadd_rn(__fmul_rn(a, b), c);
  } else {
    return a * b + c;
  }
}

template <bool kGuarded>
__device__ __forceinline__ float4 fma_form4(const float4 a, const float4 b, const float4 c) {
  return make_float4(fma_form<kGuarded>(a.x, b.x, c.x), fma_form<kGuarded>(a.y, b.y, c.y),
                     fma_form<kGuarded>(a.z, b.z, c.z), fma_form<kGuarded>(a.w, b.w, c.w));
}

// o = a*b + c over n elements: n4 float4s (16-byte aligned pointers, or
// n4 = 0), then the elements [4 n4, n) one at a time
template <bool kGuarded>
__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ o, long long n, long long n4) {
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  float4* o4 = reinterpret_cast<float4*>(o);
  long long i = first;
  // two float4s in flight a thread
  for (; i + stride < n4; i += 2 * stride) {
    const float4 a0 = a4[i], b0 = b4[i], c0 = c4[i];
    const float4 a1 = a4[i + stride], b1 = b4[i + stride], c1 = c4[i + stride];
    o4[i] = fma_form4<kGuarded>(a0, b0, c0);
    o4[i + stride] = fma_form4<kGuarded>(a1, b1, c1);
  }
  if (i < n4) o4[i] = fma_form4<kGuarded>(a4[i], b4[i], c4[i]);
  for (long long k = 4 * n4 + first; k < n; k += stride) o[k] = fma_form<kGuarded>(a[k], b[k], c[k]);
}

// ---- P5: the first design ("l2", "smem") -------------------------------------

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

// ---- P5 for Hopper: "stream" and "cluster" ----------------------------------

struct ChainArgs {
  const float* w;   // quad_weights: [ways or 1][D][R/4][2R/C][4]
  const float* x_in;  // [G, B, R]
  float* x_out;       // [G, B, R]
  int B, R, D, T, G;
  int rows;   // batch rows a CTA (stream) or a cluster
  int np;     // rows a worker owns (1, 2 or 4)
  int ways;   // stream: the ring's slots; cluster: CTAs a cluster (kClusterCTAs)
};

// a stage's output: the gate (or the plain sum), and at a step's last stage
// the next step's fold of t
template <bool kGate>
__device__ __forceinline__ float stage_value(float zt, float zs, bool fold_next, int t) {
  const float v = kGate ? gate(zt, zs) : zt + zs;
  return fold_next ? v + (float)(t + 1 == -1) : v;
}

// The column pair (j, half + j) of a stage for NP rows: zt[m] = x_m . w[:, j]
// and zs[m] = x_m . w[:, half + j], k in order from 0, one rounded product
// and one rounded sum a term (an FMA in the @fmad unit): dot_column's sums.
// w: the stage's columns as k-quads [R/4][2 half][4]; x_m = x + m xstride.
template <int NP, int kR>
__device__ __forceinline__ void pair_products(const float* x, int xstride, const float* w,
                                              int half, int j, int Rr, float (&zt)[NP],
                                              float (&zs)[NP]) {
  const int R = kR ? kR : Rr;
  const float4* wt = reinterpret_cast<const float4*>(w) + j;
  const float4* ws = wt + half;
  const int ncol = 2 * half;
#pragma unroll
  for (int m = 0; m < NP; ++m) zt[m] = zs[m] = 0.0f;
  auto quad = [&](int kq) {
    const float4 a = wt[kq * ncol], b = ws[kq * ncol];
#pragma unroll
    for (int m = 0; m < NP; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(x + m * xstride + 4 * kq);
      zt[m] = zt[m] + v.x * a.x;
      zs[m] = zs[m] + v.x * b.x;
      zt[m] = zt[m] + v.y * a.y;
      zs[m] = zs[m] + v.y * b.y;
      zt[m] = zt[m] + v.z * a.z;
      zs[m] = zs[m] + v.z * b.z;
      zt[m] = zt[m] + v.w * a.w;
      zs[m] = zs[m] + v.w * b.w;
    }
  };
  if constexpr (kR != 0) {
#pragma unroll
    for (int kq = 0; kq < kR / 4; ++kq) quad(kq);
  } else {
#pragma unroll 4
    for (int kq = 0; kq < R / 4; ++kq) quad(kq);
  }
}

// rows r of a CTA (r = g rows + b: group g, batch row row0 + b) in x [G, B, R]
__device__ __forceinline__ size_t row_offset(const ChainArgs& a, int row0, int r) {
  return ((size_t)(r / a.rows) * a.B + row0 + r % a.rows) * a.R;
}

// x_in's rows of the CTA into xb [nr][R], with the first step's fold of t
__device__ __forceinline__ void load_rows(float* xb, const ChainArgs& a, int row0, int nr) {
  for (int e = threadIdx.x; e < nr * a.R; e += blockDim.x) {
    const float v = a.x_in[row_offset(a, row0, e / a.R) + e % a.R];
    xb[e] = a.T > 0 ? v + (float)(0 == -1) : v;
  }
}

// shared memory of each layout, and the threads of a block: one helper for
// the launch and its check
__host__ __device__ __forceinline__ int workers_of(const ChainArgs& a, bool cluster) {
  return a.G * a.rows / a.np * (cluster ? a.R / kClusterCTAs : a.R);
}

__host__ __device__ __forceinline__ long long smem_of(const ChainArgs& a, bool cluster) {
  const long long x = 2ll * a.G * a.rows * a.R * 4;
  if (cluster) return (long long)a.D * a.R * 2 * a.R * 4 / kClusterCTAs + x + 32;
  return (long long)a.ways * (8ll * a.R * a.R + 16) + x;
}

template <bool kGate, int NP, int kR>
__global__ void __launch_bounds__(kMaxWorkers + 32, 1) stage_stream_kernel(const ChainArgs a) {
  const int R = kR ? kR : a.R, S = a.ways, nr = a.G * a.rows;
  const int workers = workers_of(a, false), nc = (workers + 31) & ~31;
  const int stage = 2 * R * R;   // floats of W_d
  float* ring = reinterpret_cast<float*>(p5_smem);   // [S][stage]
  float* xb = ring + (size_t)S * stage;                // [2][nr][R]
  uint64_t* full = reinterpret_cast<uint64_t*>(xb + 2 * nr * R);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, row0 = blockIdx.x * a.rows;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, nc / 32);
    }
    bar_init_fence();
  }
  load_rows(xb, a, row0, nr);
  __syncthreads();
  if (tid >= nc) {
    // the producer warp: lane 0 copies stage after stage, up to S ahead
    if (tid == nc) {
      const long long stages = (long long)a.T * a.D;
      int slot = 0;
      uint32_t phase = 0;
      for (long long s = 0; s < stages; ++s) {
        if (s >= S) bar_wait(empty + slot, phase ^ 1u);   // stage s - S read
        bar_expect(full + slot, stage * 4);
        bulk_copy(ring + (size_t)slot * stage, a.w + (size_t)(s % a.D) * stage, stage * 4,
                  full + slot);
        if (++slot == S) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  const bool worker = tid < workers;
  const int j = tid % R, r0 = tid / R, rstride = workers / R;   // rows r0 + m rstride
  int slot = 0, cur = 0;
  uint32_t phase = 0;
  for (int t = 0; t < a.T; ++t) {
    for (int d = 0; d < a.D; ++d) {
      bar_wait(full + slot, phase);
      if (worker) {
        float zt[NP], zs[NP];
        pair_products<NP, kR>(xb + ((size_t)cur * nr + r0) * R, rstride * R,
                              ring + (size_t)slot * stage, R, j, R, zt, zs);
        float* xo = xb + (size_t)(cur ^ 1) * nr * R;
        const bool fold = d == a.D - 1 && t + 1 < a.T;
#pragma unroll
        for (int m = 0; m < NP; ++m)
          xo[(r0 + m * rstride) * R + j] = stage_value<kGate>(zt[m], zs[m], fold, t);
      }
      __syncwarp();
      if ((tid & 31) == 0) bar_arrive(empty + slot);   // the warp is done with the slot
      if (++slot == S) {
        slot = 0;
        phase ^= 1u;
      }
      named_sync(kChainBar, nc);
      cur ^= 1;
    }
  }
  for (int e = tid; e < nr * R; e += nc)
    a.x_out[row_offset(a, row0, e / R) + e % R] = xb[(size_t)cur * nr * R + e];
}

// ---- the cluster (sm_90 PTX, as fused_chain.cu) --------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  return addr;
}

// v into the element at `p` of CTA `rank`, by an st.async completing 4
// bytes on that CTA's mbarrier at `bar`
__device__ __forceinline__ void send(const float* p, int rank, float v, uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   map_rank(p, rank)),
               "f"(v), "r"(map_rank(bar, rank))
               : "memory");
}

template <bool kGate, int NP, int kR>
__global__ void __launch_bounds__(kMaxWorkers, 1) stage_cluster_kernel(const ChainArgs a) {
  const int R = kR ? kR : a.R, h = R / kClusterCTAs, nr = a.G * a.rows;
  const int rank = cluster_rank();
  const int workers = workers_of(a, true);
  const int wstage = 2 * h * R;                    // floats of a W_d slice
  float* ws = reinterpret_cast<float*>(p5_smem);   // [D][R/4][2h][4]
  float* xb = ws + (size_t)a.D * wstage;           // [2][nr][R]
  uint64_t* wbar = reinterpret_cast<uint64_t*>(xb + 2 * nr * R);
  uint64_t* xbar = wbar + 1;                       // [2]: x buffer b landed
  const int tid = threadIdx.x, row0 = (blockIdx.x / kClusterCTAs) * a.rows;
  if (tid == 0) {
    bar_init(wbar, 1);
    bar_init(xbar, 1);
    bar_init(xbar + 1, 1);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // this CTA's slices, once, by TMA
    const uint32_t bytes = (uint32_t)a.D * wstage * 4;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.w + (size_t)rank * a.D * wstage);
    bar_expect(wbar, bytes);
    for (uint32_t off = 0; off < bytes; off += kCopyBytes)
      bulk_copy(reinterpret_cast<unsigned char*>(ws) + off, src + off,
                bytes - off < kCopyBytes ? bytes - off : kCopyBytes, wbar);
  }
  load_rows(xb, a, row0, nr);
  cluster_sync();   // every CTA runs and holds x before any store into its shared memory
  bar_wait(wbar, 0);
  const bool worker = tid < workers;
  const int j = tid % h, r0 = tid / h, rstride = workers / h, col = rank * h + j;
  int cur = 0;
  uint32_t parity = 0;   // bit b: the phase of xbar[b] awaited next
  for (int t = 0; t < a.T; ++t) {
    for (int d = 0; d < a.D; ++d) {
      const int nb = cur ^ 1;
      // the stage's x from every CTA (its last use was awaited a stage ago)
      if (tid == 0) bar_expect(xbar + nb, nr * R * 4);
      if (worker) {
        float zt[NP], zs[NP];
        pair_products<NP, kR>(xb + ((size_t)cur * nr + r0) * R, rstride * R,
                              ws + (size_t)d * wstage, h, j, R, zt, zs);
        const float* xo = xb + (size_t)nb * nr * R;
        const bool fold = d == a.D - 1 && t + 1 < a.T;
#pragma unroll
        for (int m = 0; m < NP; ++m) {
          const float v = stage_value<kGate>(zt[m], zs[m], fold, t);
          for (int q = 0; q < kClusterCTAs; ++q)
            send(xo + (r0 + m * rstride) * R + col, q, v, xbar + nb);
        }
      }
      bar_wait(xbar + nb, (parity >> nb) & 1u);
      parity ^= 1u << nb;
      cur = nb;
    }
  }
  cluster_sync();   // no CTA leaves while others may still send
  // this CTA's slice of every row
  for (int e = tid; e < nr * h; e += blockDim.x) {
    const int r = e / h, c = rank * h + e % h;
    a.x_out[row_offset(a, row0, r) + c] = xb[((size_t)cur * nr + r) * R + c];
  }
}

// the plan's numbers (tools/probe_stage.py stream_plan / cluster_plan)
// checked against the kernels' own rules
int check(const ChainArgs& a, bool cluster, int smem_bytes) {
  const int nr = a.G * a.rows;
  if (a.R < 4 || a.R % 4 || a.D < 1 || a.T < 0 || a.rows < 1 || a.B % a.rows ||
      (a.np != 1 && a.np != 2 && a.np != 4) || nr % a.np || (size_t)a.w % 16)
    return (int)cudaErrorInvalidValue;
  if (cluster ? a.ways != kClusterCTAs || a.R % kClusterCTAs : a.ways < 2)
    return (int)cudaErrorInvalidValue;
  const int workers = workers_of(a, cluster);
  if (workers < 1 || workers > kMaxWorkers || smem_of(a, cluster) != smem_bytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// launch the instance, or (max_clusters non-null, cluster layout) write how
// many of its clusters the card holds at once
template <bool kCluster, bool kGate, int NP, int kR>
int launch_p5(const ChainArgs& a, int smem_bytes, cudaStream_t stream, int* max_clusters) {
  auto kernel = kCluster ? stage_cluster_kernel<kGate, NP, kR> : stage_stream_kernel<kGate, NP, kR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int workers = workers_of(a, kCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B / a.rows) * (kCluster ? kClusterCTAs : 1));
  cfg.blockDim = dim3(((workers + 31) & ~31) + (kCluster ? 0 : 32));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster ? kClusterCTAs : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kCluster, bool kGate, int NP>
int launch_r(const ChainArgs& a, int smem, cudaStream_t s, int* q) {
  return a.R == 64 ? launch_p5<kCluster, kGate, NP, 64>(a, smem, s, q)
                   : launch_p5<kCluster, kGate, NP, 0>(a, smem, s, q);
}

template <bool kCluster, bool kGate>
int launch_np(const ChainArgs& a, int smem, cudaStream_t s, int* q) {
  switch (a.np) {
    case 1: return launch_r<kCluster, kGate, 1>(a, smem, s, q);
    case 2: return launch_r<kCluster, kGate, 2>(a, smem, s, q);
    default: return launch_r<kCluster, kGate, 4>(a, smem, s, q);
  }
}

template <bool kCluster>
int launch_layout(const ChainArgs& a, int gate, int smem, void* stream, int* q) {
  const int bad = check(a, kCluster, smem);
  if (bad) return bad;
  const cudaStream_t s = (cudaStream_t)stream;
  return gate ? launch_np<kCluster, true>(a, smem, s, q) : launch_np<kCluster, false>(a, smem, s, q);
}

// ---- P6 ---------------------------------------------------------------------

// the threads that sync before each arrival (K1 card-wide's chain at B=16),
// and the dynamic shared memory that leaves one CTA an SM
constexpr int kBarrierThreads = 128;
constexpr int kBarrierSmem = 120 * 1024;
// the forms (tools/barrier_probe.py FORMS): K1 card-wide's barrier
// (grid_barrier.cuh), and the barrier in two levels below
constexpr int kFlat = 0, kTwoLevel = 1;

// The two-level form.  Barrier n: the arriving thread of each CTA arrives
// on the "gather" mbarrier of its cluster's leader (rank 0) through
// distributed shared memory, with release at cluster scope; the leader's
// thread waits for its cluster's arrivals (acquire, cluster scope), adds one
// arrival to the count with release at gpu scope, polls the count with
// acquire loads until it reads n x (the grid's clusters), then writes n
// into the `passed` word of every CTA of its cluster (a release fence at
// cluster scope, then relaxed stores); every other waiting thread polls its
// own CTA's `passed` with acquire loads at cluster scope.  So the count
// takes G / (cluster size) arrivals and pollers a barrier, not G or 2G.
struct TwoLevel {
  uint64_t* gather;       // this CTA's mbarrier; the leader's gathers its cluster's arrivals
  unsigned int* passed;   // this CTA's word: the last barrier the grid passed
  uint32_t gather0;       // the leader's gather in the cluster's shared window
  uint32_t ctas, rank;    // the cluster's CTAs, and this CTA's rank in it
  unsigned int clusters;  // the grid's clusters
};

__device__ __forceinline__ TwoLevel two_level(uint64_t* gather, unsigned int* passed) {
  TwoLevel g;
  g.gather = gather;
  g.passed = passed;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(g.ctas));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(g.rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(g.gather0) : "r"(smem_addr(gather)));
  g.clusters = gridDim.x / g.ctas;
  return g;
}

// until the CTA's word reads n
__device__ __forceinline__ void local_wait(const unsigned int* passed, unsigned int n) {
  const long long start = clock64();
  for (;;) {
    unsigned int v;
    asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];"
                 : "=r"(v)
                 : "r"(smem_addr(passed))
                 : "memory");
    if (v >= n) return;
    if (clock64() - start > kBarrierTrapCycles) __trap();
  }
}

__device__ __forceinline__ void two_level_sync(const TwoLevel& g, unsigned int* count,
                                               unsigned int n) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(g.gather0)
               : "memory");
  if (g.rank != 0) {
    local_wait(g.passed, n);
    return;
  }
  // the cluster's arrivals complete the gather's phase n - 1
  long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(g.gather)), "r"((n - 1u) & 1u)
        : "memory");
    if (done) break;
    if (clock64() - start > kBarrierTrapCycles) __trap();
  }
  grid_arrive(count);
  start = clock64();
  while (grid_count(count) < n * g.clusters) {
    if (clock64() - start > kBarrierTrapCycles) __trap();
  }
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
  for (uint32_t r = 0; r < g.ctas; ++r) {
    uint32_t dst;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(dst)
                 : "r"(smem_addr(g.passed)), "r"(r));
    asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(dst), "r"(n) : "memory");
  }
}

template <int kForm, bool kPoller>
__global__ void __launch_bounds__(kBarrierThreads + 32, 1)
    barrier_probe_kernel(unsigned int* count, int K) {
  __shared__ uint64_t gather;
  __shared__ unsigned int passed;
  const int tid = threadIdx.x;
  const TwoLevel g = two_level(&gather, &passed);
  if (tid == 0) {
    bar_init(&gather, g.ctas);
    passed = 0u;
    bar_init_fence();
  }
  cluster_sync();
  if (tid < kBarrierThreads) {
    for (int n = 1; n <= K; ++n) {
      named_sync(kChainBar, kBarrierThreads);
      if (tid == 0) {
        if (kForm == kTwoLevel) {
          two_level_sync(g, count, (unsigned)n);
        } else {
          grid_arrive(count);
          grid_wait(count, (unsigned)n);
        }
      }
      named_sync(kChainBar, kBarrierThreads);
    }
  } else if (kPoller && tid == kBarrierThreads) {
    for (int n = 1; n <= K; ++n) {
      if (kForm == kFlat) {
        grid_wait(count, (unsigned)n);
      } else {
        local_wait(&passed, (unsigned)n);
      }
    }
  }
  // no CTA leaves while a store to or an arrival on its shared memory may
  // be in flight
  cluster_sync();
}

// launches P6, or with `active` set only asks how many of its clusters the
// card holds at once
template <int kForm, bool kPoller>
int launch_p6(unsigned int* count, int ctas, int cluster, int K, cudaStream_t stream,
              int* active) {
  auto kernel = barrier_probe_kernel<kForm, kPoller>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBarrierSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kBarrierThreads + (kPoller ? 32 : 0));
  cfg.dynamicSmemBytes = kBarrierSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active) {
    *active = held;
    return 0;
  }
  if (held * cluster < ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, count, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// a, b, c, o: [n] fp32; n4: the float4s of the vector loop (n / 4 where
// every pointer is 16-byte aligned, else 0); sms: the device's SM count
int NVW_FMA_PROBE(const float* a, const float* b, const float* c, float* o, long long n,
                  long long n4, int sms, int guarded, void* stream) {
  if (n4 < 0 || 4 * n4 > n || sms < 1 ||
      (n4 && (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)o) & 15)))
    return (int)cudaErrorInvalidValue;
  const long long work = n4 + (n - 4 * n4);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kP1BlocksPerSM) blocks = (long long)sms * kP1BlocksPerSM;
  if (blocks < 1) blocks = 1;
  if (guarded) {
    fma_probe_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, o,
                                                                                     n, n4);
  } else {
    fma_probe_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, o,
                                                                                      n, n4);
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

// wq: quad_weights(w) [D, R/4, 2R, 4]; x [G, B, R] -> out [G, B, R]; the
// plan's rows a worker (np), ring slots and shared memory
int NVW_STAGE_STREAM(const float* wq, const float* x, float* out, int B, int R, int D, int T,
                     int G, int rows, int gate, int np, int slots, int smem_bytes, void* stream) {
  const ChainArgs a{wq, x, out, B, R, D, T, G, rows, np, slots};
  return launch_layout<false>(a, gate, smem_bytes, stream, nullptr);
}

// wq: quad_weights(w, 8) [8, D, R/4, 2R/8, 4]; the rest as
// NVW_STAGE_STREAM, with the CTAs of a cluster (8) in place of the slots
int NVW_STAGE_CLUSTER(const float* wq, const float* x, float* out, int B, int R, int D, int T,
                      int G, int rows, int gate, int np, int ctas, int smem_bytes, void* stream) {
  const ChainArgs a{wq, x, out, B, R, D, T, G, rows, np, ctas};
  return launch_layout<true>(a, gate, smem_bytes, stream, nullptr);
}

// how many clusters of the NVW_STAGE_CLUSTER instance the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out; launches nothing
int NVW_STAGE_CLUSTER_FIT(int B, int R, int D, int G, int rows, int gate, int np, int ctas,
                          int smem_bytes, int* out) {
  const ChainArgs a{nullptr, nullptr, nullptr, B, R, D, 1, G, rows, np, ctas};
  return launch_layout<true>(a, gate, smem_bytes, nullptr, out);
}

// P6: K barriers over `ctas` CTAs (one an SM, all resident) in clusters of
// `cluster`, in form `form` (kFlat, kTwoLevel), with a second
// waiting thread a CTA or not; count: one unsigned int, zeroed on the
// stream before the launch
int NVW_BARRIER_PROBE(unsigned int* count, int ctas, int cluster, int K, int form,
                      int poller, void* stream) {
  if (ctas < 1 || cluster < 1 || cluster > 8 || ctas % cluster || K < 0 || form < 0 ||
      form > kTwoLevel)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == kTwoLevel) {
    return poller ? launch_p6<kTwoLevel, true>(count, ctas, cluster, K, s, nullptr)
                  : launch_p6<kTwoLevel, false>(count, ctas, cluster, K, s, nullptr);
  }
  return poller ? launch_p6<kFlat, true>(count, ctas, cluster, K, s, nullptr)
                : launch_p6<kFlat, false>(count, ctas, cluster, K, s, nullptr);
}

// how many clusters of `cluster` CTAs of P6 (with the second waiting
// thread) the card holds at once, into *active; launches nothing
int NVW_BARRIER_PROBE_FIT(int cluster, int* active) {
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  return launch_p6<kTwoLevel, true>(nullptr, cluster, cluster, 0, nullptr, active);
}

}  // extern "C"
