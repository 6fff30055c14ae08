// K1 card-wide: lockstep exact generation (modes "sample" and "argmax", no
// dump) for the geometries the staged plan (staged_generate.cu) cannot hold
// and ops/persistent.py::wide_plan can: a wide residual stream whose
// weights do not fit one SM (R = 512: 174.8 MB at 30 layers, 3.5x the
// H100's L2), so that every step has to stream them from HBM.
// ops/persistent.py::generation_route sends a lockstep exact call here
// where staged_plan raises and wide_plan holds.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762
// (make_persistent_generator.generate) in modes "sample" and "argmax",
// for those geometries.  The reference's Persistent layout (SURVEY.md
// §2.1): the whole card works on one step of every row.
//   * A grid of G co-resident CTAs (a cooperative launch, one CTA an SM, in
//     clusters of up to 8), launched once per call.  CTA c owns a slice of
//     every product's output columns for all B rows (`wide_plan`'s bounds,
//     (c * n) / G): the column pairs (i, R + i) of both halves of the
//     dilated product, so the gate is local; the res/skip columns; the
//     output stack's columns.  A chain thread sums one (column, row) task
//     of a product (both halves of a pair in the dilated one), k-quads
//     loaded in batches ahead of their sums.
//   * Every column is summed k = 0, 1, ..., K-1 from 0.0f, one rounded FMUL
//     and FADD a term (-fmad=false), so y, the ring and y_state equal the
//     generic and the staged K1's bit for bit.
//   * Each CTA's slices lie in one contiguous part of the weight stream
//     (`wide_stream`: per layer its Wprev, Wcur and rs_w columns, then
//     out_w's and end_w's, each as k-quads [K/4][columns][4]).  A producer
//     warp streams them by TMA through two rings of shared memory, ahead of
//     the chain, since the weights do not depend on the data: the prev ring
//     (Wprev) and the chain ring (Wcur, rs_w, out_w, end_w).
//   * Prev warps compute x_{t-d} Wprev of their columns off the chain, up
//     to kLookahead layer-steps ahead, as K1's prev warps do, but timed
//     against the chain's grid barriers: on an H100 a barrier takes ~1 us
//     from the last arrival to the first exit over an idle card, and up to
//     ~2.3 us while its SMs' own copies are in flight.  So a layer-step's
//     copy of x_{t-d} waits until the chain has passed the res/skip barrier
//     kLookahead layer-steps back, and its products until the chain has
//     arrived at the gate barrier one back, which they fill while the chain
//     waits there; and the producer issues no slice of the chain ring while
//     the chain waits in a barrier.
//   * The activations pass between CTAs through global memory (L2): the
//     gate h, the residual stream x, relu(skip), zs and za, each [B, width],
//     written by their owners and read back by bulk copies multicast to the
//     CTAs of a cluster (`vector_load`), after a release/acquire barrier
//     over the grid wherever the next product needs a whole vector: after
//     each layer's gate and after its res/skip (2L), after zs and after za.
//     Every CTA then runs the sampler for every row itself, so y needs no
//     further barrier.  The barrier is grid_barrier.cuh's: one count in
//     global memory that every CTA's chain adds its arrival to and polls.
//   * The FIFO ring is K1's [ring_size, B, R]: CTA c writes its pair slice
//     of x_t into layer l's slot once every CTA has read x_{t-d} from it
//     (after layer l's gate barrier).  t0 and n_valid as K1's.
//
// With `stats` set, each CTA adds the clock64 cycles of its chain by part
// of the step (`Stat`: the grid barriers' waits, the launch, the waits for
// weight slices and for the prev warps, each product, each load) into
// stats (ops/persistent.py reads them into the counters gen.wide.*).
//
// Compiled with -fmad=false (utils/build.py), exact precision only.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "exact_math.cuh"
#include "grid_barrier.cuh"
#include "staged_common.cuh"

namespace {

constexpr int kLookahead = 2;     // layer-steps of zp the prev warps run ahead
// the stamps, each CTA's chain's cycles summed over the grid: in the grid
// barriers, over the launch, waiting for a weight slice, waiting for the
// prev warps' zp, in x_t Wcur and the gate, loading h, in res/skip,
// loading the next x, in the embedding, the output stack and the sampler,
// and waiting for a multicast vector to land
enum Stat {
  kStBarrier, kStLaunch, kStWeights, kStPrevWait, kStCur, kStLoadH, kStRs, kStLoadX,
  kStStepEnds, kStVector, kStats
};
constexpr int kWideThreads = 512;   // chain + prev + producer, at most

struct WideArgs {
  const float* embed;            // [2A, R]
  const unsigned char* weights;  // the stream (`wide_stream`)
  const float* rs_b;             // [L, R+S]
  const float* out_b;            // [A]
  const float* end_b;            // [A]
  const float* cond;             // [T, L, B, 2R], dil_b already added
  const float* sel;              // [T, B]
  const int* sched;              // [2, L]: ring_offsets, then dilations
  float* ring;                   // [ring_size, B, R], updated in place
  int* y_state;                  // [2, B] (y_prev, y_cur), updated in place
  int* y;                        // [T, B]
  float* xg;                     // [B, R]  the residual stream between CTAs
  float* hg;                     // [B, R]  the gate
  float* sg;                     // [B, S]  relu(skip)
  float* zsg;                    // [B, A]
  float* zag;                    // [B, A]
  unsigned int* sync;            // the grid barrier's arrivals, zeroed before the launch
  unsigned long long* stats;     // [kStats] cycles (`Stat`); null: no stamps
  long long t0;                  // absolute index of the call's first step
  int n_valid;                   // steps to run (<= T)
  int B, L, R, S, A;
  int tanh_embed;
  int silence_bin;
  int mode;
  int chain_threads, prev_threads;
  int chain_slots, prev_slots;
  int slot_bytes, prev_slot_bytes;
  int xs, ss, as;                // row strides (floats) of x / h / x_{t-d}, skip, zs / za
};

// first column of CTA c's slice of n columns over G CTAs
__device__ __forceinline__ int bound(int n, int G, int c) {
  return (int)(((long long)c * n) / G);
}

// one CTA's bytes of the stream
__device__ __forceinline__ long long cta_bytes(const WideArgs& a, int G, int c) {
  const int np = bound(a.R, G, c + 1) - bound(a.R, G, c);
  const int nq = bound(a.R + a.S, G, c + 1) - bound(a.R + a.S, G, c);
  const int na = bound(a.A, G, c + 1) - bound(a.A, G, c);
  return 4ll * ((long long)a.L * (2ll * a.R * 2 * np + (long long)a.R * nq) +
                (long long)(a.S + a.A) * na);
}

// quads [q0, q1) of column `col` of a slice of `ncols` columns held as
// k-quads [kq][ncols][4], against x, added to acc in the fixed order
// k = 4 q0, 4 q0 + 1, ...; the operands of kBatch quads are loaded before
// their sums, so that one shared-memory latency is paid a batch, not a quad
template <int kBatch>
__device__ __forceinline__ float dot_quads(const float* x, const float4* w, int col, int ncols,
                                           int q0, int q1, float acc) {
  const float4* xv = reinterpret_cast<const float4*>(x) + q0;
  const float4* wc = w + (size_t)q0 * ncols + col;
  int q = q0;
  for (; q + kBatch <= q1; q += kBatch, xv += kBatch, wc += kBatch * ncols) {
    float4 v[kBatch], u[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      v[i] = xv[i];
      u[i] = wc[i * ncols];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      acc = acc + v[i].x * u[i].x;
      acc = acc + v[i].y * u[i].y;
      acc = acc + v[i].z * u[i].z;
      acc = acc + v[i].w * u[i].w;
    }
  }
  for (; q < q1; ++q, ++xv, wc += ncols) {
    const float4 v = *xv, u = *wc;
    acc = acc + v.x * u.x;
    acc = acc + v.y * u.y;
    acc = acc + v.z * u.z;
    acc = acc + v.w * u.w;
  }
  return acc;
}

// both halves of pair u (columns 2u and 2u + 1 of the slice) in one pass
// over quads [q0, q1), added to at and ag, kBatch quads' operands loaded
// before their sums
template <int kBatch>
__device__ __forceinline__ void dot_pair(const float* x, const float4* w, int u, int ncols,
                                         int q0, int q1, float& at, float& ag) {
  const float4* xv = reinterpret_cast<const float4*>(x) + q0;
  const float4* wc = w + (size_t)q0 * ncols + 2 * u;
  float zt = at, zg = ag;
  int q = q0;
  for (; q + kBatch <= q1; q += kBatch, xv += kBatch, wc += kBatch * ncols) {
    float4 v[kBatch], t[kBatch], g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      v[i] = xv[i];
      t[i] = wc[i * ncols];
      g[i] = wc[i * ncols + 1];
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      zt = zt + v[i].x * t[i].x;
      zg = zg + v[i].x * g[i].x;
      zt = zt + v[i].y * t[i].y;
      zg = zg + v[i].y * g[i].y;
      zt = zt + v[i].z * t[i].z;
      zg = zg + v[i].z * g[i].z;
      zt = zt + v[i].w * t[i].w;
      zg = zg + v[i].w * g[i].w;
    }
  }
  for (; q < q1; ++q, ++xv, wc += ncols) {
    const float4 v = *xv, t = wc[0], g = wc[1];
    zt = zt + v.x * t.x;
    zg = zg + v.x * g.x;
    zt = zt + v.y * t.y;
    zg = zg + v.y * g.y;
    zt = zt + v.z * t.z;
    zg = zg + v.z * g.z;
    zt = zt + v.w * t.w;
    zg = zg + v.w * g.w;
  }
  at = zt;
  ag = zg;
}

// the batches of the two products
constexpr int kPairBatch = 4;
constexpr int kColumnBatch = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// rows x cols floats of global `src` (row stride `src_ld`) into shared `dst`
// (row stride `ld`) through L2 (cp.async.cg: every copy in flight at once),
// by `nt` threads, waited for by each; cols a multiple of 4.  The caller
// syncs its threads before reading.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int src_ld,
                                          int rows, int cols, int tid, int nt) {
  const int q = cols >> 2;
  for (int e = tid; e < rows * q; e += nt) {
    const int r = e / q, k = e - r * q;
    cp_async16(dst + (size_t)r * ld + 4 * k, src + (size_t)r * src_ld + 4 * k);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// ---- the vectors between CTAs: TMA multicast within a cluster -----------
// Every CTA needs the whole of x, h, relu(skip), zs and za, [B, width],
// right after a grid barrier.  Read by each CTA, every line of them would
// leave L2 once an SM; instead the CTAs of a cluster share the reads: CTA
// rank k of a cluster of n brings rows k, k + n, ... of the vector by bulk
// copies multicast to every CTA of the cluster, each arming its own
// mbarrier for the whole vector.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// The chain's vector `src` [rows, cols] into `dst` (row stride `ld`) of
// every CTA of the cluster, after a grid barrier (thread 0 issues; no wait)
__device__ __forceinline__ void vector_load(float* dst, int ld, const float* src, int rows,
                                            int cols, uint64_t* vbar, int tid) {
  if (tid != 0) return;
  const uint32_t n = cluster_size(), k = cluster_rank();
  const uint32_t row_bytes = 4u * (uint32_t)cols;
  bar_expect(vbar, row_bytes * (uint32_t)rows);
  // the rows were written by other CTAs' threads (the generic proxy) and
  // are read here by the copies (the async proxy)
  asm volatile("fence.proxy.async.global;" ::: "memory");
  for (int r = (int)k; r < rows; r += (int)n) {
    bulk_copy_multicast(dst + (size_t)r * ld, src + (size_t)r * cols, row_bytes, vbar,
                        (uint16_t)((1u << n) - 1u));
  }
}

// the chain's last `vector_load` landed in this CTA
__device__ __forceinline__ void vector_wait(uint64_t* vbar, uint32_t& parity) {
  bar_wait(vbar, parity);
  parity ^= 1u;
}

// ---- the grid barrier (grid_barrier.cuh) ----------------------------------
// the chain's barrier number n: every chain thread's writes before it are
// seen by every CTA's reads after it.  Thread 0 posts n in the CTA's words
// `at` on arriving and `left` on leaving, by which the prev warps and the
// producer time their work (no ordering rides on them).
__device__ __forceinline__ void chain_barrier(const WideArgs& a, unsigned int n, int tid, int Tc,
                                              unsigned int* at, unsigned int* left) {
  named_sync(kChainBar, Tc);
  if (tid == 0) {
    *(volatile unsigned int*)at = n;
    grid_arrive(a.sync);
    grid_wait(a.sync, n);
    *(volatile unsigned int*)left = n;
  }
  named_sync(kChainBar, Tc);
}

__global__ void __launch_bounds__(kWideThreads, 1)
    wide_generate_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the grid barriers the chain arrived at and left last
  __shared__ unsigned int chain_at, chain_left;
  const int G = gridDim.x, c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int B = a.B, L = a.L, R = a.R, S = a.S, A = a.A, RS = R + S;
  const int Tc = a.chain_threads, Tp = a.prev_threads;
  const int CS = a.chain_slots, PS = a.prev_slots, NP = kLookahead;
  const int xs = a.xs, ss = a.ss, as = a.as;
  const int kqR = R >> 2, kqS = S >> 2, kqA = A >> 2;
  // this CTA's slices: pairs [p0, p0 + np) of R, res/skip columns [q0, q0 +
  // nq) of R + S, output columns [a0, a0 + na) of A (out_w's and end_w's)
  const int p0 = bound(R, G, c), np = bound(R, G, c + 1) - p0;
  const int q0 = bound(RS, G, c), nq = bound(RS, G, c + 1) - q0;
  const int a0 = bound(A, G, c), na = bound(A, G, c + 1) - a0;
  const int pmax = (R + G - 1) / G, qmax = (RS + G - 1) / G;
  long long base = 0;
  for (int k = 0; k < c; ++k) base += cta_bytes(a, G, k);
  const long long prev_bytes = 4ll * R * 2 * np, rs_bytes = 4ll * R * nq;
  const long long layer_bytes = 2 * prev_bytes + rs_bytes;
  const unsigned char* mine = a.weights + base;

  // shared memory (ops/persistent.py::wide_plan computes the same size):
  // chain ring, prev ring, mbarriers, the arena (x | h, or the output
  // stack's vectors), x_{t-d}, zp, the own skip columns, y
  Ring chain{smem, nullptr, nullptr, CS, 0, 0u};
  Ring prev{smem + (size_t)CS * a.slot_bytes, nullptr, nullptr, PS, 0, 0u};
  const size_t ring_bytes = (size_t)CS * a.slot_bytes + (size_t)PS * a.prev_slot_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes);
  chain.full = bars;
  chain.empty = bars + CS;
  prev.full = bars + 2 * CS;
  prev.empty = bars + 2 * CS + PS;
  uint64_t* zfull = bars + 2 * (CS + PS);   // [NP] the prev warps' zp ready
  uint64_t* zempty = zfull + NP;            // [NP] the chain done with it
  uint64_t* vbar = zempty + NP;             // the chain's multicast vector landed
  float* arena = reinterpret_cast<float*>(smem + ring_bytes +
                                          ((8 * (2 * (CS + PS + NP) + 1) + 15) & ~15));
  int arena_floats = 2 * B * xs;
  if (B * ss > arena_floats) arena_floats = B * ss;
  if (3 * B * as > arena_floats) arena_floats = 3 * B * as;
  float* x = arena;                 // [B][xs] x_t of the layer
  float* h = arena + B * xs;        // [B][xs] the layer's gate
  float* xp = arena + arena_floats; // [B][xs] x_{t-d} (the prev warps')
  float* zpb = xp + B * xs;         // [NP][2 pmax][B] x_{t-d} Wprev
  float* skip = zpb + NP * 2 * pmax * B;                  // [qmax][B]
  float* zmax = skip + qmax * B;                          // [B]
  int* yb = reinterpret_cast<int*>(zmax + B);             // [3][B] y_prev, y_cur, y

  if (tid == 0) {
    for (int s = 0; s < CS; ++s) {
      bar_init(chain.full + s, 1);
      bar_init(chain.empty + s, Tc / 32);
    }
    for (int s = 0; s < PS; ++s) {
      bar_init(prev.full + s, 1);
      bar_init(prev.empty + s, Tp / 32);
    }
    for (int s = 0; s < NP; ++s) {
      bar_init(zfull + s, Tp);
      bar_init(zempty + s, 1);
    }
    bar_init(vbar, 1);
    chain_at = 0u;
    chain_left = 0u;
    bar_init_fence();
  }
  // every CTA's barriers initialised before any copy multicast to it
  cluster_sync_all();

  const int n_valid = a.n_valid;
  const unsigned int NB = 2 * L + 2;   // grid barriers a step

  if (tid >= Tc + Tp) {
    // ---- the producer warp: lane i < CS owns chain slot i, lane CS + i
    // prev slot i, and copies every slice of the call that lands in its
    // slot, in the order the slot's consumers take them (staged_generate.cu's
    // producer: the lanes stay converged and poll) ----
    const int pl = tid - Tc - Tp;
    const bool is_chain = pl < CS;
    const int slot_i = is_chain ? pl : pl - CS, stride = is_chain ? CS : PS;
    const int per_step = 2 * L + 2;
    const long long total = pl >= CS + PS ? 0
                            : is_chain    ? (long long)n_valid * per_step
                                          : (long long)n_valid * L;
    unsigned char* slot = (is_chain ? chain.slots : prev.slots) +
                          (size_t)slot_i * (is_chain ? a.slot_bytes : a.prev_slot_bytes);
    uint64_t* full = (is_chain ? chain.full : prev.full) + slot_i;
    uint64_t* empty = (is_chain ? chain.empty : prev.empty) + slot_i;
    long long k = slot_i;
    while (__any_sync(0xffffffffu, k < total)) {
      bool issued = false;
      // the chain ring's slices wait while the chain waits in a barrier
      const bool hold = is_chain && *(volatile unsigned int*)&chain_at >
                                        *(volatile unsigned int*)&chain_left;
      if (k < total && !hold && bar_done(empty, (uint32_t)((k / stride) & 1) ^ 1u)) {
        long long off;
        uint32_t bytes;
        if (is_chain) {
          const int i = (int)(k % per_step);
          if (i < 2 * L) {
            off = (long long)(i >> 1) * layer_bytes + ((i & 1) ? 2 * prev_bytes : prev_bytes);
            bytes = (uint32_t)((i & 1) ? rs_bytes : prev_bytes);
          } else if (i == 2 * L) {
            off = L * layer_bytes;
            bytes = (uint32_t)(4ll * S * na);
          } else {
            off = L * layer_bytes + 4ll * S * na;
            bytes = (uint32_t)(4ll * A * na);
          }
        } else {
          off = (k % L) * layer_bytes;
          bytes = (uint32_t)prev_bytes;
        }
        bar_expect(full, bytes);
        if (bytes) bulk_copy(slot, mine + off, bytes, full);
        k += stride;
        issued = true;
      }
      if (!__any_sync(0xffffffffu, issued)) __nanosleep(32);
    }
  } else if (tid >= Tc) {
    // ---- the prev warps: x_{t-d} Wprev of the CTA's pairs, ahead ---------
    const int p = tid - Tc;
    const int Gs = n_valid * L;
    // grid barrier numbers of layer-step h = j L + l: its gate's, then its
    // res/skip's
    auto gate_of = [&](int h) { return (unsigned)(h / L) * NB + 2 * (h % L) + 1; };
    for (int g = 0; g < Gs; ++g) {
      const int j = g / L, l = g % L, s = g % NP;
      // layer l's slot holds x_{t-d} once step j - 1 passed its res/skip
      // barrier (the slot is written after its gate barrier); the copy also
      // waits for layer-step g - NP's res/skip barrier, so that it lands
      // while the chain sums, not while it waits in a barrier
      unsigned need = j > 0 ? (unsigned)(j - 1) * NB + 2 * l + 2 : 0u;
      if (g >= NP && gate_of(g - NP) + 1 > need) need = gate_of(g - NP) + 1;
      if (p == 0 && need) grid_wait(a.sync, need);
      bar_wait(zempty + s, ((uint32_t)(g / NP) & 1u) ^ 1u);
      named_sync(kPrevBar, Tp);
      const long long t = a.t0 + j;
      const int off = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      load_rows(xp, xs, a.ring + (size_t)(off + (int)(t & (d - 1))) * B * R, R, B, R, p, Tp);
      if (p == 0 && g > 0) {
        // the products once the chain waits in layer-step g - 1's gate
        // barrier
        const long long start = clock64();
        while (*(volatile unsigned int*)&chain_at < gate_of(g - 1)) {
          __nanosleep(32);
          if (clock64() - start > kBarrierTrapCycles) __trap();
        }
      }
      named_sync(kPrevBar, Tp);
      ring_wait(prev);
      const float4* w = reinterpret_cast<const float4*>(prev.slots + (size_t)prev.slot * a.prev_slot_bytes);
      float* zp = zpb + (size_t)s * 2 * pmax * B;
      for (int task = p; task < np * B; task += Tp) {
        const int u = task % np, b = task / np;
        float zt = 0.0f, zg = 0.0f;
        dot_pair<kPairBatch>(xp + (size_t)b * xs, w, u, 2 * np, 0, kqR, zt, zg);
        zp[(2 * u) * B + b] = zt;
        zp[(2 * u + 1) * B + b] = zg;
      }
      ring_release(prev, lane);
      bar_arrive(zfull + s);
    }
  } else {
  // ---- the chain warps ----------------------------------------------------
  long long st[kStats] = {};   // thread 0's stamps (`Stat`)
  const bool stamps = a.stats != nullptr && tid == 0;
  long long mark = clock64();
  // cycles since the last stamp into st[k]
  auto stamp = [&](int k) {
    if (stamps) {
      const long long now = clock64();
      st[k] += now - mark;
      mark = now;
    }
  };
  // the chain thread's task in each product, from the last chain warp down:
  // the prev warps take theirs from the first prev warp up, so that the two
  // products issue from different SM sub-partitions (warp w: w % 4)
  const int rt = Tc - 1 - tid;
  // the chain ring's next slice, thread 0 stamping the wait when on
  auto weights = [&]() {
    ring_wait(chain);
    stamp(kStWeights);
  };
  unsigned int nbar = 0;
  uint32_t vphase = 0;   // vbar's parity
  int* y_prev = yb;
  int* y_cur = yb + B;
  int* y_new = yb + 2 * B;
  for (int b = tid; b < B; b += Tc) {
    y_prev[b] = a.y_state[b];
    y_cur[b] = a.y_state[B + b];
  }
  named_sync(kChainBar, Tc);

  for (int j = 0; j < n_valid; ++j) {
    const long long t = a.t0 + j;
    // the embedding of every row, here in every CTA: no barrier.  Each
    // row's two table rows into x and h, then x = fl(prev + cur) in place
    for (int e = tid; e < B * kqR; e += Tc) {
      const int b = e / kqR, k = e - b * kqR;
      cp_async16(x + (size_t)b * xs + 4 * k, a.embed + (size_t)y_prev[b] * R + 4 * k);
      cp_async16(h + (size_t)b * xs + 4 * k, a.embed + (size_t)(A + y_cur[b]) * R + 4 * k);
    }
    cp_async_commit();
    cp_async_wait<0>();
    for (int e = tid; e < qmax * B; e += Tc) skip[e] = 0.0f;
    named_sync(kChainBar, Tc);
    for (int e = tid; e < B * R; e += Tc) {
      const int b = e / R, i = e - b * R;
      const float v = x[(size_t)b * xs + i] + h[(size_t)b * xs + i];
      x[(size_t)b * xs + i] = a.tanh_embed ? nvw::em_tanh(v) : v;
    }
    named_sync(kChainBar, Tc);
    stamp(kStStepEnds);

    for (int l = 0; l < L; ++l) {
      const int g = j * L + l, s = g % NP;
      // x_t Wcur of the CTA's pairs (x arriving in phases from the last
      // layer's barrier; the embedding is here), then z = (zp + zc) + cond
      // and the gate.  A chain thread has a task of each product at most
      // (`wide_plan`).
      weights();
      bar_wait(zfull + s, (uint32_t)(g / NP) & 1u);
      stamp(kStPrevWait);
      {
        const float4* w = reinterpret_cast<const float4*>(chain.slots + (size_t)chain.slot * a.slot_bytes);
        const float* zp = zpb + (size_t)s * 2 * pmax * B;
        const bool mine = rt < np * B;
        const int u = rt % np, b = rt / np;
        float ct = 0.0f, cg = 0.0f, zt = 0.0f, zg = 0.0f;
        if (mine) {
          const float* cr = a.cond + (((size_t)j * L + l) * B + b) * 2 * R + p0 + u;
          ct = __ldg(cr);
          cg = __ldg(cr + R);
        }
        if (l > 0) {
          vector_wait(vbar, vphase);
          stamp(kStVector);
        }
        if (mine) dot_pair<kPairBatch>(x + (size_t)b * xs, w, u, 2 * np, 0, kqR, zt, zg);
        if (mine) {
          zt = (zp[(2 * u) * B + b] + zt) + ct;
          zg = (zp[(2 * u + 1) * B + b] + zg) + cg;
          __stcg(a.hg + (size_t)b * R + p0 + u, nvw::em_tanh(zt) * nvw::em_sigmoid(zg));
        }
      }
      ring_release(chain, lane);
      named_sync(kChainBar, Tc);
      if (tid == 0) bar_arrive(zempty + s);
      stamp(kStCur);
      // every gate, and every read of x_{t-d}
      chain_barrier(a, ++nbar, tid, Tc, &chain_at, &chain_left);
      stamp(kStBarrier);

      // the gate to every CTA of the cluster, then x_t into layer l's FIFO
      // slot (the CTA's pair slice)
      vector_load(h, xs, a.hg, B, R, vbar, tid);
      {
        const int off = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
        float* slot = a.ring + (size_t)(off + (int)(t & (d - 1))) * B * R;
        for (int e = tid; e < B * np; e += Tc) {
          const int b = e / np, i = p0 + e % np;
          __stcg(slot + (size_t)b * R + i, x[(size_t)b * xs + i]);
        }
      }
      stamp(kStLoadH);

      // the res/skip columns: x = (res + b) + x into xg, skip kept here
      weights();
      {
        const float4* w = reinterpret_cast<const float4*>(chain.slots + (size_t)chain.slot * a.slot_bytes);
        const bool mine = rt < nq * B;
        const int v = rt % nq, b = rt / nq, o = q0 + v;
        const float bo = mine ? __ldg(a.rs_b + (size_t)l * RS + o) : 0.0f;
        float acc = 0.0f;
        vector_wait(vbar, vphase);
        stamp(kStVector);
        if (mine) acc = dot_quads<kColumnBatch>(h + (size_t)b * xs, w, v, nq, 0, kqR, acc);
        if (mine) {
          if (o < R) {
            __stcg(a.xg + (size_t)b * R + o, (acc + bo) + x[(size_t)b * xs + o]);
          } else {
            const float sk = (skip[v * B + b] + acc) + bo;
            if (l == L - 1) {
              __stcg(a.sg + (size_t)b * S + (o - R), fmaxf(sk, 0.0f));
            } else {
              skip[v * B + b] = sk;
            }
          }
        }
      }
      ring_release(chain, lane);
      named_sync(kChainBar, Tc);
      stamp(kStRs);
      // the next layer's x (the last: skip)
      chain_barrier(a, ++nbar, tid, Tc, &chain_at, &chain_left);
      stamp(kStBarrier);
      if (l < L - 1) {
        vector_load(x, xs, a.xg, B, R, vbar, tid);
        stamp(kStLoadX);
      }
    }

    // the output stack: zs = relu(relu(skip) Wzs + bzs), za = zs Wza + bza,
    // each vector arriving in phases
    float* vec = arena;
    const bool mine = rt < na * B;
    const int v = rt % na, b = rt / na, o = a0 + v;
    vector_load(vec, ss, a.sg, B, S, vbar, tid);
    stamp(kStStepEnds);
    weights();
    {
      const float4* w = reinterpret_cast<const float4*>(chain.slots + (size_t)chain.slot * a.slot_bytes);
      const float bo = mine ? __ldg(a.out_b + o) : 0.0f;
      float acc = 0.0f;
      vector_wait(vbar, vphase);
      stamp(kStVector);
      if (mine) acc = dot_quads<kColumnBatch>(vec + (size_t)b * ss, w, v, na, 0, kqS, acc);
      if (mine) __stcg(a.zsg + (size_t)b * A + o, fmaxf(acc + bo, 0.0f));
    }
    ring_release(chain, lane);
    named_sync(kChainBar, Tc);
    stamp(kStStepEnds);
    chain_barrier(a, ++nbar, tid, Tc, &chain_at, &chain_left);
    stamp(kStBarrier);
    vector_load(vec, as, a.zsg, B, A, vbar, tid);
    stamp(kStStepEnds);
    weights();
    {
      const float4* w = reinterpret_cast<const float4*>(chain.slots + (size_t)chain.slot * a.slot_bytes);
      const float bo = mine ? __ldg(a.end_b + o) : 0.0f;
      float acc = 0.0f;
      vector_wait(vbar, vphase);
      stamp(kStVector);
      if (mine) acc = dot_quads<kColumnBatch>(vec + (size_t)b * as, w, v, na, 0, kqA, acc);
      if (mine) __stcg(a.zag + (size_t)b * A + o, acc + bo);
    }
    ring_release(chain, lane);
    named_sync(kChainBar, Tc);
    stamp(kStStepEnds);
    chain_barrier(a, ++nbar, tid, Tc, &chain_at, &chain_left);
    stamp(kStBarrier);

    // the sampler of every row, in every CTA: za, then e = exp(za - max)
    // and its fixed-tree prefix sum row by row (exact_math.cuh's), a warp
    // a row for the reductions
    float* za = arena;
    vector_load(za, as, a.zag, B, A, vbar, tid);
    vector_wait(vbar, vphase);
    stamp(kStVector);
    const int warp = tid >> 5, nw = Tc >> 5;
    if (a.mode == kModeArgmax) {
      for (int b = warp; b < B; b += nw) {
        const float* r = za + (size_t)b * as;
        float best = -INFINITY;
        int bi = 0x7fffffff;
        for (int i = lane; i < A; i += 32) {
          const float v = r[i];
          if (v > best || (v == best && i < bi)) {
            best = v;
            bi = i;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > best || (ov == best && oi < bi)) {
            best = ov;
            bi = oi;
          }
        }
        if (lane == 0) y_new[b] = bi;
      }
    } else {
      for (int b = warp; b < B; b += nw) {
        const float* r = za + (size_t)b * as;
        float m = -INFINITY;
        for (int i = lane; i < A; i += 32) m = fmaxf(m, r[i]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) zmax[b] = m;
      }
      named_sync(kChainBar, Tc);
      float* c0 = za + B * as;
      float* c1 = c0 + B * as;
      for (int e = tid; e < B * A; e += Tc) {
        const int b = e / A, i = e - b * A;
        c0[(size_t)b * as + i] = nvw::em_exp(za[(size_t)b * as + i] - zmax[b]);
      }
      named_sync(kChainBar, Tc);
      for (int k = 1; k < A; k <<= 1) {
        for (int e = tid; e < B * A; e += Tc) {
          const int b = e / A, i = e - b * A;
          const float* src = c0 + (size_t)b * as;
          c1[(size_t)b * as + i] = src[i] + (i >= k ? src[i - k] : 0.0f);
        }
        named_sync(kChainBar, Tc);
        float* tmp = c0;
        c0 = c1;
        c1 = tmp;
      }
      for (int b = warp; b < B; b += nw) {
        const float* cum = c0 + (size_t)b * as;
        const float thr = __ldg(a.sel + (size_t)j * B + b) * cum[A - 1];
        int n = 0;
        for (int i = lane; i < A; i += 32) n += cum[i] <= thr ? 1 : 0;
        for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
        if (lane == 0) y_new[b] = n < A ? n : a.silence_bin;
      }
    }
    named_sync(kChainBar, Tc);
    for (int b = tid; b < B; b += Tc) {
      y_prev[b] = y_cur[b];
      y_cur[b] = y_new[b];
      if (c == 0) a.y[(size_t)j * B + b] = y_new[b];
    }
    named_sync(kChainBar, Tc);
  }
  if (c == 0) {
    for (int b = tid; b < B; b += Tc) {
      a.y_state[b] = y_prev[b];
      a.y_state[B + b] = y_cur[b];
    }
  }
  if (stamps) {
    stamp(kStStepEnds);
    for (int k = 0; k < kStats; ++k) {
      if (k != kStLaunch) st[kStLaunch] += st[k];
    }
    for (int k = 0; k < kStats; ++k) atomicAdd(a.stats + k, (unsigned long long)st[k]);
  }
  }
  // no CTA leaves while a copy multicast by or to it may be in flight
  cluster_sync_all();
}

constexpr int kMaxDevices = 64;

// The cluster of a launch of `ctas` CTAs: the most CTAs, 8 at most, that
// divide the grid and whose clusters the card can hold all at once
// (cudaOccupancyMaxActiveClusters), found once per device and grid
int cluster_of(int ctas, int threads, int smem, cudaStream_t stream, int* out) {
  for (int n = 8; n >= 1; n >>= 1) {
    if (ctas % n) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = n;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&active, wide_generate_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active * n >= ctas) {
      *out = n;
      return 0;
    }
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

// One launch of `plan[0]` CTAs, every one resident at once (plan: ctas,
// chain threads, prev threads, chain slots, prev slots, slot bytes, prev
// slot bytes, xs, ss, as, shared-memory bytes), in clusters
// (`cluster_of`; its size into *cluster), cooperative.  The barrier's count
// is zeroed on the stream first; the shared-memory attribute is set once
// per device (and again only for a larger size).
int launch(WideArgs& args, const long long* plan, void* stream, int* cluster) {
  const int ctas = (int)plan[0], smem = (int)plan[10];
  args.chain_threads = (int)plan[1];
  args.prev_threads = (int)plan[2];
  args.chain_slots = (int)plan[3];
  args.prev_slots = (int)plan[4];
  args.slot_bytes = (int)plan[5];
  args.prev_slot_bytes = (int)plan[6];
  args.xs = (int)plan[7];
  args.ss = (int)plan[8];
  args.as = (int)plan[9];
  const int threads = args.chain_threads + args.prev_threads + 32;
  static std::atomic<int> granted[kMaxDevices];
  static std::atomic<long long> clusters[kMaxDevices];   // (ctas << 32 | smem) << 4 | n
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || granted[dev].load() < smem) {
    err = cudaFuncSetAttribute(wide_generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) granted[dev].store(smem);
  }
  const long long key = ((long long)ctas << 32 | smem) << 4;
  int n = 0;
  if (dev < kMaxDevices && (clusters[dev].load() & ~15ll) == key) {
    n = (int)(clusters[dev].load() & 15);
  } else {
    const int e = cluster_of(ctas, threads, smem, (cudaStream_t)stream, &n);
    if (e) return e;
    if (dev < kMaxDevices) clusters[dev].store(key | n);
  }
  *cluster = n;
  err = cudaMemsetAsync(args.sync, 0, sizeof(unsigned int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, wide_generate_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1 card-wide: sel carries uniforms; mode 0 sample, 1 argmax.  scratch:
// [B, R] x, [B, R] h, [B, S] relu(skip), [B, A] zs, [B, A] za, floats, in
// that order; sync: one unsigned int; stats: kStats unsigned long longs or
// null; plan: `WidePlan.kernel_args`; cluster: the launch's cluster size in
// CTAs, written on the host
int nvw_wide_generate(const float* embed, const unsigned char* weights, const float* rs_b,
                      const float* out_b, const float* end_b, const float* cond, const float* sel,
                      const int* sched, float* ring, int* y_state, int* y, float* scratch,
                      unsigned int* sync, unsigned long long* stats, long long t0, int n_valid,
                      int B, int L, int R, int S, int A, int tanh_embed, int silence_bin,
                      int mode, const long long* plan, void* stream, int* cluster) {
  WideArgs args{};
  args.embed = embed;
  args.weights = weights;
  args.rs_b = rs_b;
  args.out_b = out_b;
  args.end_b = end_b;
  args.cond = cond;
  args.sel = sel;
  args.sched = sched;
  args.ring = ring;
  args.y_state = y_state;
  args.y = y;
  args.xg = scratch;
  args.hg = args.xg + (size_t)B * R;
  args.sg = args.hg + (size_t)B * R;
  args.zsg = args.sg + (size_t)B * S;
  args.zag = args.zsg + (size_t)B * A;
  args.sync = sync;
  args.stats = stats;
  args.t0 = t0;
  args.n_valid = n_valid;
  args.B = B;
  args.L = L;
  args.R = R;
  args.S = S;
  args.A = A;
  args.tanh_embed = tanh_embed;
  args.silence_bin = silence_bin;
  args.mode = mode;
  return launch(args, plan, stream, cluster);
}

}  // extern "C"
