// K6: the collapsed-chain ("fused") generation loop in one launch, the
// decode tier of WaveNetInfer(fuse_chain=True) and priority="latency", and
// the speculative draft, laid out for Hopper across a thread-block cluster.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/fused_chain.py:414
// (make_fused_generator.generate; body _kernel_body :118-253), modes sample
// and argmax (kSelInjected, chosen at run time), forced (p_seq) and prng
// (Philox on the card), each in three precisions (kPrec, step_common.cuh:
// fp32, fast_math, compute_dtype=bfloat16): 9 instances, one entry point
// each.  What it computes (ops/fused_chain.py): the residual stream is
// folded into the weights, so layer l's pre-activation is
//   u_l = ((x_0 Wcur_l + x_{t-d} Wprev_l) + fbias_l) + cond_l
//         + sum_{j<l} h_j G_{j,l},        G_{j,l} = Wres_j Wcur_l,
// the skip sum runs over every gate output, and the residual stream
// x_l = (x_{l-1} + h_{l-1} Wres_{l-1}) + bres_{l-1} feeds the FIFO writes.
// The gate and the sampler are the exact math of exact_math.cuh.  The FIFO
// ring and y_state are K1's (plain [ring_size, B, R] layout, absolute
// clock), so a run hands its state to K1/K5 as it is.
//
// Design (ops/fused_chain.py::cluster_plan sizes it):
//   * A CLUSTER OF kCluster = 8 CTAs PER GROUP OF ROWS (1 or 2 rows).
//     CTA c owns a slice of every product's columns: the column pairs
//     (i, R + i) of u_l for i in [c R/8, (c+1) R/8), so the gate needs no
//     exchange (K1's ownership); R/8 columns of the residual stream; S/8 of
//     skip; A/8 of zs and za.  Every CTA reads the whole FIFO slot of its
//     rows and computes the embedding whole (both are small).
//   * STAGED SLICES.  The host lays each CTA's slice of the folded stacks
//     out as one stream in the order the step consumes it (cluster_stream):
//     [x_{t-d} Wprev_l]_l, [x_0 Wcur_l]_l, then per layer l >= 1 G_{l-1,l}
//     (on the chain) and [G_{l-1,l+1} .. G_{l-1,L-1} | Wskip_{l-1} |
//     Wres_{l-1}] (off it), then Wskip_{L-1}, out_w, end_w.  Only the R
//     real rows of each g_pack / wskip_cat block are in it, so pack_gates
//     changes nothing.  Lane 0 of a warp of its own (it owns no product)
//     copies it by TMA (bulk copies completing on an mbarrier a slot,
//     staged_common.cuh) into a ring of `slots` slots, up to slots - 1
//     copies ahead, across steps; a copy is whole 4-row groups of one
//     matrix.  So one SM takes in 1/8 of the folded bytes a step, and each
//     byte serves the group's rows.  The stream is fp32 in every precision:
//     under kPrecFast / kPrecBF16 its values are bf16 values, and a bf16
//     stream measured slower on an H100 (widening each weight sat on the
//     products' chain; PERF.md).
//   * G OFF THE CHAIN.  As soon as h_j is known (after its exchange), the
//     CTA adds h_j G_{j,m} to every later layer's running sum u_m (m > j +
//     1), h_j Wskip_j to the skip sum and h_j Wres_j to the residual
//     product, between its arrival at the cluster barrier and its wait at
//     the next one.  The chain itself waits, a layer, for h_{l-1} G_{l-1,l}
//     (K = R terms) and the gate.  Every column's sum still runs one fixed
//     order: from 0, j = 0, 1, ..., then k = 0, 1, ..., R-1 within j, one
//     __fmaf_rn a term; u_l = base_l + that sum.  This reassociates the TPU
//     kernel's one product over [h_0 .. h_{l-1}] (K6 is governed by the TV
//     contract and held to its plain version within tolerance, not bit for
//     bit), but no sum depends on timing: no atomics, and a split run
//     equals one call bit for bit.
//   * THE EXCHANGE.  Each CTA stores its slice of h_l (then of skip and zs)
//     into every CTA's shared memory (mapa + st.shared::cluster), and the
//     cluster meets once a layer (barrier.cluster.arrive.release, then
//     wait.acquire after the off-chain work).  za's slices go to the CTA
//     that samples the row: CTA b samples row b of its group, and sends y
//     to every CTA.  A step has L + 4 meetings; the wait for the previous
//     step's y comes after the FIFO reads and x_{t-d} Wprev.
//   * PRODUCTS on CUDA cores, __fmaf_rn in every precision (no TF32): a
//     worker thread owns a tile of 4 adjacent columns of 1 or 2 rows (the
//     fewest rows that give every tile a worker), loads a weight row's 4
//     columns once for all its rows and 4 k-terms of each row's operand at
//     once, from shared memory, and carries its sums across the chunks of
//     a matrix.  Splitting a tile's k range over more threads (partial sums
//     added through shared memory, or by lanes of a warp and a butterfly)
//     measured slower on an H100 (PERF.md).  Under kPrecFast and kPrecBF16
//     both operands are bf16 values, so each product is exact and the FMA
//     rounds as a multiply and an add.
//
// What bounds it (PERF.md): on an H100 one SM takes in ~118 GB/s by bulk
// copies, so the 1/8 slice (1.2 MB fp32, 0.6 MB bf16 a step at the
// flagship) costs ~10 / ~5 us a step; the chain's L cluster meetings and
// its K = R products; the FMAs of the off-chain products, which grow with
// the rows of a group.  The card-wide bound (operations over the fp32 rate,
// the products over the bf16 rate under fast_math) is far below.
//
// Compiled with -fmad=false (utils/build.py) like the other sources, so the
// exact math rounds as its twins; the products use __fmaf_rn explicitly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"
#include "step_common.cuh"
#include "staged_common.cuh"

// The block's dynamic shared memory: the copy ring, its barriers, then the
// step's activations.  The products address it by offsets from this array,
// so the compiler knows every operand load is a shared-memory load.
extern __shared__ __align__(128) unsigned char k6_smem[];

// A build with -DNVW_K6_TRACE (tools/k6_ab.py trace) stamps clock64 on CTA 0's
// thread 0 at the phases of the call's second step; otherwise the stamps
// compile to nothing.
#ifdef NVW_K6_TRACE
__device__ long long nvw_trace_stamps[256];
// cycles in the copy ring during step 1: the issuing lane's issuing, then
// thread 0's waiting for a chunk, its products, the barrier after it
// (stamps 220-223)
#define NVW_K6_T0(c0) long long c0 = clock64()
#define NVW_K6_SPAN(i, c0)                                                  \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == ((i) == 220 ? kWorkers : 0) &&    \
        j_now == 1)                                                         \
      nvw_trace_stamps[i] += clock64() - (c0);                              \
    c0 = clock64();                                                         \
  } while (0)
#define NVW_K6_STAMP(i)                                                    \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && j == 1) nvw_trace_stamps[i] = clock64(); \
  } while (0)
#else
#define NVW_K6_STAMP(i) \
  do {               \
  } while (0)
#define NVW_K6_T0(c0)
#define NVW_K6_SPAN(i, c0) \
  do {                  \
  } while (0)
#endif

namespace {

constexpr int kCluster = 8;   // CTAs of a cluster (portable)
constexpr int kWorkers = 256;  // the threads that own the products' tiles
constexpr int kThreads = kWorkers + 32;  // and one warp whose lane 0 issues the copies
constexpr int kMaxRows = 2;   // rows of a group
constexpr int kHSlots = 3;    // h_l buffers: a CTA reads h_{l-1} while others write h_l

// ---- the cluster (sm_90 PTX) -----------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// v into element `p` of every CTA of the cluster
template <typename T>
__device__ __forceinline__ void broadcast(T* p, T v) {
#pragma unroll
  for (int r = 0; r < kCluster; ++r) st_cluster(map_rank(p, r), v);
}

// ---- the stream -------------------------------------------------------------

struct Widths {
  int L, R, S, A;
  int wu, ws, wr, wa;   // a CTA's columns of u_l, skip, the residual stream (padded to 4), zs/za
};

__host__ __device__ __forceinline__ Widths widths(int L, int R, int S, int A) {
  const int half = R / kCluster;
  return Widths{L, R, S, A, 2 * half, S / kCluster, (half + 3) & ~3, A / kCluster};
}

// Matrix m of a step's stream, [K, W] (ops/fused_chain.py::cluster_matrices):
// 0 Wprev (every layer), 1 Wcur (every layer), 2l G_{l-1,l} and 2l+1
// [G_{l-1,l+1..L-1} | Wskip_{l-1} | Wres_{l-1}] for l = 1..L-1, 2L Wskip_{L-1},
// 2L+1 out_w, 2L+2 end_w
__host__ __device__ __forceinline__ void matrix(const Widths& w, int m, int& K, int& W) {
  K = w.R;
  if (m < 2) {
    W = w.L * w.wu;
  } else if (m < 2 * w.L) {
    W = (m & 1) ? (w.L - 1 - m / 2) * w.wu + w.ws + w.wr : w.wu;
  } else if (m == 2 * w.L) {
    W = w.ws;
  } else {
    K = m == 2 * w.L + 1 ? w.S : w.A;
    W = w.wa;
  }
}

// rows of matrix [K, W] one copy brings: as many whole 4-row groups as fit a slot
__host__ __device__ __forceinline__ int piece_rows(int K, int W, int eb, int slot_bytes) {
  const int r = (slot_bytes / (W * eb)) & ~3;
  return r < K ? r : K;
}

// rows of a tile (1 or 2): the fewest that give every tile a worker
__host__ __device__ __forceinline__ int tile_rows(int nrows, int W) {
  int tr = 1;
  while (tr < nrows && (nrows / tr) * (W / 4) > kWorkers) tr <<= 1;
  return tr;
}


struct ClusterArgs {
  const unsigned char* stream;  // [kCluster][step_bytes]: each CTA's slices, a step
  const float* embed;           // [2A, R]
  const float* bres;            // [L, R]
  const float* fbias;           // [L, 2R]
  const float* skipb;           // [S]
  const float* out_b;           // [A]
  const float* end_b;           // [A]
  const float* cond;            // [T, L, B, 2R]
  const float* sel;             // [T, B] (null in mode prng)
  const int* sched;             // [2, L]: ring_offsets, then dilations
  float* ring;                  // [ring_size, B, R], updated in place (bf16 under kPrecBF16)
  int* y_state;                 // [2, B] (y_prev, y_cur), updated in place
  int* y;                       // [T, B]
  float* p_seq;                 // [T, B, A], forced only
  long long t0;                 // absolute index of the call's first step
  long long step_bytes;         // one CTA's stream
  int n_valid;                  // steps to run (<= T)
  int B, L, R, S, A;
  int rows;                     // rows of a group
  int slot_bytes, slots;        // the ring
  int chunks;                   // copies a step
  int tanh_embed;
  int silence_bin;
  int mode;                     // kModeSample or kModeArgmax (kSelInjected)
  unsigned long long seed;      // the Philox key (prng only)
};

// Rows [k0, k0 + n) of one chunk w [n, W] into the tiles of TR rows x 4
// columns this thread owns: dest[r * ds + c] += op_r[k] w[k - k0, c] in k
// order, one __fmaf_rn a term, starting from 0 when `first`.  Column c's
// operand row is op + (c / obw) * obs (Wprev's columns take their layer's
// x_{t-d}); rows of the operand and of dest are ors and ds floats apart.
// w, op and dest are offsets of floats into k6_smem.
template <int TR>
__device__ __forceinline__ void tile_chunk(int w_off, int n, int W, int k0, bool first,
                                           int op_off, int ors, int obw, int obs, int dest_off,
                                           int ds, int nrows) {
  const float* w = reinterpret_cast<const float*>(k6_smem) + w_off;
  const float* op = reinterpret_cast<const float*>(k6_smem) + op_off;
  float* dest = reinterpret_cast<float*>(k6_smem) + dest_off;
  const int c4n = W / 4, tiles = c4n * (nrows / TR);
  if (threadIdx.x >= kWorkers) return;
  for (int t = threadIdx.x; t < tiles; t += kWorkers) {
    const int rb = (t / c4n) * TR, c4 = (t % c4n) * 4;
    const float* o = op + (c4 / obw) * obs + rb * ors + k0;
    float acc[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 d = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                             : *reinterpret_cast<const float4*>(dest + (rb + r) * ds + c4);
      acc[r][0] = d.x;
      acc[r][1] = d.y;
      acc[r][2] = d.z;
      acc[r][3] = d.w;
    }
    for (int k = 0; k < n; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(w + (size_t)(k + q) * W + c4);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(o + r * ors + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = __fmaf_rn(av[q], wv[q].x, acc[r][0]);
          acc[r][1] = __fmaf_rn(av[q], wv[q].y, acc[r][1]);
          acc[r][2] = __fmaf_rn(av[q], wv[q].z, acc[r][2]);
          acc[r][3] = __fmaf_rn(av[q], wv[q].w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
      *reinterpret_cast<float4*>(dest + (rb + r) * ds + c4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <int kSel, int kPrec>
__global__ void __launch_bounds__(kThreads, 1) cluster_chain_kernel(const ClusterArgs a) {
  using TW = float;
  unsigned char* cs = k6_smem;
  const int tid = threadIdx.x, rank = cluster_rank();
  const int nrows = a.rows, g0 = (int)(blockIdx.x / kCluster) * nrows;
  const int B = a.B, L = a.L, R = a.R, S = a.S, A = a.A;
  const Widths wd = widths(L, R, S, A);
  const int half = R / kCluster, wu = wd.wu, ws = wd.ws, wr = wd.wr, wa = wd.wa;
  const int LW = L * wu, DW = LW + ws + wr, nmat = 2 * L + 3;
  const int P = a.slots;
  unsigned char* slots = cs;                                        // [P][slot_bytes]
  uint64_t* full = (uint64_t*)(cs + (size_t)P * a.slot_bytes);      // [P]
  float* xp = (float*)(cs + (size_t)P * a.slot_bytes + ((8 * P + 15) & ~15));  // [L][rows][R]
  float* x0op = xp + L * nrows * R;          // [rows][R]   x_0 as an operand
  float* pp = x0op + nrows * R;              // [rows][L wu] x_{t-d} Wprev_l, the CTA's columns
  float* pc = pp + nrows * LW;               // [rows][L wu] x_0 Wcur_l, then base_l
  float* D = pc + nrows * LW;                // [rows][DW]   the running sums: u_l's G terms | skip | h Wres
  float* hb = D + nrows * DW;                // [kHSlots][rows][R] h_l as operands
  float* skf = hb + kHSlots * nrows * R;     // [rows][S]    relu(skip) as an operand
  float* zsf = skf + nrows * S;              // [rows][A]    zs as an operand
  float* zacc = zsf + nrows * A;             // [rows][wa]   the output stack's sums
  float* zab = zacc + nrows * wa;            // [A]          za of the row this CTA samples
  float* c0 = zab + A;                       // [A]          prefix-sum ping-pong buffers
  float* c1 = c0 + A;                        // [A]
  float* xs = c1 + A;                        // [rows][wr]   x_l on the CTA's columns, as stored
  int* yv = (int*)(xs + nrows * wr);         // [3][kMaxRows] y_prev, y_cur, the step's y

  if (tid == 0) {
    for (int s = 0; s < P; ++s) bar_init(full + s, 1);
    bar_init_fence();
  }
  if (tid < nrows) {
    yv[tid] = a.y_state[g0 + tid];
    yv[kMaxRows + tid] = a.y_state[B + g0 + tid];
  }
  __syncthreads();
  cluster_arrive();   // every CTA runs before any store into its shared memory
  cluster_wait();
  cluster_arrive();   // the first step's wait for y

  // the copy ring: the last warp's lane 0, which owns no tile, issues
  // copies in the stream's order, up to P - 1 ahead of the chunk being
  // consumed; every thread waits for every chunk
  const unsigned char* src = a.stream + (size_t)rank * a.step_bytes;
  const long long total = (long long)a.n_valid * a.chunks;
  long long issued = 0, g = 0, off = 0;
  int im = 0, ik = 0, islot = 0, slot = 0;
  uint32_t phase = 0;
#ifdef NVW_K6_TRACE
  int j_now = 0;
#endif
  auto acquire = [&]() -> const TW* {
    NVW_K6_T0(c0);
    if (tid == kWorkers) {
      const long long until = min(g + P, total);
      for (; issued < until; ++issued) {
        int K, W;
        matrix(wd, im, K, W);
        const int n = min(piece_rows(K, W, (int)sizeof(TW), a.slot_bytes), K - ik);
        const uint32_t bytes = (uint32_t)(n * W * (int)sizeof(TW));
        bar_expect(full + islot, bytes);
        bulk_copy(slots + (size_t)islot * a.slot_bytes, src + off, bytes, full + islot);
        off += bytes;
        islot = islot + 1 == P ? 0 : islot + 1;
        if ((ik += n) == K) {
          ik = 0;
          if (++im == nmat) {
            im = 0;
            off = 0;
          }
        }
      }
    }
    NVW_K6_SPAN(220, c0);
    bar_wait(full + slot, phase);
    NVW_K6_SPAN(221, c0);
    return (const TW*)(slots + (size_t)slot * a.slot_bytes);
  };
  auto release = [&]() {
    NVW_K6_T0(c0);
    __syncthreads();   // every reader is done with the slot before it is refilled
    NVW_K6_SPAN(223, c0);
    ++g;
    if (++slot == P) {
      slot = 0;
      phase ^= 1u;
    }
  };
  // the next matrix of the stream, [K, W], into dest (see tile_chunk)
  auto consume = [&](int K, int W, const float* op, int ors, int obw, int obs, float* dest,
                     int ds, bool zero) {
    const int pr = piece_rows(K, W, (int)sizeof(TW), a.slot_bytes);
    const int tr = tile_rows(nrows, W);
    for (int k0 = 0; k0 < K; k0 += pr) {
      const int n = min(pr, K - k0);
      const int w_off = (int)(acquire() - reinterpret_cast<const TW*>(k6_smem));
      const int op_off = (int)(op - reinterpret_cast<const float*>(k6_smem));
      const int dest_off = (int)(dest - reinterpret_cast<const float*>(k6_smem));
      const bool first = zero && k0 == 0;
      NVW_K6_T0(c0);
      if (tr == 1) {
        tile_chunk<1>(w_off, n, W, k0, first, op_off, ors, obw, obs, dest_off, ds, nrows);
      } else {
        tile_chunk<2>(w_off, n, W, k0, first, op_off, ors, obw, obs, dest_off, ds, nrows);
      }
      NVW_K6_SPAN(222, c0);
      release();
    }
  };

  for (int j = 0; j < a.n_valid; ++j) {
    const long long t = a.t0 + j;
#ifdef NVW_K6_TRACE
    j_now = j;
#endif
    NVW_K6_STAMP(0);
    // x_l on the CTA's columns into layer l's FIFO slot
    auto ring_write = [&](int l) {
      const int o = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      for (int e = tid; e < nrows * half; e += kThreads) {
        const int b = e / half, rr = e - b * half;
        ring_put<kPrec>(a.ring,
                        ((size_t)(o + (int)(t & (d - 1))) * B + g0 + b) * R + rank * half + rr,
                        xs[b * wr + rr]);
      }
    };

    // all L FIFO reads of the group's rows, before any write of the step
    for (int e = tid; e < L * nrows * R; e += kThreads) {
      const int l = e / (nrows * R), rem = e - l * nrows * R, b = rem / R, i = rem - b * R;
      const int o = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      xp[e] = operand<kPrec>(
          ring_get<kPrec>(a.ring, ((size_t)(o + (int)(t & (d - 1))) * B + g0 + b) * R + i));
    }
    for (int e = tid; e < nrows * DW; e += kThreads) D[e] = 0.0f;
    __syncthreads();
    NVW_K6_STAMP(1);
    consume(R, LW, xp, R, wu, nrows * R, pp, LW, true);   // x_{t-d} Wprev_l, every layer
    NVW_K6_STAMP(2);
    cluster_wait();   // the previous step's y
    NVW_K6_STAMP(3);
    if (j && tid < nrows) {
      yv[tid] = yv[kMaxRows + tid];
      yv[kMaxRows + tid] = yv[2 * kMaxRows + tid];
    }
    __syncthreads();
    // the embedding (exact tanh), whole
    for (int e = tid; e < nrows * R; e += kThreads) {
      const int b = e / R, i = e - b * R;
      const float v = __ldg(a.embed + (size_t)yv[b] * R + i) +
                      __ldg(a.embed + (size_t)(A + yv[kMaxRows + b]) * R + i);
      const float x = a.tanh_embed ? em_tanh(v) : v;
      x0op[e] = operand<kPrec>(x);
      const int rr = i - rank * half;
      if (rr >= 0 && rr < half) xs[b * wr + rr] = stored<kPrec>(x);
    }
    __syncthreads();
    NVW_K6_STAMP(4);
    consume(R, LW, x0op, R, LW, 0, pc, LW, true);   // x_0 Wcur_l, every layer
    NVW_K6_STAMP(5);
    // base_l = ((x_0 Wcur_l + x_{t-d} Wprev_l) + fbias_l) + cond_l
    for (int e = tid; e < nrows * LW; e += kThreads) {
      const int b = e / LW, c = e - b * LW, l = c / wu, cc = c - l * wu;
      const int col = cc < half ? rank * half + cc : R + rank * half + (cc - half);
      pc[e] = ((pc[e] + pp[e]) + __ldg(a.fbias + (size_t)l * 2 * R + col)) +
              __ldg(a.cond + (((size_t)j * L + l) * B + g0 + b) * 2 * R + col);
    }
    __syncthreads();

    // the chain
    for (int l = 0; l < L; ++l) {
      const float* hprev = hb + ((l + kHSlots - 1) % kHSlots) * nrows * R;   // h_{l-1}
      if (l) {
        cluster_wait();   // h_{l-1}, every CTA's slice
        NVW_K6_STAMP(8 + 4 * l);
        if (l == 1) ring_write(0);
        consume(R, wu, hprev, R, wu, 0, D + l * wu, DW, false);   // + h_{l-1} G_{l-1,l}
        NVW_K6_STAMP(9 + 4 * l);
      }
      // the gate on the CTA's column pairs; h_l to every CTA
      float* hl = hb + (l % kHSlots) * nrows * R;
      for (int e = tid; e < nrows * half; e += kThreads) {
        const int b = e / half, ii = e - b * half;
        const float* u = pc + b * LW + l * wu;
        const float* s = D + b * DW + l * wu;
        const float zt = l ? u[ii] + s[ii] : u[ii];
        const float zg = l ? u[half + ii] + s[half + ii] : u[half + ii];
        broadcast(hl + b * R + rank * half + ii, operand<kPrec>(em_tanh(zt) * em_sigmoid(zg)));
      }
      cluster_arrive();
      NVW_K6_STAMP(10 + 4 * l);
      if (l) {
        // off the chain: h_{l-1} into every later layer's sum, the skip sum
        // and the residual product
        const int W = (L - 1 - l) * wu + ws + wr;
        consume(R, W, hprev, R, W, 0, D + (l + 1) * wu, DW, false);
        // x_l = (x_{l-1} + h_{l-1} Wres_{l-1}) + bres_{l-1}; its FIFO write
        const int o = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
        for (int e = tid; e < nrows * half; e += kThreads) {
          const int b = e / half, rr = e - b * half;
          float* res = D + b * DW + LW + ws + rr;
          const float x = stored<kPrec>((xs[b * wr + rr] + *res) +
                                        __ldg(a.bres + (size_t)(l - 1) * R + rank * half + rr));
          xs[b * wr + rr] = x;
          *res = 0.0f;
          ring_put<kPrec>(a.ring,
                          ((size_t)(o + (int)(t & (d - 1))) * B + g0 + b) * R + rank * half + rr,
                          x);
        }
        NVW_K6_STAMP(11 + 4 * l);
      }
    }
    cluster_wait();   // h_{L-1}
    NVW_K6_STAMP(200);
    if (L == 1) ring_write(0);
    consume(R, ws, hb + ((L - 1) % kHSlots) * nrows * R, R, ws, 0, D + LW, DW, false);
    NVW_K6_STAMP(201);

    // skip = relu(. + skipb), zs = relu(skip Wzs + bzs), za = zs Wza + bza
    for (int e = tid; e < nrows * ws; e += kThreads) {
      const int b = e / ws, c = e - b * ws;
      broadcast(skf + b * S + rank * ws + c,
                operand<kPrec>(fmaxf(D[b * DW + LW + c] + __ldg(a.skipb + rank * ws + c), 0.0f)));
    }
    cluster_arrive();
    cluster_wait();
    NVW_K6_STAMP(202);
    consume(S, wa, skf, S, wa, 0, zacc, wa, true);
    NVW_K6_STAMP(203);
    for (int e = tid; e < nrows * wa; e += kThreads) {
      const int b = e / wa, c = e - b * wa;
      broadcast(zsf + b * A + rank * wa + c,
                operand<kPrec>(fmaxf(zacc[e] + __ldg(a.out_b + rank * wa + c), 0.0f)));
    }
    cluster_arrive();
    cluster_wait();
    NVW_K6_STAMP(204);
    consume(A, wa, zsf, A, wa, 0, zacc, wa, true);
    NVW_K6_STAMP(205);
    for (int e = tid; e < nrows * wa; e += kThreads) {
      const int b = e / wa, c = e - b * wa;
      st_cluster(map_rank(zab + rank * wa + c, b), zacc[e] + __ldg(a.end_b + rank * wa + c));
    }
    cluster_arrive();
    cluster_wait();
    NVW_K6_STAMP(206);

    // the sampler: CTA b samples row b of the group and sends y to every CTA
    if (rank < nrows) {
      const int row = g0 + rank;
      int y;
      if (kSel == kSelInjected && a.mode == kModeArgmax) {
        y = block_argmax(zab, A);
      } else {
        // canonical softmax pieces: e = exp(za - max), fixed-tree prefix sum
        float mm = -INFINITY;
        for (int i = tid; i < A; i += kThreads) mm = fmaxf(mm, zab[i]);
        const float zmax = block_max(mm);
        for (int i = tid; i < A; i += kThreads) c0[i] = em_exp(zab[i] - zmax);
        __syncthreads();
        const float* cum = block_fixed_tree_cumsum(c0, c1, A);
        if (kSel == kSelForced) {
          const float total_e = cum[A - 1];
          float* p = a.p_seq + ((size_t)j * B + row) * A;
          for (int i = tid; i < A; i += kThreads) p[i] = em_exp(zab[i] - zmax) / total_e;
          y = (int)__ldg(a.sel + (size_t)j * B + row);
        } else {
          const float sel = kSel == kSelPrng ? philox_uniform(a.seed, t, row)
                                             : __ldg(a.sel + (size_t)j * B + row);
          y = block_select_from_cumsum(cum, sel, A, a.silence_bin);
        }
      }
      if (tid == 0) {
        a.y[(size_t)j * B + row] = y;
        broadcast(yv + 2 * kMaxRows + rank, y);
      }
    }
    NVW_K6_STAMP(207);
    cluster_arrive();
  }
  cluster_wait();   // the last step's y; no CTA leaves while others store into it
  if (rank == 0 && tid < nrows && a.n_valid) {
    a.y_state[g0 + tid] = yv[kMaxRows + tid];
    a.y_state[B + g0 + tid] = yv[2 * kMaxRows + tid];
  }
}

// the plan's numbers checked against the kernel's own rules
int check(const ClusterArgs& a, int eb) {
  if (a.R % 16 || a.S % 32 || a.A % 32 || (a.rows != 1 && a.rows != 2) ||
      a.B % a.rows || a.slots < 2 || a.slot_bytes % 128 || (size_t)a.stream % 16)
    return (int)cudaErrorInvalidValue;
  const Widths wd = widths(a.L, a.R, a.S, a.A);
  long long bytes = 0;
  int chunks = 0;
  for (int m = 0; m < 2 * a.L + 3; ++m) {
    int K, W;
    matrix(wd, m, K, W);
    const int pr = piece_rows(K, W, eb, a.slot_bytes);
    if (pr < 4) return (int)cudaErrorInvalidValue;
    chunks += (K + pr - 1) / pr;
    bytes += (long long)K * W * eb;
  }
  if (chunks != a.chunks || bytes != a.step_bytes) return (int)cudaErrorInvalidValue;
  return 0;
}

template <int kSel, int kPrec>
int launch(const ClusterArgs& args, int smem_bytes, void* stream) {
  const int bad = check(args, 4);
  if (bad) return bad;
  auto kernel = cluster_chain_kernel<kSel, kPrec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((args.B / args.rows) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instance, all with this argument list: the stream of
// ops/fused_chain.py::cluster_stream, the small folded tensors, the inputs
// and state, then the shape and the plan (`ClusterPlan.kernel_args`);
// `ring` is bf16 for _bf16.
#define NVW_FUSED_ENTRY(name, kSel, kPrec)                                                      \
  int name(const unsigned char* wstream, const float* embed, const float* bres,                \
           const float* fbias, const float* skipb, const float* out_b, const float* end_b,     \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,   \
           int* y, float* p_seq, long long t0, long long step_bytes, int n_valid, int B,       \
           int L, int R, int S, int A, int rows, int slot_bytes, int slots, int chunks,        \
           int tanh_embed, int silence_bin, int mode, int smem_bytes, unsigned long long seed, \
           void* stream) {                                                                      \
    const ClusterArgs args{wstream, embed, bres, fbias, skipb, out_b, end_b, cond, sel,       \
                           sched, ring, y_state, y, p_seq, t0, step_bytes, n_valid, B, L, R,  \
                           S, A, rows, slot_bytes, slots, chunks, tanh_embed, silence_bin,    \
                           mode == kModeArgmax ? kModeArgmax : kModeSample, seed};            \
    return launch<kSel, kPrec>(args, smem_bytes, stream);                                       \
  }

// This source is built once per precision (utils/build.py: -DNVW_PREC=0
// exact, 1 fast, 2 bf16), each library holding that precision's entry
// points, so the instances compile in parallel.
#ifndef NVW_PREC
#define NVW_PREC 0
#endif

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#ifdef NVW_K6_TRACE
// the stamps of the last traced launch (256 clock64 values, 0 where unset)
int nvw_trace_read(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, nvw_trace_stamps, sizeof(nvw_trace_stamps));
  if (err != cudaSuccess) return (int)err;
  static const long long zeros[256] = {};
  return (int)cudaMemcpyToSymbol(nvw_trace_stamps, zeros, sizeof(zeros));
}
#endif

// sel: uniforms, mode 0 sample, 1 argmax; forced: sel holds the symbols to
// emit, p_seq [T, B, A] (zeroed by the wrapper); prng: selectors from Philox
// keyed on seed, sel not read
#if NVW_PREC == 0
NVW_FUSED_ENTRY(nvw_fused_generate, kSelInjected, kPrecExact)
NVW_FUSED_ENTRY(nvw_fused_generate_forced, kSelForced, kPrecExact)
NVW_FUSED_ENTRY(nvw_fused_generate_prng, kSelPrng, kPrecExact)
#elif NVW_PREC == 1
NVW_FUSED_ENTRY(nvw_fused_generate_fast, kSelInjected, kPrecFast)
NVW_FUSED_ENTRY(nvw_fused_generate_forced_fast, kSelForced, kPrecFast)
NVW_FUSED_ENTRY(nvw_fused_generate_prng_fast, kSelPrng, kPrecFast)
#elif NVW_PREC == 2
NVW_FUSED_ENTRY(nvw_fused_generate_bf16, kSelInjected, kPrecBF16)
NVW_FUSED_ENTRY(nvw_fused_generate_forced_bf16, kSelForced, kPrecBF16)
NVW_FUSED_ENTRY(nvw_fused_generate_prng_bf16, kSelPrng, kPrecBF16)
#endif

}  // extern "C"
