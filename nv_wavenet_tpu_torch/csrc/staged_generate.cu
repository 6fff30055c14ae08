// K1 and K5 redesigned for Hopper: the generation loop with every weight
// staged into shared memory by TMA, the dilated prev half computed off the
// step's dependent chain, and no tail on the chain's products.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762
// (make_persistent_generator, body _kernel_body :93-431):
//   K1  modes "sample" and "argmax" with the optional last-step dump;
//   K5  ragged=True (:109-118, 252-256, 302-311, 410-416), per-row clocks
//       and lengths, mode "sample" without the dump.
// Each precision (kPrec, step_common.cuh) is a library with its own entry
// points; the kRagged flag and the geometry (kGeo: the widths compiled in,
// or 0 for the generic instance) are the other template arguments.
//
// What it computes is K1's step (csrc/persistent.cu) bit for bit: every
// column sums k = 0, 1, ..., K-1 from 0.0f, one rounded FMUL and one
// rounded FADD per term (-fmad=false, no tensor core); z = (zp + zc) +
// cond_pre; x = (res + b_res) + x; skip = (skip + sk) + b_skip; relu after
// the last layer; the canonical sampler of exact_math.cuh.  Only the
// schedule and the layout differ.
//
// What bounded the old K1 on the H100 (PERF.md §5, 185 us a flagship step,
// 15.7 us + 8.47 us a layer): every weight read from L2 inside the chain,
// one dependent load a term; the FIFO read and the cond row as round trips
// on the chain; the output stack as two 256-term chains of L2 loads; a tail
// of 64 threads on res/skip; four __syncthreads a layer.  The design:
//
//   * Weights staged by TMA.  The wrapper re-lays every stack once per
//     upload into one stream (ops/persistent.py::staged_plan and
//     staged_stream): per layer Wprev, Wcur, rs_w, then out_w and end_w,
//     each as k-quads [ceil(K/4), Np, 4] (Np: the columns rounded up to 4),
//     zero-padded.  A producer warp copies it in chunks of whole quad-rows
//     (cp.async.bulk, 1D TMA, K4's primitives), one lane per slot, through
//     two mbarrier rings of equal slots: the prev ring (Wprev, for the prev warps) and the chain
//     ring (the rest), in the order they are consumed, running on across
//     layers, into the output stack and into the next step.  A consumer
//     thread reads the four k-terms of its column in one 16-byte (fp32) or
//     8-byte (bf16) shared load; neighbouring threads read neighbouring
//     quads (no bank conflicts) while the activation quad is a broadcast.
//   * The prev half off the chain (the TPU kernel's prev_prefetch,
//     persistent.py:606-610).  Prev warps load each layer's FIFO slot
//     x_{t-d} and cond row with cp.async one layer ahead, and compute
//     x_{t-d} Wprev into a buffer of `lookahead` layers, ahead of the
//     chain.  Each CTA owns one row and its own clock, so this holds for K5
//     as well.
//   * The chain per layer: x_t Wcur (thread i owns the column pair (i,
//     R+i), so the gate needs no exchange), z and the gate, the FIFO write,
//     one barrier, res/skip (one column a thread at the flagship), one
//     barrier.  The chain's warps meet on a named barrier (bar.sync 1); the
//     prev warps on another (bar.sync 2); the rings and the prev buffer
//     signal through mbarriers.
//   * The output stack staged as the layers are; the dumps written in the
//     products' epilogues; the sampler's reductions on the chain's warps.
//   * Fixed widths: at the flagship's and config 4's widths (`fixed_widths`)
//     an instance has R, S, A, the thread counts and the plan's chunking
//     compiled in, so every product's columns a thread, quad-row stride and
//     trip count are constants and its quad loop unrolls whole; the plan
//     (ops/persistent.py::staged_plan) picks it, the launch checks the two
//     agree, and every other geometry runs the generic instance.
//   * The low precisions stage bf16 stacks: their weights are bf16 values
//     already (scan_generate.product_view), so the copy is exact and moves
//     half the bytes.  operand/stored/ring_get/ring_put (step_common.cuh)
//     stay the only rounding points.
//
// What bounds it: per row-step the whole stream (3.3 MB at fp32 at the
// flagship widths, 1.7 MB at bf16) moves from L2 into one SM.  On an H100
// one SM ingests ~118 GB/s by bulk copies issued from two or more lanes,
// one lane ~0.35 us a copy whatever its size, and a copy lands ~0.75 us
// after its issue (tools/staged_probe.py); the rings have few, large
// slots (two prev slots holding a layer's Wprev each, three chain slots of
// ~50 KB: 92 copies a flagship step at fp32).  The fixed-width instance
// takes ~50 us a flagship step at fp32 (~2 us a layer, PERF.md §5): mostly
// the chain's own work (each column's dependent adds, the shared loads of
// res/skip's 320 columns, the gate's exact math, two barriers a layer,
// the output stack, the sampler), and at fp32 the ring now and then: the
// chain waits on over half its chunks (3.3 MB a step at ~118 GB/s is
// ~28 us), the bf16 stream (half the bytes) on few.  The card-wide bound
// (operations at the fp32 rate over all SMs) is far below what one CTA
// per row can reach.  Holding the weights across a thread-block cluster
// (fewer bytes and copies per SM) is the lead.
//
// Compiled with -fmad=false (utils/build.py), one library per precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"
#include "step_common.cuh"

extern __shared__ __align__(128) unsigned char smem[];

namespace {

using namespace nvw;

constexpr int kMaxThreads = 512;  // chain + prev + producer warps
constexpr int kMaxNC = 4;         // columns a thread owns in one product
constexpr int kChainBar = 1;      // named barrier of the chain's warps
constexpr int kPrevBar = 2;       // named barrier of the prev warps
// the stream's matrices
constexpr int kPrev = 0, kCur = 1, kRs = 2, kOut = 3, kEnd = 4;

// Built with -DNVW_TRACE (tools/staged_probe.py trace), block 0 stamps
// clock64 into g_trace: per step (the chain's thread 0), per layer-step
// (thread 0 and the last chain warp; prev thread 0), and the chain's waits
// for its chunks.  The stamps are global stores beside the work and add
// ~25% to a step.  Without the flag they compile to nothing.
#ifdef NVW_TRACE
__device__ long long* g_trace;
#define NVW_TS(i) \
  do { if (blockIdx.x == 0 && tid == 0 && j < 64) g_trace[j * 8 + (i)] = clock64(); } while (0)
#define NVW_TL(i)                                                                         \
  do {                                                                                    \
    if (blockIdx.x == 0 && (tid == 0 || tid == Tc - 32) && g < 1280)                      \
      g_trace[2048 + (tid ? 20480 : 0) + g * 8 + (i)] = clock64();                        \
  } while (0)
#define NVW_TP(i) \
  do { if (blockIdx.x == 0 && tid == Tc && g < 1280) g_trace[45056 + g * 2 + (i)] = clock64(); } while (0)
#define NVW_TW(cycles)                                                                    \
  do {                                                                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                            \
      g_trace[60000] += (cycles);                                                         \
      g_trace[60001] += (cycles) > 300;                                                   \
      g_trace[60002] += 1;                                                                \
    }                                                                                     \
  } while (0)
#else
#define NVW_TS(i) do {} while (0)
#define NVW_TL(i) do {} while (0)
#define NVW_TP(i) do {} while (0)
#endif

struct Mat {
  long long offset;   // bytes from the stream's start (layer 0 for per-layer ones)
  int row_bytes;      // one quad-row: Np * 4 elements
  int rows;           // quad-rows per chunk
  int chunks;
  int kq;             // quad-rows in all, ceil(K / 4)
};

// The widths an instance is compiled for, and the plan's numbers at those
// widths in each precision (ops/persistent.py::staged_plan with a prev
// buffer of 4 layers; tests/test_torch_staged.py holds the two equal):
// R, S, A, the chain's and the prev warps' threads, and the quad-rows a
// chunk of Wprev, Wcur, rs_w, out_w and end_w brings.  In such an instance
// every product's columns a thread, quad-row stride and trip count are
// compile-time constants (K4 ran 1.5x slower without them).  Geometry 0 is
// the generic instance: it takes every number from the plan at run time.
struct Fixed {
  int R, S, A, Tc, Tp;
  int rows[5];
};
constexpr int kGeometries = 3;

__host__ __device__ constexpr Fixed fixed_widths(int geo, int prec) {
  // geometry 1: the flagship's widths (20 layers, R=64, S=256, A=256);
  // geometry 2: config 4's (40 layers, R=128, S=256, A=256)
  return geo == 1 && prec == kPrecExact ? Fixed{64, 256, 256, 320, 128, {16, 16, 10, 12, 12}}
       : geo == 1                       ? Fixed{64, 256, 256, 320, 128, {16, 16, 16, 30, 30}}
       : geo == 2 && prec == kPrecExact ? Fixed{128, 256, 256, 192, 128, {8, 12, 8, 12, 12}}
       : geo == 2                       ? Fixed{128, 256, 256, 192, 128, {16, 24, 16, 24, 24}}
                                        : Fixed{};
}

struct StagedArgs {
  const float* embed;            // [2A, R]
  const unsigned char* stream;   // the relaid stacks (staged_stream)
  const float* rs_b;             // [L, R+S]
  const float* out_b;            // [A]
  const float* end_b;            // [A]
  const float* cond;             // [T, L, B, 2R], dil_b already added
  const float* sel;              // [T, B]
  const int* sched;              // [2, L]: ring_offsets, then dilations
  float* ring;                   // [ring_size, B, R] (bf16 under kPrecBF16)
  int* y_state;                  // [2, B]
  int* y;                        // [T, B]
  float* d_xt;                   // [L, B, R]  } last-step dump, null when off
  float* d_skip;                 // [L, B, S]  }
  float* d_zs;                   // [B, A]     }
  float* d_za;                   // [B, A]     }
  float* d_p;                    // [B, A]     }
  const long long* t0_row;       // [B] K5: each row's clock
  const int* n_valid_row;        // [B] K5: each row's steps
  long long t0;
  int n_valid;
  int B, L, R, S, A, tanh_embed, silence_bin, mode;
  // the plan
  int chain_threads, prev_threads, slot_bytes, chain_slots, prev_slots;
  int lookahead;                 // layers of the prev buffer
  int prev_slot_bytes;           // a prev ring slot (slot_bytes: a chain ring slot)
  int storage;                   // bytes of a stored weight: 4 or 2
  long long layer_bytes;
  int smem_bytes;
  Mat mat[5];
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

// ---- the k-quad products ---------------------------------------------------

// quad q of column `col` of a chunk, as four floats (bf16 widens exactly)
template <int kStore>
__device__ __forceinline__ float4 load_quad(const unsigned char* w, int idx) {
  if constexpr (kStore == 4) {
    return reinterpret_cast<const float4*>(w)[idx];
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(w)[idx];
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

// acc[i] += the four terms of activation quad `a` and the weight quad in
// quad-row `row` of column col[i], in k order
template <int kStore, int NC>
__device__ __forceinline__ void mac_quad(float (&acc)[kMaxNC], const float4 a,
                                         const unsigned char* w, int row,
                                         const int (&col)[kMaxNC]) {
  float4 wq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) wq[i] = load_quad<kStore>(w, row + col[i]);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    acc[i] = acc[i] + a.x * wq[i].x;
    acc[i] = acc[i] + a.y * wq[i].y;
    acc[i] = acc[i] + a.z * wq[i].z;
    acc[i] = acc[i] + a.w * wq[i].w;
  }
}

// acc[i] += act[k] * w_i[k] over the chunk's quads in k order, for the
// thread's NC columns col[i]: nq whole quads, then the first `rem` terms of
// the next (the matrix's last, partial quad).  act is 16-byte aligned at
// the chunk's first k; each quad-row of the chunk holds np quads.
template <int kStore, int NC>
__device__ __forceinline__ void mac_quads(float (&acc)[kMaxNC], const float* act,
                                          const unsigned char* w, const int (&col)[kMaxNC],
                                          int np, int nq, int rem) {
#pragma unroll 4
  for (int q = 0; q < nq; ++q)
    mac_quad<kStore, NC>(acc, reinterpret_cast<const float4*>(act)[q], w, q * np, col);
  if (rem) {
    const float4 a = reinterpret_cast<const float4*>(act)[nq];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float4 wq = load_quad<kStore>(w, nq * np + col[i]);
      acc[i] = acc[i] + a.x * wq.x;
      if (rem > 1) acc[i] = acc[i] + a.y * wq.y;
      if (rem > 2) acc[i] = acc[i] + a.z * wq.z;
    }
  }
}

template <int kStore>
__device__ __forceinline__ void mac_quads_n(float (&acc)[kMaxNC], const float* act,
                                            const unsigned char* w, const int (&col)[kMaxNC],
                                            int nc, int np, int nq, int rem) {
  if (nc == 1) mac_quads<kStore, 1>(acc, act, w, col, np, nq, rem);
  else if (nc == 2) mac_quads<kStore, 2>(acc, act, w, col, np, nq, rem);
  else if (nc == 3) mac_quads<kStore, 3>(acc, act, w, col, np, nq, rem);
  else if (nc == 4) mac_quads<kStore, 4>(acc, act, w, col, np, nq, rem);
}

// mac_quads at fixed widths: NQ whole quads, quad-rows of NP quads, fully
// unrolled, so every load is a constant offset from the thread's column
template <int kStore, int NC, int NP, int NQ>
__device__ __forceinline__ void mac_fixed(float (&acc)[kMaxNC], const float* act,
                                          const unsigned char* w, const int (&col)[kMaxNC]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    mac_quad<kStore, NC>(acc, reinterpret_cast<const float4*>(act)[q], w, q * NP, col);
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

// The product of matrix m over its chunks as they land in ring r: every
// thread of the consuming group walks every chunk (so all keep one
// position), the nc > 0 ones add its terms; each warp then frees the slot.
template <int kStore>
__device__ __forceinline__ void ring_product(Ring& r, const Mat& m, int K, const float* act,
                                             float (&acc)[kMaxNC], const int (&col)[kMaxNC],
                                             int nc, int lane, int slot_bytes) {
  const int np = m.row_bytes / (4 * kStore);
  for (int c = 0; c < m.chunks; ++c) {
    ring_wait(r);
    if (nc > 0) {
      const int q0 = c * m.rows;
      int nq = min(m.rows, m.kq - q0), rem = 0;
      if (q0 + nq == m.kq && (K & 3)) {
        --nq;
        rem = K & 3;
      }
      mac_quads_n<kStore>(acc, act + 4 * q0, r.slots + (size_t)r.slot * slot_bytes, col, nc,
                          np, nq, rem);
    }
    ring_release(r, lane);
  }
}

// One chunk of NQ quad-rows at fixed widths for a thread that owns NC
// columns, NC - STEP, or none
template <int kStore, int NC, int STEP, int NP, int NQ>
__device__ __forceinline__ void fixed_chunk(float (&acc)[kMaxNC], const float* act,
                                            const unsigned char* w, const int (&col)[kMaxNC],
                                            int nc) {
  if (nc == NC) {
    mac_fixed<kStore, NC, NP, NQ>(acc, act, w, col);
  } else if constexpr (NC > STEP) {
    if (nc == NC - STEP) mac_fixed<kStore, NC - STEP, NP, NQ>(acc, act, w, col);
  }
}

// ring_product of stream matrix kM in an instance of fixed widths (kGeo >
// 0): K terms, N columns, chunks of the plan's quad-rows; a thread owns its
// share of the columns (of the R column pairs for Wcur), rounded up or down
template <int kStore, int kGeo, int kPrec, int kM>
__device__ __forceinline__ void fixed_product(Ring& r, const float* act, float (&acc)[kMaxNC],
                                              const int (&col)[kMaxNC], int nc, int lane,
                                              int slot_bytes) {
  constexpr Fixed F = fixed_widths(kGeo, kPrec);
  constexpr int K = kM == kOut ? F.S : kM == kEnd ? F.A : F.R;
  constexpr int N = kM <= kCur ? 2 * F.R : kM == kRs ? F.R + F.S : F.A;
  constexpr int T = kM == kPrev ? F.Tp : F.Tc;
  constexpr int STEP = kM == kCur ? 2 : 1;
  constexpr int NC = STEP * (((kM == kCur ? F.R : N) + T - 1) / T);
  constexpr int ROWS = F.rows[kM], KQ = K / 4, NP = (N + 3) & ~3;
  constexpr int CH = (KQ + ROWS - 1) / ROWS, LAST = KQ - (CH - 1) * ROWS;
  static_assert(K % 4 == 0 && NC <= kMaxNC && ROWS >= 1, "fixed widths the layout cannot take");
  for (int c = 0; c < CH; ++c) {
    ring_wait(r);
    const unsigned char* w = r.slots + (size_t)r.slot * slot_bytes;
    if (c + 1 < CH) {
      fixed_chunk<kStore, NC, STEP, NP, ROWS>(acc, act + 4 * ROWS * c, w, col, nc);
    } else {
      fixed_chunk<kStore, NC, STEP, NP, LAST>(acc, act + 4 * ROWS * c, w, col, nc);
    }
    ring_release(r, lane);
  }
}

// The product of stream matrix kM: at the instance's fixed widths, or
// generic
template <int kStore, int kGeo, int kPrec, int kM>
__device__ __forceinline__ void product(Ring& r, const Mat& m, int K, const float* act,
                                        float (&acc)[kMaxNC], const int (&col)[kMaxNC], int nc,
                                        int lane, int slot_bytes) {
  if constexpr (kGeo == 0) {
    ring_product<kStore>(r, m, K, act, acc, col, nc, lane, slot_bytes);
  } else {
    fixed_product<kStore, kGeo, kPrec, kM>(r, act, acc, col, nc, lane, slot_bytes);
  }
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

// The copy of chunk k of matrix m (per-layer ones at layer l) into `dst`,
// completing on `full`
__device__ __forceinline__ void issue_chunk(const StagedArgs& a, unsigned char* dst,
                                            uint64_t* full, int m, int l, int k) {
  const Mat& mt = a.mat[m];
  const unsigned char* src =
      a.stream + mt.offset + (m <= kRs ? (long long)l * a.layer_bytes : 0ll);
  const uint32_t bytes = (uint32_t)(min(mt.rows, mt.kq - k * mt.rows) * mt.row_bytes);
  bar_expect(full, bytes);
  bulk_copy(dst, src + (size_t)k * mt.rows * mt.row_bytes, bytes, full);
}

__device__ __forceinline__ int ceil4(int n) { return (n + 3) & ~3; }

template <bool kRagged, int kPrec, int kGeo>
__global__ void __launch_bounds__(kMaxThreads, 1)
    staged_generate_kernel(const __grid_constant__ StagedArgs a) {
  constexpr int kStore = kPrec == kPrecExact ? 4 : 2;
  constexpr Fixed F = fixed_widths(kGeo, kPrec);
  constexpr bool kFix = kGeo != 0;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int B = a.B, L = a.L;
  const int R = kFix ? F.R : a.R, S = kFix ? F.S : a.S, A = kFix ? F.A : a.A;
  const int R2 = 2 * R, RS = R + S;
  const int Tc = kFix ? F.Tc : a.chain_threads, Tp = kFix ? F.Tp : a.prev_threads;
  const int NP = a.lookahead;
  const int CS = a.chain_slots, PS = a.prev_slots;

  // shared memory: chain ring, prev ring, barriers, then the activations
  // (ops/persistent.py::staged_plan computes the same layout's size)
  Ring chain{smem, nullptr, nullptr, CS, 0, 0u};
  Ring prev{smem + (size_t)CS * a.slot_bytes, nullptr, nullptr, PS, 0, 0u};
  const size_t ring_bytes = (size_t)CS * a.slot_bytes + (size_t)PS * a.prev_slot_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes);
  chain.full = bars;
  chain.empty = bars + CS;
  prev.full = bars + 2 * CS;
  prev.empty = bars + 2 * CS + PS;
  uint64_t* zfull = bars + 2 * (CS + PS);   // [NP] the prev warps' zp (and cond) ready
  uint64_t* zempty = zfull + NP;            // [NP] the chain done with them
  float* x = reinterpret_cast<float*>(smem + ring_bytes + ((8 * (2 * (CS + PS + NP)) + 15) & ~15));
  float* xop = kPrec == kPrecFast ? x + ceil4(R) : x;   // x as Wcur's operand
  float* h = x + ceil4(R) * (kPrec == kPrecFast ? 2 : 1);
  float* skip = h + ceil4(R);
  float* zs = skip + ceil4(S);
  float* za = zs + ceil4(A);
  float* c0 = za + ceil4(A);
  float* c1 = c0 + ceil4(A);
  float* xpv = c1 + ceil4(A);        // [R] the prev warps' x_{t-d} as an operand
  float* zpb = xpv + ceil4(R);       // [NP][2R] x_{t-d} Wprev
  float* cnb = zpb + NP * ceil4(R2); // [NP][2R] cond rows
  float* xpr = cnb + NP * ceil4(R2); // [NP][R] FIFO slots as stored (ring dtype)

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
    bar_init_fence();
  }
  __syncthreads();

  const long long t0 = kRagged ? a.t0_row[b] : a.t0;
  const int n_valid = kRagged ? a.n_valid_row[b] : a.n_valid;
  const int G = n_valid * L;   // the call's layer-steps, g = j L + l

  if (tid >= Tc + Tp) {
    // ---- the producer warp: lane i < CS owns chain slot i, lane CS + i
    // prev slot i, and copies every chunk of the call that lands in its
    // slot, in the order the slot's consumers take them.  The lanes stay
    // converged and poll: each pass, every lane whose slot's previous use
    // has been released issues its next copy.  (One lane issuing in turn
    // gets ~0.35 us a copy on an H100 whatever its size, tools/
    // staged_probe.py; a lane that blocks in a wait holds up its warp's
    // other lanes.) ----
    const int pl = tid - Tc - Tp;
    const bool is_chain = pl < CS;
    const int mine = is_chain ? pl : pl - CS, stride = is_chain ? CS : PS;
    const int n_cur = a.mat[kCur].chunks, n_rs = a.mat[kRs].chunks;
    const int n_out = a.mat[kOut].chunks, n_prev = a.mat[kPrev].chunks;
    const int per_layer = n_cur + n_rs;
    const int per_step = L * per_layer + n_out + a.mat[kEnd].chunks;
    const long long total = pl >= CS + PS ? 0
                            : is_chain    ? (long long)n_valid * per_step
                                          : (long long)G * n_prev;
    unsigned char* slot = (is_chain ? chain.slots : prev.slots) +
                          (size_t)mine * (is_chain ? a.slot_bytes : a.prev_slot_bytes);
    uint64_t* full = (is_chain ? chain.full : prev.full) + mine;
    uint64_t* empty = (is_chain ? chain.empty : prev.empty) + mine;
    long long c = mine;
    while (__any_sync(0xffffffffu, c < total)) {
      bool issued = false;
      if (c < total && bar_done(empty, (uint32_t)((c / stride) & 1) ^ 1u)) {
        int k, m, l = 0;
        if (is_chain) {
          k = (int)(c % per_step);
          if (k < L * per_layer) {
            l = k / per_layer;
            k %= per_layer;
            m = k < n_cur ? kCur : kRs;
            if (m == kRs) k -= n_cur;
          } else {
            k -= L * per_layer;
            m = k < n_out ? kOut : kEnd;
            if (m == kEnd) k -= n_out;
          }
        } else {
          m = kPrev;
          l = (int)((c / n_prev) % L);
          k = (int)(c % n_prev);
        }
        issue_chunk(a, slot, full, m, l, k);
        c += stride;
        issued = true;
      }
      if (!__any_sync(0xffffffffu, issued)) __nanosleep(32);
    }
    return;
  }

  if (tid >= Tc) {
    // ---- the prev warps: x_{t-d} Wprev and the cond rows, ahead ----------
    const int p = tid - Tc;
    int col[kMaxNC];
    int ncp = 0;
#pragma unroll
    for (int i = 0; i < kMaxNC; ++i) {
      col[i] = p + i * Tp;
      if (col[i] < R2) ncp = i + 1;
    }
    // the FIFO slot and cond row of layer-step g into buffer g % NP, once
    // the chain is done with g - NP (which also wrote every FIFO value g
    // reads: NP <= L)
    auto load = [&](int g) {
      const int s = g % NP, j = g / L, l = g % L;
      bar_wait(zempty + s, ((uint32_t)(g / NP) & 1u) ^ 1u);
      const int off = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      const size_t row = ((size_t)(off + (int)((t0 + j) & (d - 1))) * B + b) * R;
      if constexpr (kPrec == kPrecBF16) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(a.ring) + 2 * row;
        unsigned char* dst = reinterpret_cast<unsigned char*>(xpr + (size_t)s * ceil4(R));
        for (int e = p; e < R / 2; e += Tp) cp_async4(dst + 4 * e, src + 4 * e);
      } else {
        for (int e = p; e < R; e += Tp) cp_async4(xpr + (size_t)s * ceil4(R) + e, a.ring + row + e);
      }
      const float* c = a.cond + (((size_t)j * L + l) * B + b) * R2;
      for (int e = p; e < R2; e += Tp) cp_async4(cnb + (size_t)s * ceil4(R2) + e, c + e);
      cp_async_commit();
    };
    if (G > 0) load(0);
    for (int g = 0; g < G; ++g) {
      const int s = g % NP;
      const bool ahead = NP >= 2 && g + 1 < G;
      if (ahead) {
        load(g + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      named_sync(kPrevBar, Tp);
      for (int e = p; e < R; e += Tp)
        xpv[e] = operand<kPrec>(ring_get<kPrec>(xpr + (size_t)s * ceil4(R), e));
      named_sync(kPrevBar, Tp);
      NVW_TP(0);
      float acc[kMaxNC];
#pragma unroll
      for (int i = 0; i < kMaxNC; ++i) acc[i] = 0.0f;
      product<kStore, kGeo, kPrec, kPrev>(prev, a.mat[kPrev], R, xpv, acc, col, ncp, lane,
                                          a.prev_slot_bytes);
      NVW_TP(1);
#pragma unroll
      for (int i = 0; i < kMaxNC; ++i)
        if (i < ncp) zpb[(size_t)s * ceil4(R2) + col[i]] = acc[i];
      bar_arrive(zfull + s);
      if (!ahead && NP < 2 && g + 1 < G) load(g + 1);
    }
    return;
  }

  // ---- the chain ------------------------------------------------------------
  // Wcur: pair i = tid + k Tc owns columns i and R + i; res/skip and the
  // output stack: column tid + k Tc
  int cur_col[kMaxNC], rs_col[kMaxNC], out_col[kMaxNC];
  int n_cur = 0, n_rs = 0, n_out = 0;
#pragma unroll
  for (int k = 0; k < kMaxNC / 2; ++k) {
    const int i = tid + k * Tc;
    cur_col[2 * k] = i;
    cur_col[2 * k + 1] = R + i;
    if (i < R) n_cur = 2 * k + 2;
  }
#pragma unroll
  for (int k = 0; k < kMaxNC; ++k) {
    const int o = tid + k * Tc;
    rs_col[k] = out_col[k] = o;
    if (o < RS) n_rs = k + 1;
    if (o < A) n_out = k + 1;
  }

  int y_prev = a.y_state[b];
  int y_cur = a.y_state[B + b];
  for (int j = 0; j < n_valid; ++j) {
    NVW_TS(0);
    const long long t = t0 + j;
    const bool dump = !kRagged && a.d_xt != nullptr && j == n_valid - 1;
    // loaded now, used at the step's end
    const float u = __ldg(a.sel + (size_t)j * B + b);
    float ob[kMaxNC], eb[kMaxNC];
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k) {
      ob[k] = k < n_out ? __ldg(a.out_b + out_col[k]) : 0.0f;
      eb[k] = k < n_out ? __ldg(a.end_b + out_col[k]) : 0.0f;
    }

    // embedding: fl(embed_prev[y_prev] + embed_cur[y_cur]), then exact tanh
    for (int i = tid; i < R; i += Tc) {
      const float v = __ldg(a.embed + (size_t)y_prev * R + i) +
                      __ldg(a.embed + (size_t)(A + y_cur) * R + i);
      if constexpr (kPrec == kPrecExact) {
        x[i] = a.tanh_embed ? nvw::em_tanh(v) : v;
      } else {
        const float e = a.tanh_embed ? nvw::em_tanh(v) : v;
        x[i] = stored<kPrec>(e);
        xop[i] = operand<kPrec>(e);
      }
    }
    for (int i = tid; i < S; i += Tc) skip[i] = 0.0f;
    named_sync(kChainBar, Tc);
    NVW_TS(1);

    for (int l = 0; l < L; ++l) {
      const int g = j * L + l, s = g % NP;
      NVW_TL(0);
      float br[kMaxNC];
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k)
        br[k] = k < n_rs ? __ldg(a.rs_b + (size_t)l * RS + rs_col[k]) : 0.0f;

      // x_t Wcur, then z = (zp + zc) + cond_pre, the FIFO write and the gate
      float acc[kMaxNC];
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k) acc[k] = 0.0f;
      product<kStore, kGeo, kPrec, kCur>(chain, a.mat[kCur], R, xop, acc, cur_col, n_cur, lane,
                                         a.slot_bytes);
      NVW_TL(1);
      if (n_cur) {
        bar_wait(zfull + s, (uint32_t)(g / NP) & 1u);
        const float* zp = zpb + (size_t)s * ceil4(R2);
        const float* cn = cnb + (size_t)s * ceil4(R2);
        const int off = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
        const size_t row = ((size_t)(off + (int)(t & (d - 1))) * B + b) * R;
#pragma unroll
        for (int k = 0; k < kMaxNC / 2; ++k) {
          if (2 * k < n_cur) {
            const int i = cur_col[2 * k];
            const float zt = (zp[i] + acc[2 * k]) + cn[i];
            const float zg = (zp[R + i] + acc[2 * k + 1]) + cn[R + i];
            if constexpr (kPrec == kPrecExact) {
              a.ring[row + i] = x[i];
            } else {
              ring_put<kPrec>(a.ring, row + i, x[i]);
            }
            h[i] = operand<kPrec>(nvw::em_tanh(zt) * nvw::em_sigmoid(zg));
          }
        }
      }
      NVW_TL(2);
      named_sync(kChainBar, Tc);
      if (tid == 0) bar_arrive(zempty + s);

      // fused residual + skip: [R | S] output columns; relu after the last
      // layer; the dump in the epilogue
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k) acc[k] = 0.0f;
      product<kStore, kGeo, kPrec, kRs>(chain, a.mat[kRs], R, h, acc, rs_col, n_rs, lane,
                                        a.slot_bytes);
      NVW_TL(3);
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k) {
        if (k < n_rs) {
          const int o = rs_col[k];
          if (o < R) {
            const float v = (acc[k] + br[k]) + x[o];
            x[o] = stored<kPrec>(v);
            if constexpr (kPrec == kPrecFast) xop[o] = operand<kPrec>(v);
            if (dump) a.d_xt[((size_t)l * B + b) * R + o] = x[o];
          } else {
            const float v = (skip[o - R] + acc[k]) + br[k];
            if (l < L - 1) {
              skip[o - R] = v;
              if (dump) a.d_skip[((size_t)l * B + b) * S + o - R] = v;
            } else {
              const float r = fmaxf(v, 0.0f);
              skip[o - R] = operand<kPrec>(r);
              if (dump) a.d_skip[((size_t)l * B + b) * S + o - R] = r;
            }
          }
        }
      }
      NVW_TL(4);
      named_sync(kChainBar, Tc);
    }

    // output stack: zs = relu(skip Wzs + bzs); za = zs Wza + bza
    float acc[kMaxNC];
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k) acc[k] = 0.0f;
    product<kStore, kGeo, kPrec, kOut>(chain, a.mat[kOut], S, skip, acc, out_col, n_out, lane,
                                       a.slot_bytes);
    NVW_TS(2);
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k) {
      if (k < n_out) {
        const int o = out_col[k];
        const float v = fmaxf(acc[k] + ob[k], 0.0f);
        zs[o] = operand<kPrec>(v);
        if (dump) a.d_zs[(size_t)b * A + o] = v;
      }
    }
    named_sync(kChainBar, Tc);
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k) acc[k] = 0.0f;
    product<kStore, kGeo, kPrec, kEnd>(chain, a.mat[kEnd], A, zs, acc, out_col, n_out, lane,
                                       a.slot_bytes);
    NVW_TS(3);
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k)
      if (k < n_out) za[out_col[k]] = acc[k] + eb[k];
    named_sync(kChainBar, Tc);

    int y;
    if (a.mode == kModeArgmax && !dump) {
      y = chain_argmax(za, A, tid, Tc);
    } else {
      // canonical softmax pieces: e = exp(za - max), fixed-tree prefix sum
      float mm = -INFINITY;
      for (int i = tid; i < A; i += Tc) mm = fmaxf(mm, za[i]);
      const float zmax = chain_max(mm, tid, Tc);
      for (int i = tid; i < A; i += Tc) c0[i] = nvw::em_exp(za[i] - zmax);
      named_sync(kChainBar, Tc);
      const float* cum = chain_cumsum(c0, c1, A, tid, Tc);
      if (dump) {
        // p = e / sum: a tolerance-governed output (sampling never divides)
        const float total = cum[A - 1];
        for (int i = tid; i < A; i += Tc) {
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if (a.mode == kModeArgmax) {
        y = chain_argmax(za, A, tid, Tc);
      } else {
        const float thr = u * cum[A - 1];
        int c = 0;
        for (int i = tid; i < A; i += Tc) c += cum[i] <= thr ? 1 : 0;
        c = chain_sum_int(c, tid, Tc);
        y = c < A ? c : a.silence_bin;
      }
    }
    NVW_TS(4);
    y_prev = y_cur;
    y_cur = y;
    if (tid == 0) a.y[(size_t)j * B + b] = y;
  }
  if (tid == 0) {
    a.y_state[b] = y_prev;
    a.y_state[B + b] = y_cur;
  }
}

// the layout's size as the kernel lays it out (the plan's must equal it)
long long smem_layout_bytes(const StagedArgs& a, int prec) {
  auto c4 = [](long long n) { return (n + 3) & ~3ll; };
  const long long floats = c4(a.R) * (prec == kPrecFast ? 2 : 1) + c4(a.R) + c4(a.S) +
                           4 * c4(a.A) + c4(a.R) +
                           (long long)a.lookahead * (2 * c4(2 * a.R) + c4(a.R));
  return (long long)a.chain_slots * a.slot_bytes + (long long)a.prev_slots * a.prev_slot_bytes +
         ((8ll * 2 * (a.chain_slots + a.prev_slots + a.lookahead) + 15) & ~15ll) + 4 * floats;
}

template <bool kRagged, int kPrec, int kGeo>
int launch_instance(const StagedArgs& args, int threads, void* stream) {
  auto kernel = staged_generate_kernel<kRagged, kPrec, kGeo>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<args.B, threads, args.smem_bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

template <bool kRagged, int kPrec>
int launch(StagedArgs& args, const long long* plan, void* stream) {
  // the plan array: ops/persistent.py::StagedPlan.kernel_args
  args.chain_threads = (int)plan[0];
  args.prev_threads = (int)plan[1];
  args.slot_bytes = (int)plan[2];
  args.chain_slots = (int)plan[3];
  args.prev_slots = (int)plan[4];
  args.lookahead = (int)plan[5];
  args.prev_slot_bytes = (int)plan[6];
  args.storage = (int)plan[7];
  args.layer_bytes = plan[8];
  args.smem_bytes = (int)plan[9];
  const int threads = (int)plan[10];
  const long long stream_bytes = plan[11];
  for (int m = 0; m < 5; ++m) {
    const long long* p = plan + 12 + 4 * m;
    args.mat[m] = Mat{p[0], (int)p[1], (int)p[2], 0, (int)p[3]};
    args.mat[m].chunks = (args.mat[m].kq + args.mat[m].rows - 1) / args.mat[m].rows;
  }
  const int store = kPrec == kPrecExact ? 4 : 2;
  const int Tc = args.chain_threads, Tp = args.prev_threads;
  bool ok = args.storage == store && Tc > 0 && Tc % 32 == 0 && Tp > 0 && Tp % 32 == 0 &&
            threads == Tc + Tp + 32 && threads <= kMaxThreads && args.lookahead >= 1 &&
            args.lookahead <= args.L && args.chain_slots >= 2 && args.prev_slots >= 2 &&
            args.chain_slots + args.prev_slots <= 32 && args.slot_bytes % 128 == 0 &&
            args.prev_slot_bytes % 128 == 0 &&
            smem_layout_bytes(args, kPrec) == args.smem_bytes && 2 * Tc >= args.R &&
            Tc * kMaxNC >= args.R + args.S && Tc * kMaxNC >= args.A &&
            Tp * kMaxNC >= 2 * args.R && (kPrec != kPrecBF16 || args.R % 2 == 0);
  for (int m = 0; m < 5 && ok; ++m) {
    // whole 16-byte quad-rows, a chunk within its slot, the matrix (at the
    // last layer if per layer) within the stream
    const Mat& mt = args.mat[m];
    const long long slot = m == kPrev ? args.prev_slot_bytes : args.slot_bytes;
    const long long last = mt.offset + (m <= kRs ? (args.L - 1) * args.layer_bytes : 0);
    ok = mt.row_bytes % 16 == 0 && mt.rows >= 1 && (long long)mt.rows * mt.row_bytes <= slot &&
         mt.offset % 16 == 0 && last + (long long)mt.kq * mt.row_bytes <= stream_bytes;
  }
  // the instance the plan chose: its fixed widths must be the plan's
  const int geo = (int)plan[32];
  ok = ok && geo >= 0 && geo < kGeometries;
  if (ok && geo > 0) {
    const Fixed f = fixed_widths(geo, kPrec);
    ok = f.R == args.R && f.S == args.S && f.A == args.A && f.Tc == Tc && f.Tp == Tp;
    for (int m = 0; m < 5; ++m) ok = ok && f.rows[m] == args.mat[m].rows;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (geo) {
    case 1: return launch_instance<kRagged, kPrec, 1>(args, threads, stream);
    case 2: return launch_instance<kRagged, kPrec, 2>(args, threads, stream);
    default: return launch_instance<kRagged, kPrec, 0>(args, threads, stream);
  }
}

}  // namespace

// K1: sel carries uniforms; mode 0 sample, 1 argmax; the dump pointers are
// all null when off.  `stream` is staged_stream's tensor; `plan` a host
// array of StagedPlan.kernel_args.
#define NVW_STAGED_ENTRY(name, kPrec)                                                         \
  int name(const float* embed, const void* stream_w, const float* rs_b, const float* out_b,   \
           const float* end_b, const float* cond, const float* sel, const int* sched,         \
           float* ring, int* y_state, int* y, float* d_xt, float* d_skip, float* d_zs,        \
           float* d_za, float* d_p, long long t0, int n_valid, int B, int L, int R, int S,    \
           int A, int tanh_embed, int silence_bin, int mode, const long long* plan,           \
           void* stream) {                                                                    \
    StagedArgs args{embed, (const unsigned char*)stream_w, rs_b, out_b, end_b, cond, sel,    \
                    sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, nullptr,         \
                    nullptr, t0, n_valid, B, L, R, S, A, tanh_embed, silence_bin, mode};     \
    return launch<false, kPrec>(args, plan, stream);                                          \
  }

// K5: mode "sample", no dump; t0_row [B] and n_valid_row [B] on the device
#define NVW_STAGED_RAGGED_ENTRY(name, kPrec)                                                  \
  int name(const float* embed, const void* stream_w, const float* rs_b, const float* out_b,   \
           const float* end_b, const float* cond, const float* sel, const int* sched,         \
           float* ring, int* y_state, int* y, const long long* t0_row,                        \
           const int* n_valid_row, int B, int L, int R, int S, int A, int tanh_embed,         \
           int silence_bin, const long long* plan, void* stream) {                            \
    StagedArgs args{embed, (const unsigned char*)stream_w, rs_b, out_b, end_b, cond, sel,    \
                    sched, ring, y_state, y, nullptr, nullptr, nullptr, nullptr, nullptr,    \
                    t0_row, n_valid_row, 0, 0, B, L, R, S, A, tanh_embed, silence_bin,       \
                    kModeSample};                                                             \
    return launch<true, kPrec>(args, plan, stream);                                           \
  }

// This source is built once per precision (utils/build.py: -DNVW_PREC=0
// exact, 1 fast, 2 bf16), each library holding that precision's entry
// points, so the instances compile in parallel.
#ifndef NVW_PREC
#define NVW_PREC 0
#endif

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#ifdef NVW_TRACE
int nvw_set_trace(long long* p) { return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }
#endif

#if NVW_PREC == 0
NVW_STAGED_ENTRY(nvw_staged_generate, kPrecExact)
NVW_STAGED_RAGGED_ENTRY(nvw_staged_generate_ragged, kPrecExact)
#elif NVW_PREC == 1
NVW_STAGED_ENTRY(nvw_staged_generate_fast, kPrecFast)
NVW_STAGED_RAGGED_ENTRY(nvw_staged_generate_ragged_fast, kPrecFast)
#elif NVW_PREC == 2
NVW_STAGED_ENTRY(nvw_staged_generate_bf16, kPrecBF16)
NVW_STAGED_RAGGED_ENTRY(nvw_staged_generate_ragged_bf16, kPrecBF16)
#endif

}  // extern "C"
