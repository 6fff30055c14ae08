// The staged step redesigned for Hopper: the generation loop with every
// weight staged into shared memory by TMA, the dilated prev half computed
// off the step's dependent chain, and no tail on the chain's products.  One
// kernel template runs K1, K5, K2, K3 and K4 wherever the staged plan holds.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762
// (make_persistent_generator, body _kernel_body :93-431):
//   K1  modes "sample" and "argmax" with the optional last-step dump;
//   K5  ragged=True (:109-118, 252-256, 302-311, 410-416), per-row clocks
//       and lengths, mode "sample" without the dump;
//   K2  mode "forced" (p_seq every step), K3 mode "prng" (Philox on the
//       card), on K1's own stream;
//   K4  stream_weights=True (:128-199), stream_quant (:105-108, 189-197,
//       434-465, 726-729) and weight_dtype (:723-725), in every mode.
// The template's arguments: kRagged (K5's per-row clocks), kModes (the
// modes the sampler serves: sample and argmax for K1/K5, all four for
// K2/K3/K4), kStorage (the layer stacks' bytes in the stream: fp32, bf16 or
// int8), kPrec (step_common.cuh; each precision is a library with its own
// entry points) and kGeo (the widths compiled in, or 0 for the generic
// instance).  Every difference between the routes is one of them, so no
// instance carries a branch or a load of another's.
//
// What it computes is K1's step bit for bit: every column sums k = 0, 1,
// ..., K-1 from 0.0f, one rounded FMUL and one rounded FADD per term
// (-fmad=false, no tensor core); z = (zp + zc) + cond_pre; x = (res + b_res)
// + x; skip = (skip + sk) + b_skip; relu after the last layer; the canonical
// sampler of exact_math.cuh.  A stored int8 weight enters as
// __fmul_rn((float)q, s), one rounded product with its (layer, column)
// scale, as the first K4 (stream_generate.cu) and
// ops/persistent.py::dequantize_stream_params compute it; bf16 widens to
// fp32 exactly.  The low precisions round that value to bf16 (operand), as
// K1 receives it from scan_generate.product_view.  K2's p_seq and K3's
// draws are step_common.cuh's expressions.
//
// What bounded the first K1 on the H100 (PERF.md §5, 185 us a flagship
// step, 15.7 us + 8.47 us a layer): every weight read from L2 inside the
// chain, one dependent load a term; the FIFO read and the cond row as round
// trips on the chain; the output stack as two 256-term chains of L2 loads; a
// tail of 64 threads on res/skip; four __syncthreads a layer.  The design:
//
//   * Weights staged by TMA.  The wrapper re-lays every stack once per
//     upload into one stream (ops/persistent.py::staged_plan and
//     staged_stream): per layer Wprev, Wcur, rs_w in the storage's own
//     bytes, then out_w and end_w as the value view holds them (int8
//     quantises dil_w and rs_w only, as the JAX kernel streams only those
//     two), each as k-quads [ceil(K/4), Np, 4] (Np: the columns rounded up
//     to 4), zero-padded, so a quad is 16 bytes (fp32), 8 (bf16) or 4 (int8
//     q).  A producer warp copies it in chunks of whole quad-rows
//     (cp.async.bulk, 1D TMA), one lane per slot, through two mbarrier
//     rings of equal slots: the prev ring (Wprev, for the prev warps) and
//     the chain ring (the rest), in the order they are consumed, running on
//     across layers, into the output stack and into the next step.  A
//     consumer thread reads the four k-terms of its column in one shared
//     load while the activation quad is a broadcast; under int8 it loads its
//     columns' scales once a layer into registers, beside the rs biases.
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
//     The mode is read only in the sampler, after the output stack: forced
//     and prng cost the chain nothing.
//   * Fixed widths: at the flagship's and config 4's widths (`fixed_widths`)
//     an instance has R, S, A, the thread counts and the plan's chunking
//     compiled in, so every product's columns a thread, quad-row stride and
//     trip count are constants and its quad loop unrolls whole (K4 ran 1.5x
//     slower without them); the plan (ops/persistent.py::staged_plan) picks
//     it, the launch checks the two agree, and every other geometry runs
//     the generic instance.
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
// ~28 us), the bf16 stream (half the bytes) on few.  int8 moves a quarter
// of the layer bytes but costs the chain ~3.25 more instructions a weight
// (the byte permute and exact subtract of (float)q, the dequantising FMUL,
// a quarter XOR), ~0.5 us a flagship layer: 1.2x K1 on an H100 (PERF.md
// §6).  The card-wide bound (operations at the fp32 rate over all SMs) is
// far below what one CTA per row can reach.
//
// Compiled with -fmad=false (utils/build.py), one library per precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "exact_math.cuh"
#include "step_common.cuh"

extern __shared__ __align__(128) unsigned char smem[];

namespace {

using namespace nvw;

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

}  // namespace

#include "staged_common.cuh"

namespace {

// kModes: the modes an instance's sampler serves, sample and argmax (K1,
// K5) or all four (K2, K3, K4)
constexpr int kTwoModes = 2;
constexpr int kAllModes = 4;
// the layer stacks' storage (ops/persistent.py _STORAGE_IDS)
constexpr int kStorageF32 = 0;
constexpr int kStorageBF16 = 1;
constexpr int kStorageI8 = 2;

// bytes of a stored weight of Wprev, Wcur and rs_w
__host__ __device__ constexpr int layer_store(int storage) {
  return storage == kStorageF32 ? 4 : storage == kStorageBF16 ? 2 : 1;
}

// bytes of a stored weight of out_w and end_w: fp32 (exact) or bf16 beside
// int8 stacks (ops/persistent.py::staged_out_storage), else the stacks'
__host__ __device__ constexpr int out_store(int storage, int prec) {
  return storage == kStorageI8 ? (prec == kPrecExact ? 4 : 2) : layer_store(storage);
}

// The widths an instance is compiled for, and the plan's numbers there in
// each precision and storage (ops/persistent.py::staged_plan with a prev
// buffer of 4 layers; tests/test_torch_staged.py and test_torch_route.py
// hold the two equal): R, S, A, the chain's and the prev warps' threads,
// and the quad-rows a chunk of Wprev, Wcur, rs_w, out_w and end_w brings.
// K1/K5's rows are those of their precision's own storage (fp32 exact,
// else bf16).  Geometry 0 is the generic instance: it takes every number
// from the plan at run time.
struct Fixed {
  int R, S, A, Tc, Tp;
  int rows[5];
};
constexpr int kGeometries = 3;

__host__ __device__ constexpr Fixed fixed_widths(int geo, int prec, int storage) {
  // geometry 1: the flagship's widths (20 layers, R=64, S=256, A=256);
  // geometry 2: config 4's (40 layers, R=128, S=256, A=256)
  return geo == 1 && storage == kStorageF32 ? Fixed{64, 256, 256, 320, 128, {16, 16, 10, 12, 12}}
       : geo == 1 && storage == kStorageBF16 ? Fixed{64, 256, 256, 320, 128, {16, 16, 16, 30, 30}}
       : geo == 1 && prec == kPrecExact     ? Fixed{64, 256, 256, 320, 128, {16, 16, 16, 16, 16}}
       : geo == 1                           ? Fixed{64, 256, 256, 320, 128, {16, 16, 16, 32, 32}}
       : geo == 2 && storage == kStorageF32 ? Fixed{128, 256, 256, 192, 128, {8, 12, 8, 12, 12}}
       : geo == 2 && storage == kStorageBF16 ? Fixed{128, 256, 256, 192, 128, {16, 24, 16, 24, 24}}
       : geo == 2 && prec == kPrecExact     ? Fixed{128, 256, 256, 192, 128, {32, 32, 32, 12, 12}}
       : geo == 2                           ? Fixed{128, 256, 256, 192, 128, {32, 32, 32, 24, 24}}
                                            : Fixed{};
}

// K1's parameters; K5's and the all-mode instance's extend them, so K1's
// stay at their offsets (and K5's rows at theirs)
struct StagedArgs {
  const float* embed;            // [2A, R]
  const unsigned char* stream;   // the relaid stacks (staged_stream)
  const float* rs_b;             // [L, R+S]
  const float* out_b;            // [A]
  const float* end_b;            // [A]
  const float* cond;             // [T, L, B, 2R], dil_b already added
  const float* sel;              // [T, B]: uniforms, or the symbols in mode forced
  const int* sched;              // [2, L]: ring_offsets, then dilations
  float* ring;                   // [ring_size, B, R] (bf16 under kPrecBF16)
  int* y_state;                  // [2, B]
  int* y;                        // [T, B]
  float* d_xt;                   // [L, B, R]  } last-step dump, null when off
  float* d_skip;                 // [L, B, S]  }
  float* d_zs;                   // [B, A]     }
  float* d_za;                   // [B, A]     }
  float* d_p;                    // [B, A]     }
  int T;                         // K5: y's steps (it writes 0 past a row's length)
  int spare[3];                  // keeps K1's later parameters at their offsets
  long long t0;
  int n_valid;
  int B, L, R, S, A, tanh_embed, silence_bin, mode;
  // the plan
  int chain_threads, prev_threads, slot_bytes, chain_slots, prev_slots;
  int lookahead;                 // layers of the prev buffer
  int prev_slot_bytes;           // a prev ring slot (slot_bytes: a chain ring slot)
  int storage;                   // bytes of a stored layer weight: 4, 2 or 1
  long long layer_bytes;
  int smem_bytes;
  Mat mat[5];
};

// The all-mode instance's: the int8 scales, K2's p_seq and K3's key
struct StreamArgs : StagedArgs {
  const float* dil_s;            // [L, 2R]   } int8 scales, null otherwise
  const float* rs_s;             // [L, R+S]  }
  float* p_seq;                  // [T, B, A] mode forced only
  unsigned long long seed;       // mode prng: the Philox key
};

// K5's rows travel in the launch's own parameters, by value: each row's
// clock and length, so no copy precedes the launch.  A batch of more than
// kRaggedRows rows launches in groups of kRaggedRows, each with its
// pointers moved to its first row (the rows are independent: a CTA reads
// and writes only its own row, B stays the stride).  The parameters stay
// under the 4 KB every launch takes.
constexpr int kRaggedRows = 256;

struct RaggedArgs : StagedArgs {
  long long t0_row[kRaggedRows];   // the group's row i's absolute clock
  int n_valid_row[kRaggedRows];    // the group's row i's steps (<= T)
};
static_assert(sizeof(RaggedArgs) <= 4096, "K5's parameters past 4 KB");

template <bool kRagged, int kModes>
using KernelArgs =
    std::conditional_t<kRagged, RaggedArgs,
                       std::conditional_t<kModes == kAllModes, StreamArgs, StagedArgs>>;

// the clock and the steps of the launch's i-th CTA
__device__ __forceinline__ long long row_clock(const StagedArgs& a, int) { return a.t0; }
// The two loads pass through an opaque move: without it ptxas allocated and
// scheduled the staged K5 otherwise than the K5 that loaded its rows from
// global memory, and it ran 0.7% slower (PERF.md, Findings)
__device__ __forceinline__ long long row_clock(const RaggedArgs& a, int i) {
  long long t = a.t0_row[i];
  asm volatile("mov.b64 %0, %0;" : "+l"(t));
  return t;
}
__device__ __forceinline__ int row_steps(const StagedArgs& a, int) { return a.n_valid; }
__device__ __forceinline__ int row_steps(const RaggedArgs& a, int i) {
  int n = a.n_valid_row[i];
  asm volatile("mov.b32 %0, %0;" : "+r"(n));
  return n;
}

// The all-mode instance's own parameters; the others read none of them
// (every use sits behind kQuant or kModes == kAllModes)
__device__ __forceinline__ const float* dil_scales(const StagedArgs&) { return nullptr; }
__device__ __forceinline__ const float* dil_scales(const StreamArgs& a) { return a.dil_s; }
__device__ __forceinline__ const float* rs_scales(const StagedArgs&) { return nullptr; }
__device__ __forceinline__ const float* rs_scales(const StreamArgs& a) { return a.rs_s; }
__device__ __forceinline__ float* p_seq_of(const StagedArgs&) { return nullptr; }
__device__ __forceinline__ float* p_seq_of(const StreamArgs& a) { return a.p_seq; }
__device__ __forceinline__ unsigned long long seed_of(const StagedArgs&) { return 0; }
__device__ __forceinline__ unsigned long long seed_of(const StreamArgs& a) { return a.seed; }

// ---- the k-quad products ---------------------------------------------------

// quad q of column `col` of a chunk as four product operands: fp32 as
// stored, bf16 widened exactly, int8 q as the one rounded product q * s
// (rounded to bf16 under the low precisions)
template <int kStore, int kPrec>
__device__ __forceinline__ float4 load_quad(const unsigned char* w, int idx, float s) {
  if constexpr (kStore == 4) {
    return reinterpret_cast<const float4*>(w)[idx];
  } else if constexpr (kStore == 2) {
    const uint2 u = reinterpret_cast<const uint2*>(w)[idx];
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    // q + 128 in each byte (flipping a byte's sign bit), then per byte
    // (float)q exactly: one byte permute builds the float 1.5 * 2^23 + 128
    // + q, and an exact subtract takes 1.5 * 2^23 + 128 off (the conversion
    // instruction issues at a quarter of the rate); then one rounded product
    const unsigned u = reinterpret_cast<const unsigned*>(w)[idx] ^ 0x80808080u;
    auto value = [s, u](int e) {
      return __fmul_rn(__int_as_float(__byte_perm(u, 0x4B400000u, 0x7640 | e)) - 12583040.0f, s);
    };
    const float v0 = value(0), v1 = value(1), v2 = value(2), v3 = value(3);
    if constexpr (kPrec == kPrecExact) {
      return make_float4(v0, v1, v2, v3);
    } else {
      // operand<kPrec> of each, two at a time: round to nearest even bf16
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1), hi = __floats2bfloat162_rn(v2, v3);
      const unsigned a = *reinterpret_cast<const unsigned*>(&lo);
      const unsigned b = *reinterpret_cast<const unsigned*>(&hi);
      return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                         __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
    }
  }
}

// acc[i] += the four terms of activation quad `a` and the weight quad in
// quad-row `row` of column col[i] (scale sc[i] under int8), in k order
template <int kStore, int kPrec, int NC>
__device__ __forceinline__ void mac_quad(float (&acc)[kMaxNC], const float4 a,
                                         const unsigned char* w, int row,
                                         const int (&col)[kMaxNC], const float (&sc)[kMaxNC]) {
  float4 wq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) wq[i] = load_quad<kStore, kPrec>(w, row + col[i], sc[i]);
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
template <int kStore, int kPrec, int NC>
__device__ __forceinline__ void mac_quads(float (&acc)[kMaxNC], const float* act,
                                          const unsigned char* w, const int (&col)[kMaxNC],
                                          const float (&sc)[kMaxNC], int np, int nq, int rem) {
#pragma unroll 4
  for (int q = 0; q < nq; ++q)
    mac_quad<kStore, kPrec, NC>(acc, reinterpret_cast<const float4*>(act)[q], w, q * np, col, sc);
  if (rem) {
    const float4 a = reinterpret_cast<const float4*>(act)[nq];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float4 wq = load_quad<kStore, kPrec>(w, nq * np + col[i], sc[i]);
      acc[i] = acc[i] + a.x * wq.x;
      if (rem > 1) acc[i] = acc[i] + a.y * wq.y;
      if (rem > 2) acc[i] = acc[i] + a.z * wq.z;
    }
  }
}

template <int kStore, int kPrec>
__device__ __forceinline__ void mac_quads_n(float (&acc)[kMaxNC], const float* act,
                                            const unsigned char* w, const int (&col)[kMaxNC],
                                            const float (&sc)[kMaxNC], int nc, int np, int nq,
                                            int rem) {
  if (nc == 1) mac_quads<kStore, kPrec, 1>(acc, act, w, col, sc, np, nq, rem);
  else if (nc == 2) mac_quads<kStore, kPrec, 2>(acc, act, w, col, sc, np, nq, rem);
  else if (nc == 3) mac_quads<kStore, kPrec, 3>(acc, act, w, col, sc, np, nq, rem);
  else if (nc == 4) mac_quads<kStore, kPrec, 4>(acc, act, w, col, sc, np, nq, rem);
}

// mac_quads at fixed widths: NQ whole quads, quad-rows of NP quads, fully
// unrolled, so every load is a constant offset from the thread's column
template <int kStore, int kPrec, int NC, int NP, int NQ>
__device__ __forceinline__ void mac_fixed(float (&acc)[kMaxNC], const float* act,
                                          const unsigned char* w, const int (&col)[kMaxNC],
                                          const float (&sc)[kMaxNC]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    mac_quad<kStore, kPrec, NC>(acc, reinterpret_cast<const float4*>(act)[q], w, q * NP, col, sc);
}

// The product of matrix m over its chunks as they land in ring r: every
// thread of the consuming group walks every chunk (so all keep one
// position), the nc > 0 ones add its terms; each warp then frees the slot.
template <int kStore, int kPrec>
__device__ __forceinline__ void ring_product(Ring& r, const Mat& m, int K, const float* act,
                                             float (&acc)[kMaxNC], const int (&col)[kMaxNC],
                                             const float (&sc)[kMaxNC], int nc, int lane,
                                             int slot_bytes) {
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
      mac_quads_n<kStore, kPrec>(acc, act + 4 * q0, r.slots + (size_t)r.slot * slot_bytes, col,
                                 sc, nc, np, nq, rem);
    }
    ring_release(r, lane);
  }
}

// One chunk of NQ quad-rows at fixed widths for a thread that owns NC
// columns, NC - STEP, or none
template <int kStore, int kPrec, int NC, int STEP, int NP, int NQ>
__device__ __forceinline__ void fixed_chunk(float (&acc)[kMaxNC], const float* act,
                                            const unsigned char* w, const int (&col)[kMaxNC],
                                            const float (&sc)[kMaxNC], int nc) {
  if (nc == NC) {
    mac_fixed<kStore, kPrec, NC, NP, NQ>(acc, act, w, col, sc);
  } else if constexpr (NC > STEP) {
    if (nc == NC - STEP) mac_fixed<kStore, kPrec, NC - STEP, NP, NQ>(acc, act, w, col, sc);
  }
}

// ring_product of stream matrix kM in an instance of fixed widths (kGeo >
// 0): K terms, N columns, chunks of the plan's quad-rows; a thread owns its
// share of the columns (of the R column pairs for Wcur), rounded up or down
template <int kStorage, int kGeo, int kPrec, int kM>
__device__ __forceinline__ void fixed_product(Ring& r, const float* act, float (&acc)[kMaxNC],
                                              const int (&col)[kMaxNC],
                                              const float (&sc)[kMaxNC], int nc, int lane,
                                              int slot_bytes) {
  constexpr Fixed F = fixed_widths(kGeo, kPrec, kStorage);
  constexpr int kStore = kM <= kRs ? layer_store(kStorage) : out_store(kStorage, kPrec);
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
      fixed_chunk<kStore, kPrec, NC, STEP, NP, ROWS>(acc, act + 4 * ROWS * c, w, col, sc, nc);
    } else {
      fixed_chunk<kStore, kPrec, NC, STEP, NP, LAST>(acc, act + 4 * ROWS * c, w, col, sc, nc);
    }
    ring_release(r, lane);
  }
}

// The product of stream matrix kM: at the instance's fixed widths, or
// generic
template <int kStorage, int kGeo, int kPrec, int kM>
__device__ __forceinline__ void product(Ring& r, const Mat& m, int K, const float* act,
                                        float (&acc)[kMaxNC], const int (&col)[kMaxNC],
                                        const float (&sc)[kMaxNC], int nc, int lane,
                                        int slot_bytes) {
  if constexpr (kGeo == 0) {
    constexpr int kStore = kM <= kRs ? layer_store(kStorage) : out_store(kStorage, kPrec);
    ring_product<kStore, kPrec>(r, m, K, act, acc, col, sc, nc, lane, slot_bytes);
  } else {
    fixed_product<kStorage, kGeo, kPrec, kM>(r, act, acc, col, sc, nc, lane, slot_bytes);
  }
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

template <bool kRagged, int kModes, int kStorage, int kPrec, int kGeo>
__global__ void __launch_bounds__(kMaxThreads, 1)
    staged_generate_kernel(const __grid_constant__ KernelArgs<kRagged, kModes> a) {
  constexpr bool kQuant = kStorage == kStorageI8;
  constexpr bool kAll = kModes == kAllModes;
  constexpr Fixed F = fixed_widths(kGeo, kPrec, kStorage);
  constexpr bool kFix = kGeo != 0;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int B = a.B, L = a.L;
  const int R = kFix ? F.R : a.R, S = kFix ? F.S : a.S, A = kFix ? F.A : a.A;
  const int R2 = 2 * R, RS = R + S;
  const int Tc = kFix ? F.Tc : a.chain_threads, Tp = kFix ? F.Tp : a.prev_threads;
  const int NP = a.lookahead;
  const int CS = a.chain_slots, PS = a.prev_slots;
  const float none[kMaxNC] = {1.0f, 1.0f, 1.0f, 1.0f};   // no scales (out_w, end_w)

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

  const long long t0 = row_clock(a, b);
  const int n_valid = row_steps(a, b);
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
    if constexpr (kRagged) {
      // y comes uninitialised: the row's steps past its length read 0 (on
      // the prev warps, where K5 measured faster than on the chain's)
      for (int j = n_valid + p; j < a.T; j += Tp) a.y[(size_t)j * B + b] = 0;
    }
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
      // the layer's int8 scales of Wprev, else 1.  Filled in the all-mode
      // instances alone: in K1/K5 even these dead stores moved ptxas's
      // schedule of the loop, so they take `none`
      float sc[kMaxNC];
      if constexpr (kAll) {
#pragma unroll
        for (int i = 0; i < kMaxNC; ++i)
          sc[i] = kQuant && i < ncp ? __ldg(dil_scales(a) + (size_t)(g % L) * R2 + col[i]) : 1.0f;
      }
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
      product<kStorage, kGeo, kPrec, kPrev>(prev, a.mat[kPrev], R, xpv, acc, col,
                                            *(kAll ? &sc : &none), ncp, lane,
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
      // the layer's rs biases and int8 scales, loaded under x_t Wcur
      float br[kMaxNC], scur[kMaxNC], srs[kMaxNC];
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k) {
        br[k] = k < n_rs ? __ldg(a.rs_b + (size_t)l * RS + rs_col[k]) : 0.0f;
        scur[k] = kQuant && k < n_cur ? __ldg(dil_scales(a) + (size_t)l * R2 + cur_col[k]) : 1.0f;
        srs[k] = kQuant && k < n_rs ? __ldg(rs_scales(a) + (size_t)l * RS + rs_col[k]) : 1.0f;
      }

      // x_t Wcur, then z = (zp + zc) + cond_pre, the FIFO write and the gate
      float acc[kMaxNC];
#pragma unroll
      for (int k = 0; k < kMaxNC; ++k) acc[k] = 0.0f;
      product<kStorage, kGeo, kPrec, kCur>(chain, a.mat[kCur], R, xop, acc, cur_col, scur, n_cur,
                                           lane, a.slot_bytes);
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
            ring_put<kPrec>(a.ring, row + i, x[i]);
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
      product<kStorage, kGeo, kPrec, kRs>(chain, a.mat[kRs], R, h, acc, rs_col, srs, n_rs, lane,
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
    product<kStorage, kGeo, kPrec, kOut>(chain, a.mat[kOut], S, skip, acc, out_col, none, n_out,
                                         lane, a.slot_bytes);
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
    product<kStorage, kGeo, kPrec, kEnd>(chain, a.mat[kEnd], A, zs, acc, out_col, none, n_out,
                                         lane, a.slot_bytes);
    NVW_TS(3);
#pragma unroll
    for (int k = 0; k < kMaxNC; ++k)
      if (k < n_out) za[out_col[k]] = acc[k] + eb[k];
    named_sync(kChainBar, Tc);

    // the sampler: the mode is read here only
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
      // the sum: the all-mode instance reads it once, K1/K5 where they use
      // it (each instance's code as it was measured, PERF.md §6)
      float total = 0.0f;
      if constexpr (kAll) total = cum[A - 1];
      if (dump) {
        // p = e / sum: a tolerance-governed output (sampling never divides)
        if constexpr (!kAll) total = cum[A - 1];
        for (int i = tid; i < A; i += Tc) {
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if (kAll && a.mode == kModeForced) {
        // the dump's p, for every step: p_seq[j, b, :] (K2's)
        float* pj = p_seq_of(a) + ((size_t)j * B + b) * A;
        for (int i = tid; i < A; i += Tc) pj[i] = nvw::em_exp(za[i] - zmax) / total;
        y = (int)u;
      } else if (a.mode == kModeArgmax) {
        y = chain_argmax(za, A, tid, Tc);
      } else {
        // the inverse CDF over an injected uniform, or K3's Philox draw
        const float thr = (kAll && a.mode == kModePrng ? philox_uniform(seed_of(a), t, b) : u) *
                          (kAll ? total : cum[A - 1]);
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

constexpr int kMaxDevices = 64;

// `rows` CTAs.  The shared-memory attribute is set once per instance and
// device (again only for a larger plan), not on every launch.
template <bool kRagged, int kModes, int kStorage, int kPrec, int kGeo>
int launch_instance(const KernelArgs<kRagged, kModes>& args, int threads, int rows,
                    void* stream) {
  auto kernel = staged_generate_kernel<kRagged, kModes, kStorage, kPrec, kGeo>;
  static std::atomic<int> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || granted[dev].load() < args.smem_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               args.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) granted[dev].store(args.smem_bytes);
  }
  kernel<<<rows, threads, args.smem_bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// The plan's checks, then the instance it chose, over `rows` CTAs
template <bool kRagged, int kModes, int kStorage, int kPrec>
int launch(KernelArgs<kRagged, kModes>& args, const long long* plan, int rows, void* stream) {
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
  const int Tc = args.chain_threads, Tp = args.prev_threads;
  bool ok = args.storage == layer_store(kStorage) && Tc > 0 && Tc % 32 == 0 && Tp > 0 &&
            Tp % 32 == 0 && threads == Tc + Tp + 32 && threads <= kMaxThreads &&
            args.lookahead >= 1 && args.lookahead <= args.L && args.chain_slots >= 2 &&
            args.prev_slots >= 2 && args.chain_slots + args.prev_slots <= 32 &&
            args.slot_bytes % 128 == 0 && args.prev_slot_bytes % 128 == 0 &&
            smem_layout_bytes(args, kPrec) == args.smem_bytes && 2 * Tc >= args.R &&
            Tc * kMaxNC >= args.R + args.S && Tc * kMaxNC >= args.A &&
            Tp * kMaxNC >= 2 * args.R && (kPrec != kPrecBF16 || args.R % 2 == 0);
  for (int m = 0; m < 5 && ok; ++m) {
    // whole 16-byte quad-rows of the matrix's element size, a chunk within
    // its slot, the matrix (at the last layer if per layer) within the
    // stream
    const Mat& mt = args.mat[m];
    const int store = m <= kRs ? layer_store(kStorage) : out_store(kStorage, kPrec);
    const long long slot = m == kPrev ? args.prev_slot_bytes : args.slot_bytes;
    const long long last = mt.offset + (m <= kRs ? (args.L - 1) * args.layer_bytes : 0);
    const int N = m <= kCur ? 2 * args.R : m == kRs ? args.R + args.S : args.A;
    ok = mt.row_bytes == ((N + 3) & ~3) * 4 * store && mt.rows >= 1 &&
         (long long)mt.rows * mt.row_bytes <= slot && mt.offset % 16 == 0 &&
         last + (long long)mt.kq * mt.row_bytes <= stream_bytes;
  }
  // the instance the plan chose: its fixed widths must be the plan's
  const int geo = (int)plan[32];
  ok = ok && geo >= 0 && geo < kGeometries;
  if (ok && geo > 0) {
    const Fixed f = fixed_widths(geo, kPrec, kStorage);
    ok = f.R == args.R && f.S == args.S && f.A == args.A && f.Tc == Tc && f.Tp == Tp;
    for (int m = 0; m < 5; ++m) ok = ok && f.rows[m] == args.mat[m].rows;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (geo) {
    case 1: return launch_instance<kRagged, kModes, kStorage, kPrec, 1>(args, threads, rows, stream);
    case 2: return launch_instance<kRagged, kModes, kStorage, kPrec, 2>(args, threads, rows, stream);
    default: return launch_instance<kRagged, kModes, kStorage, kPrec, 0>(args, threads, rows, stream);
  }
}

// the storage of K1/K5's stream in precision kPrec (ops/persistent.py
// staged_storage)
constexpr int own_storage(int prec) { return prec == kPrecExact ? kStorageF32 : kStorageBF16; }

// K1, K2, K3 and K4.  Modes sample and argmax on the precision's own
// storage run K1's instance, which has no branch of the other two; every
// other call runs the all-mode instance of its storage.
template <int kPrec>
int launch_lockstep(StreamArgs& args, int storage, const long long* plan, void* stream) {
  constexpr int kOwn = own_storage(kPrec);
  if (args.mode < kModeSample || args.mode > kModePrng ||
      (storage == kStorageI8 && (args.dil_s == nullptr || args.rs_s == nullptr)) ||
      (args.mode == kModeForced && args.p_seq == nullptr))
    return (int)cudaErrorInvalidValue;
  if (storage == kOwn && args.mode <= kModeArgmax)
    return launch<false, kTwoModes, kOwn, kPrec>(static_cast<StagedArgs&>(args), plan, args.B,
                                                 stream);
  if (storage == kStorageBF16)
    return launch<false, kAllModes, kStorageBF16, kPrec>(args, plan, args.B, stream);
  if (storage == kStorageI8)
    return launch<false, kAllModes, kStorageI8, kPrec>(args, plan, args.B, stream);
  if constexpr (kPrec == kPrecExact) {
    if (storage == kStorageF32)
      return launch<false, kAllModes, kStorageF32, kPrec>(args, plan, args.B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K5: the rows' clocks and lengths, host arrays, copied into the launch's
// parameters, kRaggedRows rows a launch
template <int kPrec>
int launch_ragged(RaggedArgs& args, const long long* t0_row, const int* n_valid_row,
                  const long long* plan, void* stream) {
  const RaggedArgs first = args;
  const size_t ring_row = (size_t)args.R * (kPrec == kPrecBF16 ? 2 : 4);
  for (int r0 = 0; r0 < args.B; r0 += kRaggedRows) {
    const int rows = args.B - r0 < kRaggedRows ? args.B - r0 : kRaggedRows;
    args.cond = first.cond + (size_t)r0 * 2 * args.R;
    args.sel = first.sel + r0;
    args.ring = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(first.ring) +
                                         r0 * ring_row);
    args.y_state = first.y_state + r0;
    args.y = first.y + r0;
    for (int i = 0; i < rows; ++i) {
      args.t0_row[i] = t0_row[r0 + i];
      args.n_valid_row[i] = n_valid_row[r0 + i];
    }
    const int err = launch<true, kTwoModes, own_storage(kPrec), kPrec>(args, plan, rows, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// K1, K2, K3 and K4: mode 0 sample, 1 argmax (sel: uniforms), 2 forced
// (sel: symbols, p_seq written), 3 prng (sel not read); storage 0 fp32
// (exact only), 1 bf16, 2 int8 (with dil_s, rs_s); the dump pointers all
// null when off.  `stream_w` is staged_stream's tensor; `plan` a host array
// of StagedPlan.kernel_args.
#define NVW_STAGED_ENTRY(name, kPrec)                                                          \
  int name(const float* embed, const void* stream_w, const float* dil_s, const float* rs_s,    \
           const float* rs_b, const float* out_b, const float* end_b, const float* cond,       \
           const float* sel, const int* sched, float* ring, int* y_state, int* y, float* d_xt, \
           float* d_skip, float* d_zs, float* d_za, float* d_p, float* p_seq, long long t0,    \
           unsigned long long seed, int n_valid, int B, int L, int R, int S, int A,            \
           int tanh_embed, int silence_bin, int mode, int storage, const long long* plan,      \
           void* stream) {                                                                     \
    StreamArgs args{{embed, (const unsigned char*)stream_w, rs_b, out_b, end_b, cond, sel,    \
                     sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, 0, {}, t0,       \
                     n_valid, B, L, R, S, A, tanh_embed, silence_bin, mode},                  \
                    dil_s, rs_s, p_seq, seed};                                                 \
    return launch_lockstep<kPrec>(args, storage, plan, stream);                                \
  }

// K5: mode "sample", no dump; t0_row [B] and n_valid_row [B] are host
// arrays (read before the call returns); y [T, B] need not be zeroed
#define NVW_STAGED_RAGGED_ENTRY(name, kPrec)                                                  \
  int name(const float* embed, const void* stream_w, const float* rs_b, const float* out_b,   \
           const float* end_b, const float* cond, const float* sel, const int* sched,         \
           float* ring, int* y_state, int* y, const long long* t0_row,                        \
           const int* n_valid_row, int T, int B, int L, int R, int S, int A, int tanh_embed,  \
           int silence_bin, const long long* plan, void* stream) {                            \
    RaggedArgs args{{embed, (const unsigned char*)stream_w, rs_b, out_b, end_b, cond, sel,   \
                     sched, ring, y_state, y, nullptr, nullptr, nullptr, nullptr, nullptr,   \
                     T, {}, 0, 0, B, L, R, S, A, tanh_embed, silence_bin, kModeSample}};     \
    return launch_ragged<kPrec>(args, t0_row, n_valid_row, plan, stream);                     \
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
