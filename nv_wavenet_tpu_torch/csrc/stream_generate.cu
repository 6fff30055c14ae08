// The first K4: K1 with the two large per-layer weight stacks streamed
// through shared memory (weight streaming, the engine's Impl.MANYBLOCK).
// Since the staged K4 (staged_generate.cu) it runs only where that
// kernel's plan cannot hold the geometry (ops/persistent.py::
// generation_route: A = 2048, for example), there also for K2 and K3.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762 with
// stream_weights=True: dil_w and rs_w stay in device memory and are copied
// into fast memory ahead of their use (`:128-199`), optionally running on
// into the next step (stream_prefetch, `:353-361`), stored as int8 with one
// fp32 scale per (layer, output column) and dequantized w = q * s before the
// products (stream_quant, `:105-108, 189-197, 434-465, 726-729`), or as bf16
// (weight_dtype, `:723-725`).  Every selector source and mode of K1/K2/K3:
// sample and argmax with the optional last-step dump, forced (p_seq), prng
// (Philox on the card).
//
// What it computes is K1's step, in K1's order (generic_generate.cu): the split
// dilated GEMM, the gate, the fused residual + skip GEMM, the output stack
// and the canonical sampler; the exact math of exact_math.cuh is inlined.
//
// Design (simple first):
//   * ONE CTA PER BATCH ROW, 256 threads, the whole call in one launch, the
//     FIFO ring in device memory, the activations in shared memory: K1's
//     layout.
//   * dil_w and rs_w reach the products through a ring of `stages` slots in
//     shared memory.  A stage is one block of `rows` whole rows of one
//     matrix: rows [k0, k0 + rows) of Wprev and of Wcur (dil_w), or of
//     [R, R+S] (rs_w).  Rows are contiguous and whole 16-byte units in every
//     storage, so one thread issues each piece as one bulk asynchronous copy
//     (cp.async.bulk, 1D TMA) that signals the slot's mbarrier with its byte
//     count; the issuer is the block's last thread, which owns the fewest
//     columns.  The copies run `stages - 1` stages ahead of the products: the
//     wrapper's plan (ops/persistent.py::stream_plan) takes the largest
//     blocks of which two fit (each stage costs a barrier and a wait) and
//     sizes the ring from stream_group_size.  With prefetch the copies run
//     on into the next step, so its first stages load under this step's
//     last layers, output stack and sampler; without it each step starts
//     with an empty ring.  No copy is issued for a step past n_valid, and
//     every copy issued is waited for before the CTA exits.
//   * Each layer's FIFO read x_{t-d} and conditioning row are loaded one
//     layer ahead into registers, and its rs biases (and int8 scales) at
//     the layer's start, off the step's chain of barriers.
//   * Each thread owns whole output columns (at most kMaxTasks per product)
//     and carries their accumulators in registers across the stages of a
//     matrix: each column still sums k = 0, 1, ..., K-1 from 0.0f, one
//     rounded product and one rounded add per term (-fmad=false), exactly
//     as K1's dot_column.  Dequantization rounds once, __fmul_rn((float)q,
//     s[col]); bf16 to fp32 is exact.  So K4 equals K1 fed the storage's
//     values (fp32 itself, the bf16-rounded values, q * s) bit for bit in y,
//     the ring and y_state.
//   * out_w and end_w (256 KB each at A=256) are read from device memory as
//     K1 reads them, eight loads ahead of their products (K2/K3's form); the
//     JAX kernel streams only dil_w and rs_w too.  Inside a stage each
//     thread loads eight terms of each of its columns before their products
//     and interleaves the columns' chains of adds; the column count is a
//     compile-time constant there, without which ptxas did not batch the
//     loads (1.5x slower on an H100, PERF.md).
//
// What bounds it: per row-step the stacks move from L2 into one SM (2.9 MB
// at fp32 at the flagship widths, 1.45 MB at bf16, 0.73 MB at int8), yet on
// an H100 the storage and the copies' lookahead barely move its time at the
// flagship (PERF.md): the step's chain on one SM per row binds it: each
// column's dependent adds, the barriers between the phases of a layer, the
// gate, and the output stack's dependent L2 loads (as in K1).  With
// 150-230 KB of shared memory a CTA has the SM to itself: B <= 132 runs
// in one wave, larger batches in waves.  The
// card-wide bound (operations over the fp32 rate of all SMs) is far below
// what one CTA per row can reach; wgmma, clusters and TMA multicast are
// later work.
//
// The precisions (kPrec, step_common.cuh) round where K1's do: fast_math and
// compute_dtype=bfloat16 (`:550, 553, 589-591`).  The stacks enter products
// rounded to bf16, so under both the fp32 and the bf16 storage hold the
// same values: the wrapper passes the rounded stacks as bf16 storage, and
// only kStorageBF16 and kStorageI8 have low-precision instances (int8
// dequantises to q * s in fp32 and rounds that).  K4 still equals K1 of
// the same precision bit for bit.  The kPrecExact code stays in `if
// constexpr` branches, so the exact instances compile as they did.
//
// A separate source from the generic kernel so that K1, K2, K3 and K5
// compile exactly as they did.  The selector sources, the batched column
// product and the Philox draw are step_common.cuh's, shared with them; the
// step's tail repeats K1's (folding it into the header as well moved K1's
// code and its time, PERF.md).  chip_smoke.py holds K4 against K1, K2 and
// K3 bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"
#include "step_common.cuh"

// The block's dynamic shared memory: the stage ring, its barriers, then the
// step's activations.  Operands of the products are addressed by offsets
// from it, so the compiler knows every such load is a shared-memory load.
extern __shared__ __align__(128) unsigned char smem[];

namespace {

using namespace nvw;

constexpr int kThreads = 256;
constexpr int kMaxTasks = 4;      // output columns per thread and product
constexpr int kStorageF32 = 0;
constexpr int kStorageBF16 = 1;
constexpr int kStorageI8 = 2;
// the general instances' kSel: the selector source is read at run time
constexpr int kSelRuntime = -1;

struct StreamArgs {
  const float* embed;   // [2A, R]
  const void* dil_w;    // [L, 2R, 2R] in the storage type
  const void* rs_w;     // [L, R, R+S] in the storage type
  const float* dil_s;   // [L, 2R]   } int8 scales, null otherwise
  const float* rs_s;    // [L, R+S]  }
  const float* rs_b;    // [L, R+S]
  const float* out_w;   // [S, A]
  const float* out_b;   // [A]
  const float* end_w;   // [A, A]
  const float* end_b;   // [A]
  const float* cond;    // [T, L, B, 2R], dil_b already added
  const float* sel;     // [T, B] (null in mode prng)
  const int* sched;     // [2, L]: ring_offsets, then dilations
  float* ring;          // [ring_size, B, R], updated in place (bf16 under kPrecBF16)
  int* y_state;         // [2, B] (y_prev, y_cur), updated in place
  int* y;               // [T, B]
  float* d_xt;          // [L, B, R]  } last-step dump, all null when off
  float* d_skip;        // [L, B, S]  }
  float* d_zs;          // [B, A]     }
  float* d_za;          // [B, A]     }
  float* d_p;           // [B, A]     }
  float* p_seq;         // [T, B, A] mode forced only
  long long t0;         // absolute index of the call's first step
  unsigned long long seed;   // mode prng: the Philox key
  int n_valid;          // steps to run (<= T)
  int B, L, R, S, A;
  int tanh_embed;
  int silence_bin;
  int mode;             // kModeSample or kModeArgmax (injected instances)
  int rows;             // weight rows per stage, divides R
  int stages;           // ring slots
  int stage_bytes;      // one slot, a multiple of 128
  int prefetch;         // copies may run into the next step
  // the general instances only (kGeneral): the stored rows' strides in
  // elements (2R and R+S padded to whole 16-byte units) and the selector
  // source (kSel*), a run-time argument there
  int ldd, ldr;
  int sel_src;
};

// ---- mbarriers and bulk copies (sm_90 PTX) --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a stage's phase, expecting `bytes` from its copies
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

// ---- the storages ----------------------------------------------------------

template <int kStorage>
struct Storage;
template <>
struct Storage<kStorageF32> {
  using T = float;
  static __device__ __forceinline__ float value(T w, float) { return w; }
};
template <>
struct Storage<kStorageBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float value(T w, float) { return __bfloat162float(w); }
};
template <>
struct Storage<kStorageI8> {
  using T = int8_t;
  // one rounded product: the value of dequantize_stream_params.  (float)q
  // by an integer add and an exact float subtract, 1.5 * 2^23 + q - 1.5 *
  // 2^23, instead of the conversion instruction (a quarter of the rate)
  static __device__ __forceinline__ float value(T w, float s) {
    return __fmul_rn(__int_as_float(0x4B400000 + (int)w) - 12582912.0f, s);
  }
};

// Copy the c-th stage of a step into the slot `dst` with barrier `bar`.
// Called by one thread, after a barrier that every reader of the slot's
// previous stage has passed.
// Stored rows are 2R (dil_w) and R+S (rs_w) elements long, or in the
// general instances a.ldd and a.ldr: those padded to whole 16-byte units.
template <typename TW, bool kGeneral>
__device__ __forceinline__ void issue_stage(const StreamArgs& a, unsigned char* dst,
                                            uint64_t* bar, int c, int per_layer) {
  const int R = a.R, R2 = 2 * R, RS = R + a.S, kc = a.rows, nd = R / kc;
  const int ldd = kGeneral ? a.ldd : R2, ldr = kGeneral ? a.ldr : RS;
  const int l = c / per_layer, s = c % per_layer;
  if (s < nd) {
    // rows [s kc, s kc + kc) of Wprev, then the same rows of Wcur
    const TW* W = (const TW*)a.dil_w + (size_t)l * R2 * ldd;
    const uint32_t half = (uint32_t)(kc * ldd * sizeof(TW));
    bar_expect(bar, 2 * half);
    bulk_copy(dst, W + (size_t)s * kc * ldd, half, bar);
    bulk_copy(dst + half, W + (size_t)(R + s * kc) * ldd, half, bar);
  } else {
    const TW* W = (const TW*)a.rs_w + (size_t)l * R * ldr + (size_t)(s - nd) * kc * ldr;
    const uint32_t bytes = (uint32_t)(kc * ldr * sizeof(TW));
    bar_expect(bar, bytes);
    bulk_copy(dst, W, bytes, bar);
  }
}

// The value of a stored weight as a product operand: int8 dequantises to
// q * s, rounded to bf16 under the low precisions; bf16 and fp32 storage
// hold operands already
template <int kStorage, int kPrec>
__device__ __forceinline__ float weight(typename Storage<kStorage>::T w, float s) {
  if constexpr (kStorage == kStorageI8) {
    return operand<kPrec>(Storage<kStorage>::value(w, s));
  } else {
    return Storage<kStorage>::value(w, s);
  }
}

// acc[i] += v_i[k] * w_i[k] for k = 0, 1, ..., kc - 1 in order, for the
// thread's NT columns: v_i[k] the float at smem offset voff[i] + k (floats),
// w_i[k] the value of the weight at woff[i] + k * ld (TW elements).  Eight
// terms of every column are loaded before their products, and the columns'
// chains of adds interleave.
template <int kStorage, int kPrec, int NT>
__device__ __forceinline__ void add_stage(float (&acc)[kMaxTasks], const int (&voff)[kMaxTasks],
                                          const int (&woff)[kMaxTasks],
                                          const float (&s)[kMaxTasks], int kc, int ld) {
  using TW = typename Storage<kStorage>::T;
  const float* fs = reinterpret_cast<const float*>(smem);
  const TW* ws = reinterpret_cast<const TW*>(smem);
  int k = 0;
  for (; k + 8 <= kc; k += 8) {
    float wk[NT][8], vk[NT][8];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        wk[i][u] = weight<kStorage, kPrec>(ws[woff[i] + (k + u) * ld], s[i]);
        vk[i][u] = fs[voff[i] + k + u];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[i] = acc[i] + vk[i][u] * wk[i][u];
    }
  }
  for (; k < kc; ++k) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      acc[i] = acc[i] + fs[voff[i] + k] * weight<kStorage, kPrec>(ws[woff[i] + k * ld], s[i]);
  }
}

// add_stage for the thread's n columns (0 <= n <= kMaxTasks)
template <int kStorage, int kPrec>
__device__ __forceinline__ void add_stage_n(float (&acc)[kMaxTasks], const int (&voff)[kMaxTasks],
                                            const int (&woff)[kMaxTasks],
                                            const float (&s)[kMaxTasks], int n, int kc, int ld) {
  if (n == 1) add_stage<kStorage, kPrec, 1>(acc, voff, woff, s, kc, ld);
  else if (n == 2) add_stage<kStorage, kPrec, 2>(acc, voff, woff, s, kc, ld);
  else if (n == 3) add_stage<kStorage, kPrec, 3>(acc, voff, woff, s, kc, ld);
  else if (n == 4) add_stage<kStorage, kPrec, 4>(acc, voff, woff, s, kc, ld);
}

// The general instances (kGeneral, kSel = kSelRuntime) take the geometries
// the others cannot: more than kMaxTasks * kThreads output columns in a
// product (4R or R+S), stored rows padded to whole 16-byte units (a.ldd,
// a.ldr), R past kThreads.  Each product's columns loop over the threads
// in passes of kMaxTasks * kThreads, and a column's running sum waits in
// shared memory (zh, max(4R, R+S) floats) between stages: each column still
// sums k = 0, 1, ..., K-1 from 0.0f in order.  The pad is never read.  The
// FIFO read and the conditioning are loaded in the layer, not a layer
// ahead.  Every other instance compiles as before (if constexpr).
//
// One CTA per SM (its shared memory allows no second): ptxas may give each
// thread up to 255 registers, where it otherwise held some instances to 128
// and spilled.
template <int kStorage, int kSel, int kPrec, bool kGeneral>
__global__ void __launch_bounds__(kThreads, 1) stream_generate_kernel(const StreamArgs a) {
  using TW = typename Storage<kStorage>::T;
  constexpr bool kQuant = kStorage == kStorageI8;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B, L = a.L, R = a.R, S = a.S, A = a.A;
  const int R2 = 2 * R, RS = R + S, kc = a.rows, nd = R / kc, per_layer = 2 * nd;
  const int P = a.stages;
  const int sel_src = kGeneral ? a.sel_src : kSel;
  unsigned char* slots = smem;                                   // [P][stage_bytes]
  uint64_t* full = (uint64_t*)(smem + (size_t)P * a.stage_bytes);  // [P]
  float* x = (float*)(smem + (size_t)P * a.stage_bytes + ((8 * P + 15) & ~15));
  float* xp = x + R;       // [R]   x_{t-d} read from the FIFO
  float* zh = xp + R;      // [4R]  dilated GEMM halves: [x_{t-d} Wprev | x_t Wcur]
  float* h = zh + (kGeneral ? max(2 * R2, RS) : 2 * R2);  // [R]   gate
  float* skip = h + R;     // [S]
  float* zs = skip + S;    // [A]
  float* za = zs + A;      // [A]
  float* c0 = za + A;      // [A]   prefix-sum ping-pong buffers
  float* c1 = c0 + A;      // [A]
  // [R] x as the operand of x_t Wcur: a rounded copy under kPrecFast (x
  // stays fp32 for the residual adds); x itself otherwise
  float* xop = kPrec == kPrecFast ? c1 + A : x;

  if (tid == 0) {
    for (int s = 0; s < P; ++s) bar_init(full + s);
    bar_init_fence();
  }
  __syncthreads();

  int y_prev = a.y_state[b];
  int y_cur = a.y_state[B + b];
  const long long t0 = a.t0;
  const int n_valid = a.n_valid;
  const int per_step = L * per_layer;
  // stages are counted from the call's start: g is the next to consume, in
  // slot `slot` at phase parity `phase`; the issuing thread has issued
  // `issued`, the next into slot `islot` as stage `ipos` of its step
  long long g = 0, issued = 0;
  int slot = 0, islot = 0, ipos = 0;
  uint32_t phase = 0;

  // Before consuming stage g (after a barrier that every reader of stage
  // g - 1 has passed): the issuing thread issues up to stage g + P - 1, into
  // the slot stage g - 1 left, but not past `limit`; then all wait for stage
  // g.  The issuer is the last thread, which owns the fewest columns.
  auto acquire = [&](long long limit) -> const TW* {
    if (tid == kThreads - 1) {
      const long long until = min(g + P, limit);
      for (; issued < until; ++issued) {
        issue_stage<TW, kGeneral>(a, slots + (size_t)islot * a.stage_bytes, full + islot, ipos,
                        per_layer);
        islot = islot + 1 == P ? 0 : islot + 1;
        ipos = ipos + 1 == per_step ? 0 : ipos + 1;
      }
    }
    bar_wait(full + slot, phase);
    return (const TW*)(slots + (size_t)slot * a.stage_bytes);
  };
  auto release = [&]() {
    ++g;
    if (++slot == P) {
      slot = 0;
      phase ^= 1u;
    }
  };

  // Thread i < R (4R <= 1024, so R <= kThreads) holds, one layer ahead, its
  // element of the next layer's FIFO read x_{t-d} and of that layer's
  // conditioning: both come from device memory, and their latency hides
  // under the current layer's work.  The slot read is not written before
  // its layer runs (each layer owns its slots; layer 0's slot at t + 1 was
  // written at t by this thread).
  float xp_next = 0.0f, ct_next = 0.0f, cg_next = 0.0f;
  auto fetch = [&](int jj, int ll) {
    if constexpr (kGeneral) return;
    if (tid < R) {
      const int off = __ldg(a.sched + ll), d = __ldg(a.sched + L + ll);
      if constexpr (kPrec == kPrecExact) {
        xp_next = a.ring[((size_t)(off + (int)((t0 + jj) & (d - 1))) * B + b) * R + tid];
      } else {
        xp_next = ring_get<kPrec>(
            a.ring, ((size_t)(off + (int)((t0 + jj) & (d - 1))) * B + b) * R + tid);
      }
      const float* c = a.cond + (((size_t)jj * L + ll) * B + b) * R2;
      ct_next = __ldg(c + tid);
      cg_next = __ldg(c + R + tid);
    }
  };
  if constexpr (!kGeneral) fetch(0, 0);

  for (int j = 0; j < n_valid; ++j) {
    const long long t = t0 + j;
    const bool dump = a.d_xt != nullptr && j == n_valid - 1;
    const long long limit = (long long)(a.prefetch ? n_valid : j + 1) * per_step;

    // embedding: fl(embed_prev[y_prev] + embed_cur[y_cur]), then exact tanh
    for (int i = tid; i < R; i += nt) {
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
    for (int i = tid; i < S; i += nt) skip[i] = 0.0f;
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // this thread's int8 scales and rs biases for the layer, loaded under
      // the FIFO and the dilated GEMM
      float sd[kMaxTasks], sr[kMaxTasks], br[kMaxTasks];
#pragma unroll
      for (int i = 0; i < kMaxTasks; ++i) {
        const int q = tid + i * kThreads;   // a dil_w task, an rs_w column
        sd[i] = kQuant && q < 2 * R2 ? __ldg(a.dil_s + (size_t)l * R2 + (q % R2)) : 1.0f;
        sr[i] = kQuant && q < RS ? __ldg(a.rs_s + (size_t)l * RS + q) : 1.0f;
        br[i] = q < RS ? __ldg(a.rs_b + (size_t)l * RS + q) : 0.0f;
      }

      // FIFO: x_{t-d} (fetched a layer ahead) out, x_t into the same slot;
      // then fetch the next layer's
      const int offset = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      const float ct = ct_next, cg = cg_next;
      if constexpr (kGeneral) {
        for (int i = tid; i < R; i += nt) {
          const size_t e = ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R + i;
          xp[i] = operand<kPrec>(ring_get<kPrec>(a.ring, e));
          ring_put<kPrec>(a.ring, e, x[i]);
        }
      } else if constexpr (kPrec == kPrecExact) {
        float* slot = a.ring + ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R;
        if (tid < R) {
          xp[tid] = xp_next;
          slot[tid] = x[tid];
        }
      } else {
        if (tid < R) {
          xp[tid] = operand<kPrec>(xp_next);
          ring_put<kPrec>(a.ring, ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R + tid,
                          x[tid]);
        }
      }
      if constexpr (!kGeneral) {
        if (l + 1 < L) {
          fetch(j, l + 1);
        } else if (j + 1 < n_valid) {
          fetch(j + 1, 0);
        }
      }
      __syncthreads();

      // split dilated GEMM: task q < 2R is column q of x_{t-d} Wprev, task
      // q >= 2R column q - 2R of x_t Wcur; a stage holds rows [k0, k0 + kc)
      // of Wprev, then of Wcur
      const int n_dil = (2 * R2 - tid + kThreads - 1) / kThreads;  // this thread's tasks
      // operand offsets from smem: floats for v, TW elements for w
      const int x_off = (int)(x - (const float*)smem), xp_off = x_off + R;
      const int xop_off = kPrec == kPrecFast ? (int)(xop - (const float*)smem) : x_off;
      const int h_off = (int)(h - (const float*)smem);
      float acc[kMaxTasks];
      int voff[kMaxTasks], woff[kMaxTasks];
      if constexpr (kGeneral) {
        // passes of kMaxTasks * kThreads columns, each column's sum carried
        // in zh across the stages
        for (int ch = 0; ch < nd; ++ch) {
          if (ch) __syncthreads();
          const TW* W = acquire(limit);
          const int w0 = (int)(W - (const TW*)smem);
          for (int base = 0; base < 2 * R2; base += kMaxTasks * kThreads) {
            const int n = max(0, (2 * R2 - base - tid + kThreads - 1) / kThreads);
            float s[kMaxTasks];
#pragma unroll
            for (int i = 0; i < kMaxTasks; ++i) {
              const int q = base + tid + i * kThreads, cur = q >= R2, col = q - cur * R2;
              voff[i] = (cur ? xop_off : xp_off) + ch * kc;
              woff[i] = w0 + cur * kc * a.ldd + col;
              s[i] = kQuant && q < 2 * R2 ? __ldg(a.dil_s + (size_t)l * R2 + col) : 1.0f;
              acc[i] = ch == 0 || q >= 2 * R2 ? 0.0f : zh[q];
            }
            add_stage_n<kStorage, kPrec>(acc, voff, woff, s, min(n, kMaxTasks), kc, a.ldd);
#pragma unroll
            for (int i = 0; i < kMaxTasks; ++i) {
              const int q = base + tid + i * kThreads;
              if (q < 2 * R2) zh[q] = acc[i];
            }
          }
          release();
        }
        __syncthreads();
        const float* c = a.cond + (((size_t)j * L + l) * B + b) * R2;
        for (int i = tid; i < R; i += nt) {
          const float zt = (zh[i] + zh[R2 + i]) + __ldg(c + i);
          const float zg = (zh[R + i] + zh[R2 + R + i]) + __ldg(c + R + i);
          h[i] = operand<kPrec>(nvw::em_tanh(zt) * nvw::em_sigmoid(zg));
        }
        __syncthreads();
      } else {
#pragma unroll
      for (int i = 0; i < kMaxTasks; ++i) acc[i] = 0.0f;
      for (int ch = 0; ch < nd; ++ch) {
        if (ch) __syncthreads();
        const TW* W = acquire(limit);
        const int w0 = (int)(W - (const TW*)smem);
#pragma unroll
        for (int i = 0; i < kMaxTasks; ++i) {
          const int q = tid + i * kThreads, cur = q >= R2;
          voff[i] = (cur ? xop_off : xp_off) + ch * kc;
          woff[i] = w0 + cur * kc * R2 + (q - cur * R2);
        }
        add_stage_n<kStorage, kPrec>(acc, voff, woff, sd, n_dil, kc, R2);
        release();
      }
#pragma unroll
      for (int i = 0; i < kMaxTasks; ++i) {
        const int q = tid + i * kThreads;
        if (q < 2 * R2) zh[q] = acc[i];
      }
      __syncthreads();

      // z = (zp + zc) + cond_pre; gate h = tanh(z[:R]) * sigmoid(z[R:])
      if (tid < R) {
        const float zt = (zh[tid] + zh[R2 + tid]) + ct;
        const float zg = (zh[R + tid] + zh[R2 + R + tid]) + cg;
        h[tid] = operand<kPrec>(nvw::em_tanh(zt) * nvw::em_sigmoid(zg));
      }
      __syncthreads();
      }

      // fused residual + skip GEMM: [R | S] output columns
      if constexpr (kGeneral) {
        for (int ch = 0; ch < nd; ++ch) {
          if (ch) __syncthreads();
          const TW* W = acquire(limit);
          const int w0 = (int)(W - (const TW*)smem);
          for (int base = 0; base < RS; base += kMaxTasks * kThreads) {
            const int n = max(0, (RS - base - tid + kThreads - 1) / kThreads);
            float s[kMaxTasks];
#pragma unroll
            for (int i = 0; i < kMaxTasks; ++i) {
              const int o = base + tid + i * kThreads;
              voff[i] = h_off + ch * kc;
              woff[i] = w0 + o;
              s[i] = kQuant && o < RS ? __ldg(a.rs_s + (size_t)l * RS + o) : 1.0f;
              acc[i] = ch == 0 || o >= RS ? 0.0f : zh[o];
            }
            add_stage_n<kStorage, kPrec>(acc, voff, woff, s, min(n, kMaxTasks), kc, a.ldr);
#pragma unroll
            for (int i = 0; i < kMaxTasks; ++i) {
              const int o = base + tid + i * kThreads;
              if (o < RS) zh[o] = acc[i];
            }
          }
          release();
        }
        // each thread finishes the columns it summed (o = tid + k kThreads)
        for (int o = tid; o < RS; o += nt) {
          const float v = zh[o], bias = __ldg(a.rs_b + (size_t)l * RS + o);
          if (o < R) {
            const float xv = (v + bias) + x[o];
            x[o] = stored<kPrec>(xv);
            if constexpr (kPrec == kPrecFast) xop[o] = operand<kPrec>(xv);
          } else {
            skip[o - R] = (skip[o - R] + v) + bias;
          }
        }
        __syncthreads();
        if (dump) {
          for (int i = tid; i < R; i += nt) a.d_xt[((size_t)l * B + b) * R + i] = x[i];
          for (int i = tid; i < S; i += nt) a.d_skip[((size_t)l * B + b) * S + i] = skip[i];
        }
        continue;
      }
      const int n_rs = (RS - tid + kThreads - 1) / kThreads;
#pragma unroll
      for (int i = 0; i < kMaxTasks; ++i) acc[i] = 0.0f;
      for (int ch = 0; ch < nd; ++ch) {
        if (ch) __syncthreads();
        const TW* W = acquire(limit);
        const int w0 = (int)(W - (const TW*)smem);
#pragma unroll
        for (int i = 0; i < kMaxTasks; ++i) {
          voff[i] = h_off + ch * kc;
          woff[i] = w0 + tid + i * kThreads;
        }
        add_stage_n<kStorage, kPrec>(acc, voff, woff, sr, n_rs, kc, RS);
        release();
      }
#pragma unroll
      for (int i = 0; i < kMaxTasks; ++i) {
        const int o = tid + i * kThreads;
        if (o < R) {
          const float v = (acc[i] + br[i]) + x[o];
          x[o] = stored<kPrec>(v);
          if constexpr (kPrec == kPrecFast) xop[o] = operand<kPrec>(v);
        } else if (o < RS) {
          skip[o - R] = (skip[o - R] + acc[i]) + br[i];
        }
      }
      __syncthreads();

      if (dump) {
        for (int i = tid; i < R; i += nt) a.d_xt[((size_t)l * B + b) * R + i] = x[i];
        for (int i = tid; i < S; i += nt) a.d_skip[((size_t)l * B + b) * S + i] = skip[i];
      }
    }

    if constexpr (kPrec == kPrecExact) {
      for (int i = tid; i < S; i += nt) skip[i] = fmaxf(skip[i], 0.0f);
      __syncthreads();
      if (dump) {
        for (int i = tid; i < S; i += nt) a.d_skip[((size_t)(L - 1) * B + b) * S + i] = skip[i];
      }
    } else {
      // the dump takes relu(skip) in fp32, the product its rounded copy
      for (int i = tid; i < S; i += nt) {
        const float s = fmaxf(skip[i], 0.0f);
        if (dump) a.d_skip[((size_t)(L - 1) * B + b) * S + i] = s;
        skip[i] = operand<kPrec>(s);
      }
      __syncthreads();
    }

    // output stack: zs = relu(skip Wzs + bzs); za = zs Wza + bza
    for (int o = tid; o < A; o += nt) {
      const float v =
          fmaxf(dot_column_batched(skip, a.out_w + o, S, A) + __ldg(a.out_b + o), 0.0f);
      if constexpr (kPrec == kPrecExact) {
        zs[o] = v;
      } else {
        // the dump takes zs in fp32, the product its rounded copy
        zs[o] = operand<kPrec>(v);
        if (dump) a.d_zs[(size_t)b * A + o] = v;
      }
    }
    __syncthreads();
    for (int o = tid; o < A; o += nt) {
      za[o] = dot_column_batched(zs, a.end_w + o, A, A) + __ldg(a.end_b + o);
    }
    __syncthreads();

    int y;
    if (a.mode == kModeArgmax && !dump) {
      y = nvw::block_argmax(za, A);
    } else {
      // canonical softmax pieces: e = exp(za - max), fixed-tree prefix sum
      float mm = -INFINITY;
      for (int i = tid; i < A; i += nt) mm = fmaxf(mm, za[i]);
      const float zmax = nvw::block_max(mm);
      for (int i = tid; i < A; i += nt) c0[i] = nvw::em_exp(za[i] - zmax);
      __syncthreads();
      const float* cum = nvw::block_fixed_tree_cumsum(c0, c1, A);
      if (dump) {
        const float total = cum[A - 1];
        for (int i = tid; i < A; i += nt) {
          if constexpr (kPrec == kPrecExact) a.d_zs[(size_t)b * A + i] = zs[i];
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if (sel_src == kSelForced) {
        const float total = cum[A - 1];
        float* p = a.p_seq + ((size_t)j * B + b) * A;
        for (int i = tid; i < A; i += nt) p[i] = nvw::em_exp(za[i] - zmax) / total;
        y = (int)__ldg(a.sel + (size_t)j * B + b);
      } else if (a.mode == kModeArgmax) {
        y = nvw::block_argmax(za, A);
      } else {
        const float u = sel_src == kSelPrng ? philox_uniform(a.seed, t, b)
                                         : __ldg(a.sel + (size_t)j * B + b);
        y = nvw::block_select_from_cumsum(cum, u, A, a.silence_bin);
      }
    }
    y_prev = y_cur;
    y_cur = y;
    if (tid == 0) a.y[(size_t)j * B + b] = y;
    __syncthreads();   // shared activations are rewritten by the next step
  }
  if (tid == 0) {
    a.y_state[b] = y_prev;
    a.y_state[B + b] = y_cur;
  }
}

template <int kStorage, int kSel, int kPrec, bool kGeneral = false>
int launch(const StreamArgs& args, int smem, void* stream) {
  auto kernel = stream_generate_kernel<kStorage, kSel, kPrec, kGeneral>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<args.B, kThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

template <int kStorage, int kPrec>
int launch_mode(const StreamArgs& args, int mode, int smem, void* stream) {
  if (args.ldd) return launch<kStorage, kSelRuntime, kPrec, true>(args, smem, stream);
  if (mode == kModeForced) return launch<kStorage, kSelForced, kPrec>(args, smem, stream);
  if (mode == kModePrng) return launch<kStorage, kSelPrng, kPrec>(args, smem, stream);
  return launch<kStorage, kSelInjected, kPrec>(args, smem, stream);
}

// The entry points' arguments.  mode: 0 sample, 1 argmax (sel: uniforms), 2
// forced (sel: symbols, p_seq written), 3 prng (sel not read); storage: 0
// fp32, 1 bf16, 2 int8 (with dil_s, rs_s); rows/stages/stage_bytes/
// prefetch/smem_bytes from the plan; ldd/ldr: 0, or the stored rows'
// strides in elements for a general instance (ops/persistent.py
// stream_plan)
#define NVW_STREAM_PARAMS                                                                     \
  const float *embed, const void *dil_w, const void *rs_w, const float *dil_s,                \
      const float *rs_s, const float *rs_b, const float *out_w, const float *out_b,           \
      const float *end_w, const float *end_b, const float *cond, const float *sel,            \
      const int *sched, float *ring, int *y_state, int *y, float *d_xt, float *d_skip,        \
      float *d_zs, float *d_za, float *d_p, float *p_seq, long long t0,                       \
      unsigned long long seed, int n_valid, int B, int L, int R, int S, int A, int tanh_embed, \
      int silence_bin, int mode, int storage, int rows, int stages, int stage_bytes,          \
      int prefetch, int smem_bytes, int ldd, int ldr, void *stream

template <int kPrec>
int stream_generate(NVW_STREAM_PARAMS) {
  // the low precisions take the stacks as bf16 (fp32 stacks rounded to bf16
  // hold the same operands) or int8
  const int lowest = kPrec == kPrecExact ? kStorageF32 : kStorageBF16;
  const int eb = storage == kStorageF32 ? 4 : storage == kStorageBF16 ? 2 : 1;
  // a general instance takes rows padded to 16 bytes and any column count
  const bool general = ldd != 0;
  if (mode < kModeSample || mode > kModePrng || storage < lowest ||
      storage > kStorageI8 || rows < 1 || R % rows || stages < 2 || stage_bytes % 128 ||
      (general ? ldd < 2 * R || ldr < R + S || ldd * eb % 16 || ldr * eb % 16
               : 4 * R > kMaxTasks * kThreads || R + S > kMaxTasks * kThreads))
    return (int)cudaErrorInvalidValue;
  const int sel_src = mode == kModeForced ? kSelForced : mode == kModePrng ? kSelPrng
                                                                           : kSelInjected;
  const StreamArgs args{embed, dil_w, rs_w, dil_s, rs_s, rs_b, out_w, out_b, end_w,
                        end_b, cond, sel, sched, ring, y_state, y, d_xt, d_skip, d_zs,
                        d_za, d_p, p_seq, t0, seed, n_valid, B, L, R, S, A, tanh_embed,
                        silence_bin, mode == kModeArgmax ? kModeArgmax : kModeSample, rows,
                        stages, stage_bytes, prefetch, general ? ldd : 0, general ? ldr : 0,
                        general ? sel_src : 0};
  if (storage == kStorageBF16)
    return launch_mode<kStorageBF16, kPrec>(args, mode, smem_bytes, stream);
  if (storage == kStorageI8) return launch_mode<kStorageI8, kPrec>(args, mode, smem_bytes, stream);
  if constexpr (kPrec == kPrecExact) {
    return launch_mode<kStorageF32, kPrec>(args, mode, smem_bytes, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define NVW_STREAM_ENTRY(name, kPrec)                                                        \
  int name(NVW_STREAM_PARAMS) {                                                              \
    return stream_generate<kPrec>(embed, dil_w, rs_w, dil_s, rs_s, rs_b, out_w, out_b,       \
                                  end_w, end_b, cond, sel, sched, ring, y_state, y, d_xt,    \
                                  d_skip, d_zs, d_za, d_p, p_seq, t0, seed, n_valid, B, L,   \
                                  R, S, A, tanh_embed, silence_bin, mode, storage, rows,     \
                                  stages, stage_bytes, prefetch, smem_bytes, ldd, ldr,       \
                                  stream);                                                   \
  }

// This source is built once per precision (utils/build.py: -DNVW_PREC=0
// exact, 1 fast, 2 bf16), each library holding that precision's entry
// points, so the instances compile in parallel.
#ifndef NVW_PREC
#define NVW_PREC 0
#endif

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One entry point per precision (`ring` is bf16 for _bf16); the storage and
// the mode are run-time arguments
#if NVW_PREC == 0
NVW_STREAM_ENTRY(nvw_stream_generate, kPrecExact)
#elif NVW_PREC == 1
NVW_STREAM_ENTRY(nvw_stream_generate_fast, kPrecFast)
#elif NVW_PREC == 2
NVW_STREAM_ENTRY(nvw_stream_generate_bf16, kPrecBF16)
#endif

}  // extern "C"
