// K1 and K5 for the geometries the staged kernel (staged_generate.cu) cannot
// hold (fault F2 of ROADMAP.md), and K2 and K3 where the first K4
// (stream_generate.cu) cannot hold them either.
// ops/persistent.py::generation_route sends a call here where
// ops/persistent.py::staged_plan raises: more output columns than its
// threads take (A = 2048 at R = 64), more than 4 prev columns a thread
// (R = 512), or an odd R under bf16 (its FIFO copy takes 4 bytes); modes
// forced and prng only where stream_plan raises too (two stages of one
// weight row do not fit beside the activations: R = 4096, for example).
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762
// (make_persistent_generator.generate; body _kernel_body :93-431) in modes
// "sample" and "argmax" with the optional last-step dump (K1), with
// ragged=True (:109-118, 252-256, 302-311, 410-416), per-row clocks and
// lengths (K5), in mode "forced" (:139-146, 387-400, 692-694: the symbols
// in sel, every step's distribution written to p_seq, K2) and in mode
// "prng" (prng_uniform_sel, :74-83, 404-405: the selectors drawn from
// Philox4x32-10 on the card, philox_uniform, K3), at any width the
// reference generates.
//
// It is the first K1 design (persistent.cu at commit 14b57bc); the
// selector source (kSel, step_common.cuh) and K5's rows are compile-time:
//   * ONE CTA PER BATCH ROW (grid = B), 256 threads, the whole call in one
//     launch; steps past n_valid (a row's length under K5) never run.
//   * The activations in (7R + S + 4A) floats of shared memory (R more under
//     fast for the rounded copy of x), so no width limit beyond that.
//   * Every product's columns looped over the 256 threads, each column a
//     fixed-order dot product (dot_column: k = 0, 1, ..., K-1 from 0.0f, one
//     rounded FMUL and FADD per term; K2/K3 load eight terms ahead), the
//     weights read from L2 every step.
//   * The FIFO in device memory, [ring_size, B, R], each CTA its own row;
//     the bf16 ring read and written one element at a time, so any R.
//   * The precisions (kPrec, step_common.cuh) round where the staged K1's
//     do, so the two equal each other and the plain version bit for bit.
//
// What bounds it: each row's CTA re-reads every weight from L2 every step
// on one SM, along a dependent chain of 2L + 3 products with a
// __syncthreads each (185 us a flagship step on an H100, PERF.md).
// It serves only the geometries the other kernels reject.
//
// Compiled with -fmad=false (utils/build.py), once per precision.

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "exact_math.cuh"
#include "step_common.cuh"

namespace {

using namespace nvw;

constexpr int kThreads = 256;

struct GenArgs {
  const float* embed;   // [2A, R]
  const float* dil_w;   // [L, 2R, 2R]
  const float* rs_w;    // [L, R, R+S]
  const float* rs_b;    // [L, R+S]
  const float* out_w;   // [S, A]
  const float* out_b;   // [A]
  const float* end_w;   // [A, A]
  const float* end_b;   // [A]
  const float* cond;    // [T, L, B, 2R], dil_b already added
  const float* sel;     // [T, B]
  const int* sched;     // [2, L]: ring_offsets, then dilations
  float* ring;          // [ring_size, B, R], updated in place (bf16 under kPrecBF16)
  int* y_state;         // [2, B] (y_prev, y_cur), updated in place
  int* y;               // [T, B]
  float* d_xt;          // [L, B, R]  } last-step dump, all null when off
  float* d_skip;        // [L, B, S]  }
  float* d_zs;          // [B, A]     }
  float* d_za;          // [B, A]     }
  float* d_p;           // [B, A]     }
  long long t0;         // absolute index of the call's first step
  int n_valid;          // steps to run (<= T)
  int B, L, R, S, A;
  int tanh_embed;
  int silence_bin;
  int mode;
  int T;                // K5 only: y's steps (it writes 0 past a row's length)
};

// K2's and K3's own fields
struct GenScoreArgs : GenArgs {
  float* p_seq;              // [T, B, A] K2: every run step's distribution
  unsigned long long seed;   // K3: the Philox key
};

// K5's rows by value in the launch's parameters, kRaggedRows a launch
// (staged_generate.cu's RaggedArgs)
constexpr int kRaggedRows = 256;

struct GenRaggedArgs : GenArgs {
  long long t0_row[kRaggedRows];   // the group's row i's absolute clock
  int n_valid_row[kRaggedRows];    // the group's row i's steps (<= T)
};
static_assert(sizeof(GenRaggedArgs) <= 4096, "K5's parameters past 4 KB");

template <bool kRagged, int kSel>
using GenKernelArgs =
    std::conditional_t<kRagged, GenRaggedArgs,
                       std::conditional_t<kSel == kSelInjected, GenArgs, GenScoreArgs>>;

// A column's product in dot_column's order: K1/K5 with dot_column, K2/K3
// with its eight loads in flight (dot_column_batched; with dot_column the
// first K2 ran 1.6x slower, PERF.md)
template <int kSel>
__device__ __forceinline__ float column_dot(const float* v, const float* __restrict__ w,
                                            int K, int stride) {
  if constexpr (kSel == kSelInjected) {
    return dot_column(v, w, K, stride);
  } else {
    return dot_column_batched(v, w, K, stride);
  }
}

// the clock and the steps of the launch's i-th CTA
__device__ __forceinline__ long long row_clock(const GenArgs& a, int) { return a.t0; }
// through an opaque move, as staged_generate.cu's K5 reads them
__device__ __forceinline__ long long row_clock(const GenRaggedArgs& a, int i) {
  long long t = a.t0_row[i];
  asm volatile("mov.b64 %0, %0;" : "+l"(t));
  return t;
}
__device__ __forceinline__ int row_steps(const GenArgs& a, int) { return a.n_valid; }
__device__ __forceinline__ int row_steps(const GenRaggedArgs& a, int i) {
  int n = a.n_valid_row[i];
  asm volatile("mov.b32 %0, %0;" : "+r"(n));
  return n;
}

template <bool kRagged, int kSel, int kPrec>
__global__ void __launch_bounds__(kThreads)
    generic_generate_kernel(const __grid_constant__ GenKernelArgs<kRagged, kSel> a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int B = a.B, L = a.L, R = a.R, S = a.S, A = a.A;
  const int R2 = 2 * R, RS = R + S;
  float* x = smem;         // [R]   layer input / residual stream
  float* xp = x + R;       // [R]   x_{t-d} read from the FIFO
  float* zh = xp + R;      // [4R]  dilated GEMM halves: [x_{t-d} Wprev | x_t Wcur]
  float* h = zh + 2 * R2;  // [R]   gate
  float* skip = h + R;     // [S]
  float* zs = skip + S;    // [A]
  float* za = zs + A;      // [A]
  float* c0 = za + A;      // [A]   prefix-sum ping-pong buffers
  float* c1 = c0 + A;      // [A]
  // [R] x as the operand of x_t Wcur: a rounded copy under kPrecFast (x
  // stays fp32 for the residual adds); x itself otherwise
  float* xop = kPrec == kPrecFast ? c1 + A : x;

  int y_prev = a.y_state[b];
  int y_cur = a.y_state[B + b];
  const long long t0 = row_clock(a, b);
  const int n_valid = row_steps(a, b);
  if constexpr (kRagged) {
    // y comes uninitialised: the row's steps past its length read 0
    for (int j = n_valid + tid; j < a.T; j += nt) a.y[(size_t)j * B + b] = 0;
  }

  for (int j = 0; j < n_valid; ++j) {
    const long long t = t0 + j;
    const bool dump = a.d_xt != nullptr && j == n_valid - 1;

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
      // FIFO: read x_{t-d} and write x_t in the same slot (same thread per
      // element, so the read always precedes the write)
      const int offset = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      if constexpr (kPrec == kPrecExact) {
        float* slot = a.ring + ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R;
        for (int i = tid; i < R; i += nt) {
          xp[i] = slot[i];
          slot[i] = x[i];
        }
      } else {
        const size_t slot = ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R;
        for (int i = tid; i < R; i += nt) {
          xp[i] = operand<kPrec>(ring_get<kPrec>(a.ring, slot + i));
          ring_put<kPrec>(a.ring, slot + i, x[i]);
        }
      }
      __syncthreads();

      // split dilated GEMM: task q < 2R is column q of x_{t-d} Wprev (rows
      // [0, R) of dil_w), task q >= 2R column q - 2R of x_t Wcur (rows [R, 2R))
      const float* W = a.dil_w + (size_t)l * R2 * R2;
      for (int q = tid; q < 2 * R2; q += nt) {
        const int cur = q >= R2;
        zh[q] = column_dot<kSel>(cur ? xop : xp, W + (size_t)cur * R * R2 + (q - cur * R2), R,
                                 R2);
      }
      __syncthreads();

      // z = (zp + zc) + cond_pre; gate h = tanh(z[:R]) * sigmoid(z[R:])
      const float* cond = a.cond + (((size_t)j * L + l) * B + b) * R2;
      for (int i = tid; i < R; i += nt) {
        const float zt = (zh[i] + zh[R2 + i]) + __ldg(cond + i);
        const float zg = (zh[R + i] + zh[R2 + R + i]) + __ldg(cond + R + i);
        h[i] = operand<kPrec>(nvw::em_tanh(zt) * nvw::em_sigmoid(zg));
      }
      __syncthreads();

      // fused residual + skip GEMM: [R | S] output columns
      const float* Wrs = a.rs_w + (size_t)l * R * RS;
      const float* brs = a.rs_b + (size_t)l * RS;
      for (int o = tid; o < RS; o += nt) {
        const float acc = column_dot<kSel>(h, Wrs + o, R, RS);
        if (o < R) {
          const float v = (acc + __ldg(brs + o)) + x[o];
          x[o] = stored<kPrec>(v);
          if constexpr (kPrec == kPrecFast) xop[o] = operand<kPrec>(v);
        } else {
          skip[o - R] = (skip[o - R] + acc) + __ldg(brs + o);
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
          fmaxf(column_dot<kSel>(skip, a.out_w + o, S, A) + __ldg(a.out_b + o), 0.0f);
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
      za[o] = column_dot<kSel>(zs, a.end_w + o, A, A) + __ldg(a.end_b + o);
    }
    __syncthreads();

    int y;
    if (kSel == kSelInjected && a.mode == kModeArgmax && !dump) {
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
        // p = e / sum: a tolerance-governed output (sampling never divides)
        const float total = cum[A - 1];
        for (int i = tid; i < A; i += nt) {
          if constexpr (kPrec == kPrecExact) a.d_zs[(size_t)b * A + i] = zs[i];
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if constexpr (kSel == kSelForced) {
        // the dump's p, for every step: p_seq[j, b, :]
        const float total = cum[A - 1];
        float* p = a.p_seq + ((size_t)j * B + b) * A;
        for (int i = tid; i < A; i += nt) p[i] = nvw::em_exp(za[i] - zmax) / total;
        y = (int)__ldg(a.sel + (size_t)j * B + b);
      } else if (kSel == kSelInjected && a.mode == kModeArgmax) {
        y = nvw::block_argmax(za, A);
      } else {
        float u;
        if constexpr (kSel == kSelPrng) {
          u = philox_uniform(a.seed, t, b);
        } else {
          u = __ldg(a.sel + (size_t)j * B + b);
        }
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

constexpr int kMaxDevices = 64;

// `rows` CTAs.  The shared-memory attribute is set once per
// instance and device (and again only for larger activations).
template <bool kRagged, int kSel, int kPrec>
int launch(const GenKernelArgs<kRagged, kSel>& args, int rows, void* stream) {
  const int smem = (7 * args.R + args.S + 4 * args.A + (kPrec == kPrecFast ? args.R : 0)) *
                   (int)sizeof(float);
  static std::atomic<int> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || granted[dev].load() < smem)) {
    err = cudaFuncSetAttribute(generic_generate_kernel<kRagged, kSel, kPrec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) granted[dev].store(smem);
  }
  generic_generate_kernel<kRagged, kSel, kPrec><<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}

// K5: the rows' clocks and lengths, host arrays, copied into the launch's
// parameters, kRaggedRows rows a launch
template <int kPrec>
int launch_ragged(GenRaggedArgs& args, const long long* t0_row, const int* n_valid_row,
                  void* stream) {
  const GenRaggedArgs first = args;
  const size_t ring_row = (size_t)args.R * (kPrec == kPrecBF16 ? 2 : 4);
  for (int r0 = 0; r0 < args.B; r0 += kRaggedRows) {
    const int rows = args.B - r0 < kRaggedRows ? args.B - r0 : kRaggedRows;
    // the group's first row: B stays the stride
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
    const int err = launch<true, kSelInjected, kPrec>(args, rows, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// One entry point per (instance, precision), the low precisions with the
// suffix _fast or _bf16.  `ring` is the ring's pointer whatever its element
// type (bf16 for _bf16).

// K1, K2 and K3 (generic): mode 0 sample and 1 argmax (sel carries
// uniforms), 2 forced (sel carries the symbols; p_seq [T, B, A] gets every
// run step's distribution, the wrapper zeroes it, so steps past n_valid
// stay 0), 3 prng (the selectors from Philox keyed on `seed`, sel not
// read); the dump pointers are all null when off
#define NVW_GENERATE_ENTRY(name, kPrec)                                                       \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,  \
           int* y, float* d_xt, float* d_skip, float* d_zs, float* d_za, float* d_p,          \
           float* p_seq, long long t0, unsigned long long seed, int n_valid, int B, int L,    \
           int R, int S, int A, int tanh_embed, int silence_bin, int mode, void* stream) {    \
    const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,           \
                       sel, sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, t0,      \
                       n_valid, B, L, R, S, A, tanh_embed, silence_bin, mode, 0};            \
    if (mode == kModeForced) {                                                                \
      return launch<false, kSelForced, kPrec>(GenScoreArgs{args, p_seq, 0}, B, stream);      \
    }                                                                                         \
    if (mode == kModePrng) {                                                                  \
      return launch<false, kSelPrng, kPrec>(GenScoreArgs{args, nullptr, seed}, B, stream);   \
    }                                                                                         \
    return launch<false, kSelInjected, kPrec>(args, B, stream);                               \
  }

// K5 (generic): mode "sample", no dump; t0_row [B] and n_valid_row [B] are
// host arrays (read before the call returns); y [T, B] need not be zeroed
#define NVW_RAGGED_ENTRY(name, kPrec)                                                         \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,  \
           int* y, const long long* t0_row, const int* n_valid_row, int T, int B, int L,      \
           int R, int S, int A, int tanh_embed, int silence_bin, void* stream) {              \
    GenRaggedArgs args{{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond, sel,     \
                        sched, ring, y_state, y, nullptr, nullptr, nullptr, nullptr, nullptr,\
                        0, 0, B, L, R, S, A, tanh_embed, silence_bin, kModeSample, T}};      \
    return launch_ragged<kPrec>(args, t0_row, n_valid_row, stream);                           \
  }

// This source is built once per precision (utils/build.py: -DNVW_PREC=0
// exact, 1 fast, 2 bf16), each library holding that precision's entry
// points, so the instances compile in parallel.
#ifndef NVW_PREC
#define NVW_PREC 0
#endif

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

#if NVW_PREC == 0
NVW_GENERATE_ENTRY(nvw_generic_generate, kPrecExact)
NVW_RAGGED_ENTRY(nvw_generic_generate_ragged, kPrecExact)
#elif NVW_PREC == 1
NVW_GENERATE_ENTRY(nvw_generic_generate_fast, kPrecFast)
NVW_RAGGED_ENTRY(nvw_generic_generate_ragged_fast, kPrecFast)
#elif NVW_PREC == 2
NVW_GENERATE_ENTRY(nvw_generic_generate_bf16, kPrecBF16)
NVW_RAGGED_ENTRY(nvw_generic_generate_ragged_bf16, kPrecBF16)
#endif

}  // extern "C"
