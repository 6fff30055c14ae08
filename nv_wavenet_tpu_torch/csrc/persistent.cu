// K1: the whole autoregressive WaveNet generation loop in one launch.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/persistent.py:762
// (make_persistent_generator.generate; body _kernel_body :93-431), modes
// "sample" and "argmax", with the optional last-step activation dump.  The
// exact-math library (exact_math.cuh) is inlined, as the TPU kernel inlines
// ops/exact_math.py.
//
// Design (the simple one that is right first):
//   * ONE CTA PER BATCH ROW (grid = B).  Rows never interact, so no
//     inter-CTA synchronisation exists anywhere.
//   * The CTA loops over all n_valid steps and all L layers inside the
//     launch: the TPU kernel's fori_loop becomes a loop inside the block.
//     Steps past n_valid are never executed, so the FIFO, y_state and y
//     advance only for real samples.
//   * Per-step activations live in shared memory: x [R], x_{t-d} [R], the
//     two dilated-GEMM halves [2 x 2R], h [R], skip [S], zs [A], za [A] and
//     two prefix-sum buffers [A] (a few KB).
//   * Weights (3.64 MB fp32 at the flagship geometry) are read from global
//     memory every step and stay L2-resident (50 MB L2); neighbouring
//     threads read neighbouring output columns, so every load is coalesced.
//   * The dilation FIFOs live in global memory as [ring_size, B, R] (layer l,
//     absolute step t: slot offs[l] + (t & (d_l - 1))); each CTA touches only
//     its own row.  t is absolute, so chunked calls equal one call.  offs and
//     d come from the caller (sched = [ring_offsets | dilations] of
//     config.py), so the layout is decided in one place.
//   * Each thread computes whole output columns with a fixed-order dot
//     product (k = 0, 1, ...): results are deterministic run to run.  The
//     two halves of the split dilated GEMM (x_{t-d} Wprev and x_t Wcur) are
//     separate column tasks, so at R = 64 all 256 threads work on it.
//   * Canonical association: z = (x_{t-d} Wprev + x_t Wcur) + cond_pre
//     (cond_pre = cond + dil_b, folded by the caller); x = (res + b_res) + x;
//     skip = (skip + sk) + b_skip; relu after the last layer.
//
// What bounds it: each row's CTA re-reads all weights from L2 every step on
// one SM (L2 bandwidth and load latency per SM), along a dependent chain of
// 2L+3 matrix-vector stages, each ending in a __syncthreads; with B CTAs only
// B of the 132 SMs work.  The card-wide bound (operations at the fp32 rate
// over all SMs) is far below what this layout can reach.  Splitting a row's
// layers over a cluster of CTAs, wgmma on batched rows and TMA weight staging
// are later work.
//
// K5: the same kernel with per-row clocks and lengths (the ragged feeds of
// the serving path), the kRagged instance below.  Replaces the TPU kernel's
// ragged=True variant (nv_wavenet_tpu/ops/persistent.py:762, per-row
// validity :109-118, 252-256, 302-311, 410-416), mode "sample" without the
// dump.  Each CTA reads its own row's absolute clock t0_row[b] and length
// n_valid_row[b] once, before the step loop, and runs exactly that many
// steps: a dead row is simply a CTA that has stopped, so its FIFO and
// y_state stay as they were and its y stays at the zeros the wrapper
// allocated.  Because each CTA addresses only its own row of the ring by
// its own absolute clock, the stored ring keeps the absolute convention
// and the TPU's two per-row phase rotations around the call
// (rotate_ring_phase, persistent.py:785-820, needed there because one ring
// phase is shared by the batch) have no counterpart.  It is bounded as K1
// is, over the live row-steps only.  It is a separate instance with its own
// entry point so that the lockstep instance (K1) compiles exactly as it did
// without it: K1's time has moved 1.77x from a change to one loop-carried
// pair, and the per-row loads stay out of it.
//
// K2: the forced-mode instance (kSel = kSelForced).  Replaces the TPU
// kernel's mode="forced" (nv_wavenet_tpu/ops/persistent.py:762; :139-146,
// 387-400, 692-694, 721-722): the sel stream carries the symbols to emit as
// exact small-integer floats, the chain consumes them, and every step writes
// the normalised distribution p_seq[j, b, :] = em_exp(za - max) / cum[A-1],
// exactly as the dump's p.  The extra output is 1 KB per row-step at A=256,
// written once, so K2 is bounded as K1 is (the per-row latency chain).
//
// K3: the PRNG-mode instance (kSel = kSelPrng).  Replaces the TPU kernel's
// mode="prng" (prng_uniform_sel, :74-83, 404-405): each step's uniform is
// drawn on the card from Philox4x32-10 with counter (t_lo, t_hi, row, 0) and
// key (seed_lo, seed_hi), word 0's top 24 bits times 2^-24, the mapping of
// the TPU kernel.  It cannot give the TPU's hardware bits; keyed on the
// absolute clock and the row, its draws do not depend on chunking, and seed
// s at t+1 is not seed s+1 at t (the TPU kernel seeds with seed + t).  Every
// thread computes the ten rounds itself (integer work beside K1's chain), so
// the draw needs no broadcast.  The plain version computes the same words
// (ops/scan_generate.py::prng_uniform_sel).
//
// The selector source is a compile-time parameter, as kRagged is: K1 and K5
// are the kSelInjected instances and compile exactly as they did before K2
// and K3 existed (K1's time has moved 1.77x from a change to one
// loop-carried pair, so no mode becomes a runtime branch inside it).
//
// The precision is a compile-time parameter too (kPrec, step_common.cuh),
// the TPU kernel's fast_math (`:553, 589-591`) and compute_dtype (`:550`,
// casts `:221-222, 268-280, 313-347, 367-369`): kPrecFast rounds every
// activation entering a product to bf16 where the TPU kernel casts it
// (x_{t-d} as it is read, x, h, relu(skip), zs) and keeps x and the ring
// fp32, so the product x_t Wcur reads a rounded copy of x (R more floats of
// shared memory); kPrecBF16 also stores x rounded (after the embedding's
// tanh and after each residual add, done in fp32) and keeps the ring as
// bf16.  The weights arrive rounded from the wrapper, the biases and
// cond_pre do not (they are added, not multiplied).  The dumps read skip and
// zs before their rounding, and xt as stored: what the TPU kernel dumps.  A
// bf16 x bf16 product is exact in fp32, so the low-precision instances sum
// in K1's order and equal K4's bit for bit.  Each precision is an instance
// with its own entry point; the exact code stays in `if constexpr`
// branches, so the kPrecExact instances compile as they did before the
// other precisions existed.
//
// Compiled with -fmad=false (utils/build.py) so the inlined exact math and
// every a*b+c here round twice, as in the plain torch version.

#include <cuda_runtime.h>

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
  const long long* t0_row;   // [B] K5 only: each row's absolute clock
  const int* n_valid_row;    // [B] K5 only: each row's steps (<= T)
  float* p_seq;              // [T, B, A] K2 only: per-step distributions
  unsigned long long seed;   // K3 only: the Philox key
};

template <int kSel>
__device__ __forceinline__ float dot(const float* v, const float* __restrict__ w, int K,
                                     int stride) {
  return kSel == kSelInjected ? dot_column(v, w, K, stride) : dot_column_batched(v, w, K, stride);
}

template <bool kRagged, int kSel, int kPrec>
__global__ void __launch_bounds__(kThreads) persistent_generate_kernel(const GenArgs a) {
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
  const long long t0 = kRagged ? a.t0_row[b] : a.t0;
  const int n_valid = kRagged ? a.n_valid_row[b] : a.n_valid;

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
        zh[q] = dot<kSel>(cur ? xop : xp, W + (size_t)cur * R * R2 + (q - cur * R2), R, R2);
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
        const float acc = dot<kSel>(h, Wrs + o, R, RS);
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
      const float v = fmaxf(dot<kSel>(skip, a.out_w + o, S, A) + __ldg(a.out_b + o), 0.0f);
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
      za[o] = dot<kSel>(zs, a.end_w + o, A, A) + __ldg(a.end_b + o);
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
        // p = e / sum: a tolerance-governed output (sampling never divides)
        const float total = cum[A - 1];
        for (int i = tid; i < A; i += nt) {
          if constexpr (kPrec == kPrecExact) a.d_zs[(size_t)b * A + i] = zs[i];
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if (kSel == kSelForced) {
        // the dump's p, for every step: p_seq[j, b, :]
        const float total = cum[A - 1];
        float* p = a.p_seq + ((size_t)j * B + b) * A;
        for (int i = tid; i < A; i += nt) p[i] = nvw::em_exp(za[i] - zmax) / total;
        y = (int)__ldg(a.sel + (size_t)j * B + b);
      } else if (a.mode == kModeArgmax) {
        y = nvw::block_argmax(za, A);
      } else {
        const float u = kSel == kSelPrng ? philox_uniform(a.seed, t, b)
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

template <bool kRagged, int kSel, int kPrec>
int launch(const GenArgs& args, void* stream) {
  const size_t smem = (size_t)(7 * args.R + args.S + 4 * args.A +
                               (kPrec == kPrecFast ? args.R : 0)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(persistent_generate_kernel<kRagged, kSel, kPrec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  persistent_generate_kernel<kRagged, kSel, kPrec>
      <<<args.B, kThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per (instance, precision): the exact one under the name it
// always had, the others with the suffix _fast or _bf16.  `ring` is the
// ring's pointer whatever its element type (bf16 for _bf16).

// K1: sel carries uniforms; mode 0 sample, 1 argmax; the dump pointers are
// all null when off
#define NVW_GENERATE_ENTRY(name, kPrec)                                                       \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,  \
           int* y, float* d_xt, float* d_skip, float* d_zs, float* d_za, float* d_p,          \
           long long t0, int n_valid, int B, int L, int R, int S, int A, int tanh_embed,      \
           int silence_bin, int mode, void* stream) {                                         \
    const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,           \
                       sel, sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, t0,      \
                       n_valid, B, L, R, S, A, tanh_embed, silence_bin, mode,                \
                       nullptr, nullptr, nullptr, 0};                                        \
    return launch<false, kSelInjected, kPrec>(args, stream);                                  \
  }

// K5: mode "sample", no dump; t0_row [B] and n_valid_row [B] on the device
#define NVW_RAGGED_ENTRY(name, kPrec)                                                         \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,  \
           int* y, const long long* t0_row, const int* n_valid_row, int B, int L, int R,      \
           int S, int A, int tanh_embed, int silence_bin, void* stream) {                     \
    const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,           \
                       sel, sched, ring, y_state, y, nullptr, nullptr, nullptr, nullptr,     \
                       nullptr, 0, 0, B, L, R, S, A, tanh_embed, silence_bin, kModeSample,   \
                       t0_row, n_valid_row, nullptr, 0};                                     \
    return launch<true, kSelInjected, kPrec>(args, stream);                                   \
  }

// K2: sel carries the symbols; p_seq [T, B, A] gets every run step's
// distribution (the wrapper zeroes it, so steps past n_valid stay 0)
#define NVW_FORCED_ENTRY(name, kPrec)                                                         \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const float* sel, const int* sched, float* ring, int* y_state,  \
           int* y, float* d_xt, float* d_skip, float* d_zs, float* d_za, float* d_p,          \
           float* p_seq, long long t0, int n_valid, int B, int L, int R, int S, int A,        \
           int tanh_embed, int silence_bin, void* stream) {                                   \
    const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,           \
                       sel, sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, t0,      \
                       n_valid, B, L, R, S, A, tanh_embed, silence_bin, kModeSample,         \
                       nullptr, nullptr, p_seq, 0};                                          \
    return launch<false, kSelForced, kPrec>(args, stream);                                    \
  }

// K3: the selectors come from Philox keyed on `seed`; no sel input
#define NVW_PRNG_ENTRY(name, kPrec)                                                           \
  int name(const float* embed, const float* dil_w, const float* rs_w, const float* rs_b,      \
           const float* out_w, const float* out_b, const float* end_w, const float* end_b,    \
           const float* cond, const int* sched, float* ring, int* y_state, int* y,            \
           float* d_xt, float* d_skip, float* d_zs, float* d_za, float* d_p, long long t0,    \
           int n_valid, int B, int L, int R, int S, int A, int tanh_embed, int silence_bin,   \
           unsigned long long seed, void* stream) {                                           \
    const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,           \
                       nullptr, sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, t0,  \
                       n_valid, B, L, R, S, A, tanh_embed, silence_bin, kModeSample,         \
                       nullptr, nullptr, nullptr, seed};                                     \
    return launch<false, kSelPrng, kPrec>(args, stream);                                      \
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
NVW_GENERATE_ENTRY(nvw_persistent_generate, kPrecExact)
NVW_RAGGED_ENTRY(nvw_persistent_generate_ragged, kPrecExact)
NVW_FORCED_ENTRY(nvw_persistent_generate_forced, kPrecExact)
NVW_PRNG_ENTRY(nvw_persistent_generate_prng, kPrecExact)
#elif NVW_PREC == 1
NVW_GENERATE_ENTRY(nvw_persistent_generate_fast, kPrecFast)
NVW_RAGGED_ENTRY(nvw_persistent_generate_ragged_fast, kPrecFast)
NVW_FORCED_ENTRY(nvw_persistent_generate_forced_fast, kPrecFast)
NVW_PRNG_ENTRY(nvw_persistent_generate_prng_fast, kPrecFast)
#elif NVW_PREC == 2
NVW_GENERATE_ENTRY(nvw_persistent_generate_bf16, kPrecBF16)
NVW_RAGGED_ENTRY(nvw_persistent_generate_ragged_bf16, kPrecBF16)
NVW_FORCED_ENTRY(nvw_persistent_generate_forced_bf16, kPrecBF16)
NVW_PRNG_ENTRY(nvw_persistent_generate_prng_bf16, kPrecBF16)
#endif

}  // extern "C"
