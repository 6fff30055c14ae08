// The first K6: the collapsed-chain ("fused") generation loop in one
// launch, one CTA per batch row.  Since the cluster K6 (fused_chain.cu) it
// runs only where that kernel's plan cannot hold the geometry
// (ops/fused_chain.py::fused_route), with a note; its code is unchanged.
//
// Replaces the TPU kernel nv_wavenet_tpu/ops/fused_chain.py:414
// (make_fused_generator.generate; body _kernel_body :118-253), modes sample
// and argmax (kSelInjected, chosen at run time), forced (p_seq) and prng
// (Philox on the card), each in three precisions (kPrec, step_common.cuh:
// fp32, fast_math, compute_dtype=bfloat16): 9 instances, one entry point
// each.  What it computes (ops/fused_chain.py): the residual
// stream is folded into the weights, so layer l's pre-activation is
//   u_l = ((x_0 Wcur_l + x_{t-d} Wprev_l) + fbias_l) + cond_l
//         + [h_0 .. h_{l-1}] G_l,        G_l = [Wres_j Wcur_l]_{j<l},
// the skip sum is one product over all gate outputs, and the residual stream
// x_l = (x_{l-1} + h_{l-1} Wres_{l-1}) + bres_{l-1} is built off the chain
// for the FIFO writes.  The gate and the sampler are the exact math of
// exact_math.cuh, as in the TPU kernel.
//
// Design (the simple one that is right first):
//   * ONE CTA PER BATCH ROW, 256 threads, every step of the call inside the
//     launch, the FIFO ring in device memory addressed by the absolute clock
//     (K1's layout and state format), so a fused run hands its ring and
//     y_state to K1/K5 as they are.
//   * One row's activations live in shared memory: x_0 and its operand copy
//     [2R], the L FIFO reads [L*R], u [L*2R], the gate outputs [L*R], skip,
//     zs, za, two prefix buffers, and the split products' partial sums
//     (~30 KB at the flagship widths, ~92 KB at 40 layers and R = 128; the
//     wrapper's plan ops/fused_chain.py::fused_plan).  Weights are read from
//     device memory (L2-resident: 9.6 MB of fp32 per row-step at the
//     flagship, 6.2 MB of it the G stack).
//   * A step reads all L FIFO slots first, then computes every layer's
//     off-chain part of u in one phase, then walks the chain: per layer one
//     product over the earlier gates (K = l*R terms) and the gate, two
//     barriers.  Then the skip product and the L-1 residual products in one
//     phase, the skip bias, the residual stream and the FIFO writes in the
//     next, the output stack and the sampler.
//   * Products: a thread owns four adjacent output columns (one 16-byte load
//     per weight row, neighbouring threads on neighbouring columns) and loads
//     eight rows before their products.  Where there are fewer column groups
//     than threads, a product's K terms split into contiguous ranges of whole
//     8-row batches, one per thread set; each range sums from 0 in k order
//     with fused multiply-adds, and the reader adds the ranges in order
//     p = 0, 1, ... .  This order is not the plain version's (cuBLAS or the
//     CPU's): K6 is governed by the TV contract, held to its plain version
//     within tolerance, not bit for bit.  The G and skip products skip the
//     zero pad rows of g_pack and wskip_cat (blocks of R rows at stride P):
//     a zero row adds an exact 0 to an ordered sum.
//   * fast_math (kPrecFast) is the TPU's single-pass DEFAULT matrix
//     precision: the activations are rounded to bf16 (__float2bfloat16_rn)
//     as they are stored for a product, the weights arrive rounded, the
//     products and sums stay fp32.  A product of two bf16 values is exact in
//     fp32, so the fused multiply-add rounds as the separate multiply and add
//     would.  Biases and the residual stream stay fp32; the exact math stays
//     exact.  compute_dtype=bfloat16 (kPrecBF16, the TPU kernel's `:166-241`)
//     rounds the same operands and also stores the residual stream rounded:
//     x_0 after the tanh and x_l after each residual add (done in fp32), and
//     the FIFO ring holds bf16.
//
// What bounds it: the chain of 2L dependent phases on one SM per row, each
// product's weight loads from L2 (the G stack alone is 2.8x the bytes K1
// reads per row-step) and its dependent adds.  The card-wide bound
// (operations over the fp32 rate of all SMs; under fast_math the products
// over the bf16 tensor-core rate) is far below what one CTA per row
// reaches.  TMA staging of g_pack and tensor-core products over batched
// rows are later work.
//
// Compiled with -fmad=false (utils/build.py) like the other sources, so the
// exact math rounds as its twins; the products use __fmaf_rn explicitly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exact_math.cuh"
#include "step_common.cuh"

namespace {

using namespace nvw;

constexpr int kThreads = 256;
constexpr int kBatch = 8;   // weight rows loaded before their products

struct FusedArgs {
  const float* embed;      // [2A, R]
  const float* wprev;      // [L, R, 2R]
  const float* wres;       // [L, R, R]
  const float* bres;       // [L, R]
  const float* g_pack;     // [P * L(L-1)/2, 2R]: Wres_j Wcur_l (j < l), P rows a block
  const float* wcur_cat;   // [R, L * 2R]
  const float* wskip_cat;  // [L * P, S]
  const float* fbias;      // [L, 2R]
  const float* skipb;      // [S]
  const float* out_w;      // [S, A]
  const float* out_b;      // [A]
  const float* end_w;      // [A, A]
  const float* end_b;      // [A]
  const float* cond;       // [T, L, B, 2R]
  const float* sel;        // [T, B] (null in mode prng)
  const int* sched;        // [2, L]: ring_offsets, then dilations
  float* ring;             // [ring_size, B, R], updated in place (bf16 under kPrecBF16)
  int* y_state;            // [2, B] (y_prev, y_cur), updated in place
  int* y;                  // [T, B]
  float* p_seq;            // [T, B, A], forced only
  long long t0;            // absolute index of the call's first step
  int n_valid;             // steps to run (<= T)
  int B, L, R, S, A, P;    // P: rows of a layer's block in g_pack and wskip_cat
  int tanh_embed;
  int silence_bin;
  int mode;                // kModeSample or kModeArgmax (kSelInjected)
  unsigned long long seed; // the Philox key (prng only)
};

// acc += v[0, K) . w[k * ldw + 0..3], k = 0, 1, ..., K-1 in order (K a
// multiple of kBatch), the rows of a batch loaded before their products
__device__ __forceinline__ void dot4(const float* v, const float* __restrict__ w, int ldw, int K,
                                     float4& acc) {
  for (int k = 0; k < K; k += kBatch) {
    float4 wk[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      wk[q] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k + q) * ldw));
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const float a = v[k + q];
      acc.x = __fmaf_rn(a, wk[q].x, acc.x);
      acc.y = __fmaf_rn(a, wk[q].y, acc.y);
      acc.z = __fmaf_rn(a, wk[q].z, acc.z);
      acc.w = __fmaf_rn(a, wk[q].w, acc.w);
    }
  }
}

// K ranges of a product with N output columns (ops/fused_chain.py::_splits)
__host__ __device__ __forceinline__ int split_count(int N) {
  const int groups = N / 4;
  return groups >= kThreads ? 1 : kThreads / groups;
}

// The K terms v[k] W[row(k), c], row(k) = (k / R) * P + k % R (blocks of R
// rows at stride P), of every column c in [0, N), in split_count(N)
// contiguous ranges of whole batches: part[p * N + c] is range p's sum.
// Callers sync, then add the ranges in order (sum_parts).
__device__ __forceinline__ void block_matvec_parts(const float* v, const float* __restrict__ W,
                                                   int ldw, int N, int K, int R, int P,
                                                   float* part) {
  const int groups = N / 4, splits = split_count(N);
  const int batches = K / kBatch, per = (batches + splits - 1) / splits;
  for (int task = threadIdx.x; task < groups * splits; task += kThreads) {
    const int p = task / groups, c = (task - p * groups) * 4;
    const int end = min(batches, (p + 1) * per);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int bt = p * per; bt < end; ++bt) {
      const int k = bt * kBatch;
      dot4(v + k, W + (size_t)((k / R) * P + k % R) * ldw + c, ldw, kBatch, acc);
    }
    *reinterpret_cast<float4*>(part + (size_t)p * N + c) = acc;
  }
}

__device__ __forceinline__ float sum_parts(const float* part, int N, int splits, int c) {
  float s = part[c];
  for (int p = 1; p < splits; ++p) s = s + part[(size_t)p * N + c];
  return s;
}

// floats of one row's activations (ops/fused_chain.py::fused_plan)
int smem_floats(int L, int R, int S, int A) {
  const int n[3] = {2 * R, S, A};
  int part = 0;
  for (int i = 0; i < 3; ++i) {
    const int f = split_count(n[i]) * n[i];
    part = f > part ? f : part;
  }
  return 2 * R + 4 * L * R + S + 4 * A + part;
}

template <int kSel, int kPrec>
__global__ void __launch_bounds__(kThreads) fused_generate_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int B = a.B, L = a.L, R = a.R, S = a.S, A = a.A, P = a.P;
  const int R2 = 2 * R, LR2 = L * R2;
  float* x0 = smem;             // [R]     the embedding: the residual stream's start
  float* xop = x0 + R;          // [R]     x0 as a product operand
  float* xp = xop + R;          // [L*R]   the FIFO reads as operands; then h_l Wres_l
  float* u = xp + L * R;        // [L*2R]  pre-activations
  float* hbuf = u + LR2;        // [L*R]   gate outputs as operands, without the pad
  float* skip = hbuf + L * R;   // [S]
  float* zs = skip + S;         // [A]
  float* za = zs + A;           // [A]
  float* c0 = za + A;           // [A]     prefix-sum ping-pong buffers
  float* c1 = c0 + A;           // [A]
  float* part = c1 + A;         // the split products' partial sums
  const int sg = split_count(R2), ss = split_count(S), sa = split_count(A);

  int y_prev = a.y_state[b];
  int y_cur = a.y_state[B + b];
  for (int j = 0; j < a.n_valid; ++j) {
    const long long t = a.t0 + j;

    // the embedding (exact tanh) and all L FIFO reads, before any write of
    // the step
    for (int i = tid; i < R; i += kThreads) {
      const float v = __ldg(a.embed + (size_t)y_prev * R + i) +
                      __ldg(a.embed + (size_t)(A + y_cur) * R + i);
      const float x = a.tanh_embed ? em_tanh(v) : v;
      x0[i] = stored<kPrec>(x);
      xop[i] = operand<kPrec>(x);
    }
    for (int e = tid; e < L * R; e += kThreads) {
      const int l = e / R, i = e - l * R;
      const int offset = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      xp[e] = operand<kPrec>(
          ring_get<kPrec>(a.ring, ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R + i));
    }
    __syncthreads();

    // off the chain, every layer: u_l = ((x0 Wcur_l + x_{t-d} Wprev_l) +
    // fbias_l) + cond_l, four columns a task
    const float* cond = a.cond + ((size_t)j * L * B + b) * R2;
    const int g2 = R2 / 4;
    for (int task = tid; task < L * g2; task += kThreads) {
      const int l = task / g2, c = (task - l * g2) * 4;
      float4 pc = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pp = pc;
      dot4(xop, a.wcur_cat + (size_t)l * R2 + c, LR2, R, pc);
      dot4(xp + l * R, a.wprev + (size_t)l * R * R2 + c, R2, R, pp);
      const float4 fb = __ldg(reinterpret_cast<const float4*>(a.fbias + (size_t)l * R2 + c));
      const float4 cd = __ldg(reinterpret_cast<const float4*>(cond + (size_t)l * B * R2 + c));
      float* o = u + l * R2 + c;
      o[0] = ((pc.x + pp.x) + fb.x) + cd.x;
      o[1] = ((pc.y + pp.y) + fb.y) + cd.y;
      o[2] = ((pc.z + pp.z) + fb.z) + cd.z;
      o[3] = ((pc.w + pp.w) + fb.w) + cd.w;
    }
    __syncthreads();

    // the chain: u_l + [h_0 .. h_{l-1}] G_l, then the gate
    for (int l = 0; l < L; ++l) {
      if (l) {
        block_matvec_parts(hbuf, a.g_pack + (size_t)P * (l * (l - 1) / 2) * R2, R2, R2, l * R,
                           R, P, part);
        __syncthreads();
      }
      for (int i = tid; i < R; i += kThreads) {
        float zt = u[l * R2 + i], zg = u[l * R2 + R + i];
        if (l) {
          zt = zt + sum_parts(part, R2, sg, i);
          zg = zg + sum_parts(part, R2, sg, R + i);
        }
        hbuf[l * R + i] = operand<kPrec>(em_tanh(zt) * em_sigmoid(zg));
      }
      __syncthreads();
    }

    // the skip product over every gate; the residual products h_l Wres_l
    // (l < L-1) into xp, whose FIFO reads are spent
    block_matvec_parts(hbuf, a.wskip_cat, S, S, L * R, R, P, part);
    const int gr = R / 4;
    for (int task = tid; task < (L - 1) * gr; task += kThreads) {
      const int l = task / gr, c = (task - l * gr) * 4;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dot4(hbuf + l * R, a.wres + (size_t)l * R * R + c, R, R, r);
      *reinterpret_cast<float4*>(xp + l * R + c) = r;
    }
    __syncthreads();

    // skip = relu(. + skipb); the residual stream and the FIFO writes
    for (int i = tid; i < S; i += kThreads)
      skip[i] = operand<kPrec>(fmaxf(sum_parts(part, S, ss, i) + __ldg(a.skipb + i), 0.0f));
    for (int i = tid; i < R; i += kThreads) {
      float x = x0[i];
      for (int l = 0; l < L; ++l) {
        if (l) {
          x = stored<kPrec>((x + xp[(l - 1) * R + i]) +
                            __ldg(a.bres + (size_t)(l - 1) * R + i));
        }
        const int offset = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
        ring_put<kPrec>(a.ring, ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R + i, x);
      }
    }
    __syncthreads();

    // output stack: zs = relu(skip Wzs + bzs); za = zs Wza + bza
    block_matvec_parts(skip, a.out_w, A, A, S, S, S, part);
    __syncthreads();
    for (int i = tid; i < A; i += kThreads)
      zs[i] = operand<kPrec>(fmaxf(sum_parts(part, A, sa, i) + __ldg(a.out_b + i), 0.0f));
    __syncthreads();
    block_matvec_parts(zs, a.end_w, A, A, A, A, A, part);
    __syncthreads();
    for (int i = tid; i < A; i += kThreads) za[i] = sum_parts(part, A, sa, i) + __ldg(a.end_b + i);
    __syncthreads();

    int y;
    if (kSel == kSelInjected && a.mode == kModeArgmax) {
      y = block_argmax(za, A);
    } else {
      // canonical softmax pieces: e = exp(za - max), fixed-tree prefix sum
      float mm = -INFINITY;
      for (int i = tid; i < A; i += kThreads) mm = fmaxf(mm, za[i]);
      const float zmax = block_max(mm);
      for (int i = tid; i < A; i += kThreads) c0[i] = em_exp(za[i] - zmax);
      __syncthreads();
      const float* cum = block_fixed_tree_cumsum(c0, c1, A);
      if (kSel == kSelForced) {
        const float total = cum[A - 1];
        float* p = a.p_seq + ((size_t)j * B + b) * A;
        for (int i = tid; i < A; i += kThreads) p[i] = em_exp(za[i] - zmax) / total;
        y = (int)__ldg(a.sel + (size_t)j * B + b);
      } else {
        const float sel = kSel == kSelPrng ? philox_uniform(a.seed, t, b)
                                           : __ldg(a.sel + (size_t)j * B + b);
        y = block_select_from_cumsum(cum, sel, A, a.silence_bin);
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

template <int kSel, int kPrec>
int launch(const FusedArgs& args, int smem_bytes, void* stream) {
  if (args.R % 8 || args.S % 8 || args.A % 8 || args.P < args.R ||
      smem_bytes < 4 * smem_floats(args.L, args.R, args.S, args.A))
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_generate_kernel<kSel, kPrec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<args.B, kThreads, smem_bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instance, all with this argument list: the 13 folded
// weights of ops/fused_chain.py::FOLDED_ORDER, the inputs and state, then
// the shape and the plan's shared memory; `ring` is bf16 for _bf16.
#define NVW_FIRST_FUSED_ENTRY(name, kSel, kPrec)                                                       \
  int name(const float* embed, const float* wprev, const float* wres, const float* bres,        \
           const float* g_pack, const float* wcur_cat, const float* wskip_cat,                  \
           const float* fbias, const float* skipb, const float* out_w, const float* out_b,      \
           const float* end_w, const float* end_b, const float* cond, const float* sel,         \
           const int* sched, float* ring, int* y_state, int* y, float* p_seq, long long t0,     \
           int n_valid, int B, int L, int R, int S, int A, int P, int tanh_embed,               \
           int silence_bin, int mode, int smem_bytes, unsigned long long seed, void* stream) { \
    const FusedArgs args{embed, wprev, wres, bres, g_pack, wcur_cat, wskip_cat, fbias,          \
                         skipb, out_w, out_b, end_w, end_b, cond, sel, sched, ring, y_state,   \
                         y, p_seq, t0, n_valid, B, L, R, S, A, P, tanh_embed, silence_bin,     \
                         mode == kModeArgmax ? kModeArgmax : kModeSample, seed};               \
    return launch<kSel, kPrec>(args, smem_bytes, stream);                                        \
  }

// This source is built once per precision (utils/build.py: -DNVW_PREC=0
// exact, 1 fast, 2 bf16), each library holding that precision's entry
// points, so the instances compile in parallel.
#ifndef NVW_PREC
#define NVW_PREC 0
#endif

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// sel: uniforms, mode 0 sample, 1 argmax; forced: sel holds the symbols to
// emit, p_seq [T, B, A] (zeroed by the wrapper); prng: selectors from Philox
// keyed on seed, sel not read
#if NVW_PREC == 0
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate, kSelInjected, kPrecExact)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_forced, kSelForced, kPrecExact)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_prng, kSelPrng, kPrecExact)
#elif NVW_PREC == 1
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_fast, kSelInjected, kPrecFast)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_forced_fast, kSelForced, kPrecFast)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_prng_fast, kSelPrng, kPrecFast)
#elif NVW_PREC == 2
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_bf16, kSelInjected, kPrecBF16)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_forced_bf16, kSelForced, kPrecBF16)
NVW_FIRST_FUSED_ENTRY(nvw_first_fused_generate_prng_bf16, kSelPrng, kPrecBF16)
#endif

}  // extern "C"
