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
// Compiled with -fmad=false (utils/build.py) so the inlined exact math and
// every a*b+c here round twice, as in the plain torch version.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kModeSample = 0;
constexpr int kModeArgmax = 1;

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
  float* ring;          // [ring_size, B, R], updated in place
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
};

// v[0, K) . w[0], w[stride], ... in the fixed order k = 0, 1, ..., K-1
__device__ __forceinline__ float dot_column(const float* v, const float* __restrict__ w,
                                            int K, int stride) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = acc + v[k] * __ldg(w + (size_t)k * stride);
  return acc;
}

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

  int y_prev = a.y_state[b];
  int y_cur = a.y_state[B + b];

  for (int j = 0; j < a.n_valid; ++j) {
    const long long t = a.t0 + j;
    const bool dump = a.d_xt != nullptr && j == a.n_valid - 1;

    // embedding: fl(embed_prev[y_prev] + embed_cur[y_cur]), then exact tanh
    for (int i = tid; i < R; i += nt) {
      const float v = __ldg(a.embed + (size_t)y_prev * R + i) +
                      __ldg(a.embed + (size_t)(A + y_cur) * R + i);
      x[i] = a.tanh_embed ? nvw::em_tanh(v) : v;
    }
    for (int i = tid; i < S; i += nt) skip[i] = 0.0f;
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // FIFO: read x_{t-d} and write x_t in the same slot (same thread per
      // element, so the read always precedes the write)
      const int offset = __ldg(a.sched + l), d = __ldg(a.sched + L + l);
      float* slot = a.ring + ((size_t)(offset + (int)(t & (d - 1))) * B + b) * R;
      for (int i = tid; i < R; i += nt) {
        xp[i] = slot[i];
        slot[i] = x[i];
      }
      __syncthreads();

      // split dilated GEMM: task q < 2R is column q of x_{t-d} Wprev (rows
      // [0, R) of dil_w), task q >= 2R column q - 2R of x_t Wcur (rows [R, 2R))
      const float* W = a.dil_w + (size_t)l * R2 * R2;
      for (int q = tid; q < 2 * R2; q += nt) {
        const int cur = q >= R2;
        zh[q] = dot_column(cur ? x : xp, W + (size_t)cur * R * R2 + (q - cur * R2), R, R2);
      }
      __syncthreads();

      // z = (zp + zc) + cond_pre; gate h = tanh(z[:R]) * sigmoid(z[R:])
      const float* cond = a.cond + (((size_t)j * L + l) * B + b) * R2;
      for (int i = tid; i < R; i += nt) {
        const float zt = (zh[i] + zh[R2 + i]) + __ldg(cond + i);
        const float zg = (zh[R + i] + zh[R2 + R + i]) + __ldg(cond + R + i);
        h[i] = nvw::em_tanh(zt) * nvw::em_sigmoid(zg);
      }
      __syncthreads();

      // fused residual + skip GEMM: [R | S] output columns
      const float* Wrs = a.rs_w + (size_t)l * R * RS;
      const float* brs = a.rs_b + (size_t)l * RS;
      for (int o = tid; o < RS; o += nt) {
        const float acc = dot_column(h, Wrs + o, R, RS);
        if (o < R) {
          x[o] = (acc + __ldg(brs + o)) + x[o];
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

    for (int i = tid; i < S; i += nt) skip[i] = fmaxf(skip[i], 0.0f);
    __syncthreads();
    if (dump) {
      for (int i = tid; i < S; i += nt) a.d_skip[((size_t)(L - 1) * B + b) * S + i] = skip[i];
    }

    // output stack: zs = relu(skip Wzs + bzs); za = zs Wza + bza
    for (int o = tid; o < A; o += nt) {
      zs[o] = fmaxf(dot_column(skip, a.out_w + o, S, A) + __ldg(a.out_b + o), 0.0f);
    }
    __syncthreads();
    for (int o = tid; o < A; o += nt) {
      za[o] = dot_column(zs, a.end_w + o, A, A) + __ldg(a.end_b + o);
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
          a.d_zs[(size_t)b * A + i] = zs[i];
          a.d_za[(size_t)b * A + i] = za[i];
          a.d_p[(size_t)b * A + i] = nvw::em_exp(za[i] - zmax) / total;
        }
      }
      if (a.mode == kModeArgmax) {
        y = nvw::block_argmax(za, A);
      } else {
        y = nvw::block_select_from_cumsum(cum, __ldg(a.sel + (size_t)j * B + b), A,
                                          a.silence_bin);
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

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int nvw_persistent_generate(const float* embed, const float* dil_w, const float* rs_w,
                            const float* rs_b, const float* out_w, const float* out_b,
                            const float* end_w, const float* end_b, const float* cond,
                            const float* sel, const int* sched, float* ring, int* y_state,
                            int* y, float* d_xt, float* d_skip, float* d_zs, float* d_za,
                            float* d_p, long long t0, int n_valid, int B, int L, int R, int S,
                            int A, int tanh_embed, int silence_bin, int mode, void* stream) {
  const GenArgs args{embed, dil_w, rs_w, rs_b, out_w, out_b, end_w, end_b, cond,
                     sel, sched, ring, y_state, y, d_xt, d_skip, d_zs, d_za, d_p, t0,
                     n_valid, B, L, R, S, A, tanh_embed, silence_bin, mode};
  const size_t smem = (size_t)(7 * R + S + 4 * A) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        persistent_generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  persistent_generate_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
