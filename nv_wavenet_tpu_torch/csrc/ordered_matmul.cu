// K7: the time-parallel scorer's products in K1's summation order, on the
// CUDA cores of an H100 (sm_90a), with the dilated layer's gate fused into
// a second entry point.
//
// No Pallas counterpart: the JAX time-parallel scorer leaves its products to
// XLA (nv_wavenet_tpu/ops/score_parallel.py:135-139, 150-151, 163-168).  The
// port's scorer needs them in the order of K1's dot_column
// (step_common.cuh): each output accumulated from 0.0f over k = 0, 1, ...,
// K-1, every product and every sum rounded once (-fmad=false, utils/
// build.py).  cuBLAS keeps no such order, so a scorer on it would leave a
// FIFO ring that differs from K1's in the last ulps, and a score -> feed
// handoff would stop being exact.  With this kernel the scorer's
// distributions, ring and y_state equal the forced kernel K2's bit for bit.
//
// Entry points:
//   nvw_ordered_matmul   y = x w                               [M, N]
//   nvw_ordered_gate     z = (x_prev w_prev + x w_cur) + zb,
//                        h[:, j] = em_tanh(z[:, j]) * em_sigmoid(z[:, R + j])
//                        [M, R]: the scorer's dilated product, its bias and
//                        conditioning and the gate in one launch, with zb
//                        read in place from the strided [T, L, B, 2R]
//                        conditioning (and dil_b added to it, rounded once,
//                        when the scorer does not prefold it).
//   nvw_ordered_res_skip rs = h w, then x_out = st((rs[:, :R] + b[:R]) + x)
//                        and skip = (skip + rs[:, R:]) + b[R:] in place:
//                        the scorer's res/skip product and both adds, st
//                        the bf16 rounding of the stored x under
//                        compute_dtype=bfloat16 (torch's round to nearest
//                        even), else nothing.
//
// What bounds it: 2 M N K fp32 operations that the contract forbids to
// fuse, so each k-step of an output is one FMUL and one FADD: at most 33.5
// TFLOP/s on the H100's CUDA cores, half of the 67 TFLOP/s of FFMA.  The
// tensor cores (wgmma in TF32 or bf16, mma.sync) sum a k-block in an order
// of their own and round the products otherwise, so they cannot give these
// bits; at the scorer's shapes (K <= 256) the operations, not the bytes,
// bound the kernel.
//
// Design, to keep the FP pipes issuing:
// - Register tiles of 8 x 8 outputs a thread (4 x 8 for each of the gate's
//   two products; 4 x 4 for the small grids), read from shared memory with
//   128-bit loads: per k-step 4 LDS.128 feed 64 FMUL + 64 FADD.
// - x is stored k-major (transposed as it lands, rows padded by 4 floats):
//   a warp's 32 copies cover 4 rows x 8 k and hit 32 distinct banks, and a
//   thread's 4 rows are one conflict-free LDS.128.
// - Staging by cp.async (4 bytes an element: any K, N, alignment and ragged
//   edge, zero-filled past the edges and never added) into a ring of 3
//   stages of 16 k-steps, one __syncthreads a stage.  A thread's copies
//   keep their k (x) or column (w) and step by a fixed stride, so each
//   costs a few integer instructions (against a thread's 2048 FP
//   instructions a stage at 8 x 8).
// - Persistent blocks: as many blocks as fit on the SMs at once walk the
//   output tiles; the ring runs through the block's (tile, k-tile) stages
//   without a break, so the next tile's loads overlap this tile's math and
//   epilogue.
// - Tiles by shape: 128 x 128 (128 x 64 where N fills 64-wide tiles better,
//   e.g. N = 320), the gate 64 rows x 64 h-columns (its two 128-wide z
//   halves); a grid of fewer big tiles than SMs (M = 4096 or a b = 1
//   verify) takes 32-row tiles instead.
// - Epilogues in registers: the gate's and the res/skip adds read their
//   other terms once and write only h, x and skip, so z and rs never go
//   through device memory; res/skip moves x and skip 16 bytes at a time
//   where R and S are multiples of 4.  Its x and skip traffic (0.33 GB a
//   flagship window's layer) is what keeps it above the plain product.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int kBK = 16;      // k-steps a stage
constexpr int kStages = 3;   // depth of the cp.async ring
// what a tile computes and writes
constexpr int kProduct = 0;   // y = x w
constexpr int kGate = 1;      // h from two products, zb and the gate
constexpr int kResSkip = 2;   // x_out and skip from rs = h w

struct Args {
  const float* x0;   // [M, K]; the gate: x_{t-d}; res/skip: h
  const float* w0;   // [K, ldw]; the gate: w_prev [K, 2R]
  const float* x1;   // the gate: x_t [M, K]; res/skip: the residual x [M, R]
  const float* w1;   // the gate: w_cur [K, 2R]
  float* y;          // [M, N]; the gate: h [M, R]; res/skip: x_out [M, R]
  float* skip;       // res/skip: [M, N - R], updated in place
  const float* zb;   // the gate: row m's 2R terms at
                     // zb + (m / zb_group) * zb_stride_group + (m % zb_group) * zb_stride_row
  const float* bias; // the gate: [2R] added to zb first, or null; res/skip: b [N]
  long long zb_group, zb_stride_group, zb_stride_row;
  int M, N, K;       // the gate: N = R
  int ldw;
  int R;             // res/skip: the residual columns
  int round_x;       // res/skip: store x_out rounded to bf16
  int vec;           // res/skip: R and N - R multiples of 4, x, skip, b, x_out 16-byte aligned
};

// torch's float -> bfloat16 -> float (round to nearest even, NaN kept quiet)
__device__ __forceinline__ float round_bf16(float v) {
  const unsigned u = __float_as_uint(v);
  if (v != v) return __uint_as_float(0x7fc00000u);
  return __uint_as_float(((u + 0x7fffu + ((u >> 16) & 1u)) >> 16) << 16);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN, int TM, int TN, int kMode>
struct Tile {
  static constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  static constexpr int XS = BM + 4;               // k-major x row stride
  static constexpr int kOps = kMode == kGate ? 2 : 1;   // products a tile
  static constexpr int XF = kBK * XS, WF = kBK * BN;
  static constexpr int OP = XF + WF;              // floats of one product's stage
  static constexpr int STAGE = kOps * OP;
  static constexpr size_t SMEM = (size_t)kStages * STAGE * sizeof(float);
  static constexpr int COLS = kMode == kGate ? BN / 2 : BN;   // output columns a tile
  static constexpr int MIN_BLOCKS = 512 / NT;        // <= 128 registers a thread
  static_assert(TM == 4 || TM == 8, "TM");
  static_assert(TN == 4 || TN == 8, "TN");
  static_assert(kMode != kGate || TN == 8, "the gate's thread owns a tanh and a sigmoid group");
  static_assert(NT % 32 == 0 && BM % 32 == 0 && XS % 4 == 0, "shape");
};

// one stage: the x tiles (k-major) and the w tiles of k0 .. k0 + kBK - 1.
// A thread's copies keep their k (x) or column (w) from stage to stage and
// step by a fixed stride, so their addresses are computed once a stage.
template <int BM, int BN, int TM, int TN, int kMode>
__device__ __forceinline__ void load_stage(const Args& a, float* buf, int m0, int c0, int k0) {
  using T = Tile<BM, BN, TM, TN, kMode>;
  constexpr int NW = T::NT / 32;
  constexpr int XI = (BM / 4) * (kBK / 8) / NW;   // x copies a thread
  constexpr int XM = 4 * NW / 2;                  // rows between them
  constexpr int WK = T::NT / BN;                  // k between w copies
  static_assert(kBK == 16 && NW % 2 == 0 && (BM / 4) * 2 % NW == 0 && T::NT % BN == 0,
                "copy layout");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // x: chunks of 4 rows x 8 k, one a warp (banks 4k + m, all distinct):
  // chunk warp + i NW holds k-half warp % 2 and rows 4 (warp / 2 + i NW / 2)
  const int kx = (warp & 1) * 8 + (lane & 7), mx = (warp >> 1) * 4 + (lane >> 3);
  const bool kx_ok = k0 + kx < a.K;
  // w: consecutive threads on consecutive columns; the gate's tile holds its
  // h columns' tanh half, then their sigmoid half
  const int c = tid % BN, kw = tid / BN;
  int gc;
  bool cv;
  if constexpr (kMode == kGate) {
    const int j = c0 + c % (BN / 2);
    cv = j < a.N;
    gc = (c < BN / 2 ? 0 : a.N) + j;
  } else {
    gc = c0 + c;
    cv = gc < a.N;
  }
#pragma unroll
  for (int op = 0; op < T::kOps; ++op) {
    const float* x = op ? a.x1 : a.x0;
    const float* w = op ? a.w1 : a.w0;
    float* xs = buf + op * T::OP + kx * T::XS + mx;
    float* ws = buf + op * T::OP + T::XF + kw * BN + c;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int gm = m0 + mx + i * XM;
      const bool v = kx_ok && gm < a.M;
      cp_async4(xs + i * XM, v ? x + (size_t)gm * a.K + k0 + kx : x, v);
    }
#pragma unroll
    for (int i = 0; i < kBK / WK; ++i) {
      const int gk = k0 + kw + i * WK;
      const bool v = cv && gk < a.K;
      cp_async4(ws + i * WK * BN, v ? w + (size_t)gk * a.ldw + gc : w, v);
    }
  }
}

// rows (columns) of a thread's register tile: groups of 4, BM / (TM / 4) apart
template <int B, int TB>
__device__ __forceinline__ int tile_offset(int i, int t) {
  return (i >> 2) * (B / (TB / 4)) + t * 4 + (i & 3);
}

template <int BM, int BN, int TM, int TN, int kMode>
__device__ __forceinline__ void mac_step(const float* buf, int k, int tx, int ty,
                                         float (&acc)[kMode == kGate ? 2 : 1][TM][TN]) {
  using T = Tile<BM, BN, TM, TN, kMode>;
#pragma unroll
  for (int op = 0; op < T::kOps; ++op) {
    const float* xs = buf + op * T::OP + k * T::XS;
    const float* ws = buf + op * T::OP + T::XF + k * BN;
    float a[TM], b[TN];
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(xs + g * (BM / (TM / 4)) + ty * 4);
      a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(ws + g * (BN / (TN / 4)) + tx * 4);
      b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
    }
    // one rounded product and one rounded sum (-fmad=false: no FFMA)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[op][i][j] = acc[op][i][j] + a[i] * b[j];
  }
}

template <int BM, int BN, int TM, int TN, int kMode>
__device__ __forceinline__ void epilogue(const Args& a, float (&acc)[kMode == kGate ? 2 : 1][TM][TN],
                                         int m0, int c0, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tile_offset<BM, TM>(i, ty);
    if (m >= a.M) continue;
    if constexpr (kMode == kResSkip) {
      // the scorer's order: x_out = st((rs + b) + x), skip = (skip + rs) + b.
      // A group of 4 columns lies wholly in x or in skip when R and S are
      // multiples of 4 (then, aligned, one 16-byte access each); the row's x and skip
      // terms are all loaded before its first store, so their latencies
      // overlap (a store may alias a later load)
      const int S = a.N - a.R;
      const bool vec = a.vec;
      float in[TN], bn[TN];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int n = c0 + g * (BN / (TN / 4)) + tx * 4;
        if (vec && n + 3 < a.N) {
          const float4 t = *reinterpret_cast<const float4*>(
              n < a.R ? a.x1 + (size_t)m * a.R + n : a.skip + (size_t)m * S + (n - a.R));
          const float4 u = *reinterpret_cast<const float4*>(a.bias + n);
          in[4 * g] = t.x; in[4 * g + 1] = t.y; in[4 * g + 2] = t.z; in[4 * g + 3] = t.w;
          bn[4 * g] = u.x; bn[4 * g + 1] = u.y; bn[4 * g + 2] = u.z; bn[4 * g + 3] = u.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            in[4 * g + q] = bn[4 * g + q] = 0.0f;
            if (n + q < a.N) {
              bn[4 * g + q] = a.bias[n + q];
              in[4 * g + q] = n + q < a.R ? a.x1[(size_t)m * a.R + n + q]
                                          : a.skip[(size_t)m * S + (n + q - a.R)];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int n = c0 + g * (BN / (TN / 4)) + tx * 4;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float rs = acc[0][i][4 * g + q];
          if (n + q < a.R) {
            v[q] = (rs + bn[4 * g + q]) + in[4 * g + q];
            if (a.round_x) v[q] = round_bf16(v[q]);
          } else {
            v[q] = (in[4 * g + q] + rs) + bn[4 * g + q];
          }
        }
        if (vec && n + 3 < a.N) {
          *reinterpret_cast<float4*>(n < a.R ? a.y + (size_t)m * a.R + n
                                             : a.skip + (size_t)m * S + (n - a.R)) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (n + q >= a.N) continue;
            if (n + q < a.R)
              a.y[(size_t)m * a.R + n + q] = v[q];
            else
              a.skip[(size_t)m * S + (n + q - a.R)] = v[q];
          }
        }
      }
    } else if constexpr (kMode == kProduct) {
      float* yr = a.y + (size_t)m * a.N;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int n = c0 + g * (BN / (TN / 4)) + tx * 4;
        if ((a.N & 3) == 0 && n + 3 < a.N) {
          *reinterpret_cast<float4*>(yr + n) = make_float4(
              acc[0][i][4 * g], acc[0][i][4 * g + 1], acc[0][i][4 * g + 2], acc[0][i][4 * g + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < a.N) yr[n + q] = acc[0][i][4 * g + q];
        }
      }
    } else {
      // the scorer's order: z = (a + b) + zb, zb = bias + cond when given
      const int R = a.N;
      const float* zr = a.zb + (m / a.zb_group) * a.zb_stride_group +
                        (m % a.zb_group) * a.zb_stride_row;
      float hv[4];
      const int j0 = c0 + tx * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        hv[q] = 0.0f;
        if (j < R) {
          float bt = zr[j], bs = zr[R + j];
          if (a.bias) {
            bt = a.bias[j] + bt;
            bs = a.bias[R + j] + bs;
          }
          const float zt = (acc[0][i][q] + acc[1][i][q]) + bt;
          const float zs = (acc[0][i][4 + q] + acc[1][i][4 + q]) + bs;
          hv[q] = nvw::em_tanh(zt) * nvw::em_sigmoid(zs);
        }
      }
      float* hr = a.y + (size_t)m * R;
      if ((R & 3) == 0 && j0 + 3 < R) {
        *reinterpret_cast<float4*>(hr + j0) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < R) hr[j0 + q] = hv[q];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int kMode>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN, kMode>::NT,
                                  Tile<BM, BN, TM, TN, kMode>::MIN_BLOCKS)
ordered_kernel(const Args a) {
  using T = Tile<BM, BN, TM, TN, kMode>;
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int tiles_n = (a.N + T::COLS - 1) / T::COLS;
  const int tiles = ((a.M + BM - 1) / BM) * tiles_n;
  const int nk = max(1, (a.K + kBK - 1) / kBK);   // K = 0: one empty stage, y = 0
  // this block's tiles are blockIdx.x, + gridDim.x, ...; its stages are
  // their k-tiles in order, one stream through the ring
  const int n_stages = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nk;
  auto origin = [&](int s, int& m0, int& c0, int& k0) {
    const int t = blockIdx.x + (s / nk) * gridDim.x;
    m0 = (t / tiles_n) * BM;
    c0 = (t % tiles_n) * T::COLS;
    k0 = (s % nk) * kBK;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) {
      int m0, c0, k0;
      origin(s, m0, c0, k0);
      load_stage<BM, BN, TM, TN, kMode>(a, smem + s * T::STAGE, m0, c0, k0);
    }
    cp_async_commit();
  }
  float acc[T::kOps][TM][TN];
#pragma unroll
  for (int op = 0; op < T::kOps; ++op)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[op][i][j] = 0.0f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();   // stage s has landed (this thread's copies)
    __syncthreads();                // ... everyone's, and stage s - 1 is read
    const int sn = s + kStages - 1;
    if (sn < n_stages) {
      int m0, c0, k0;
      origin(sn, m0, c0, k0);
      load_stage<BM, BN, TM, TN, kMode>(a, smem + (sn % kStages) * T::STAGE, m0, c0, k0);
    }
    cp_async_commit();
    int m0, c0, k0;
    origin(s, m0, c0, k0);
    const float* buf = smem + (s % kStages) * T::STAGE;
    const int kn = min(kBK, a.K - k0);   // never add the zero padding
    if (kn == kBK) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) mac_step<BM, BN, TM, TN, kMode>(buf, k, tx, ty, acc);
    } else {
      for (int k = 0; k < kn; ++k) mac_step<BM, BN, TM, TN, kMode>(buf, k, tx, ty, acc);
    }
    if (s % nk == nk - 1) {
      epilogue<BM, BN, TM, TN, kMode>(a, acc, m0, c0, tx, ty);
#pragma unroll
      for (int op = 0; op < T::kOps; ++op)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[op][i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();
}

constexpr int kMaxDevices = 64;

// the current device's SM count, cached per device; 0 on an error
int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// a persistent grid: as many blocks as are resident at once, at most one a tile.
// The shared-memory attribute is per device, so it is set on every launch;
// the occupancy is cached per device.
template <int BM, int BN, int TM, int TN, int kMode>
int launch(const Args& a, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN, kMode>;
  auto* kern = ordered_kernel<BM, BN, TM, TN, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int resident[kMaxDevices] = {};
  if (!resident[dev]) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T::NT, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1 || sm_count() < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sm_count();
  }
  const long long tiles =
      (long long)((a.M + BM - 1) / BM) * ((a.N + T::COLS - 1) / T::COLS);
  const int grid = (int)(tiles < resident[dev] ? tiles : resident[dev]);
  ordered_kernel<BM, BN, TM, TN, kMode><<<grid, T::NT, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

long long tiles_of(int M, int N, int bm, int cols) {
  return (long long)((M + bm - 1) / bm) * ((N + cols - 1) / cols);
}

template <int kMode>
int launch_product(const Args& a, cudaStream_t st) {
  // 64-wide column tiles where they waste fewer columns than 128-wide ones
  const bool narrow = (a.N + 63) / 64 * 64 < (a.N + 127) / 128 * 128;
  if (tiles_of(a.M, a.N, 128, narrow ? 64 : 128) < sm_count())
    return launch<32, 64, 4, 4, kMode>(a, st);
  return narrow ? launch<128, 64, 8, 8, kMode>(a, st) : launch<128, 128, 8, 8, kMode>(a, st);
}

}  // namespace

extern "C" {

const char* nvw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [M, K], w [K, N], y [M, N], all fp32, row-major and contiguous
int nvw_ordered_matmul(const float* x, const float* w, float* y, int M, int N, int K,
                       void* stream) {
  const Args a{x, w, nullptr, nullptr, y, nullptr, nullptr, nullptr, 1, 0, 0, M, N, K, N, 0, 0, 0};
  return launch_product<kProduct>(a, (cudaStream_t)stream);
}

// h [M, K], w [K, N], b [N], x [M, R] -> x_out [M, R]; skip [M, N - R] in
// place; round_x: x_out rounded to bf16
int nvw_ordered_res_skip(const float* h, const float* w, const float* b, const float* x,
                         float* x_out, float* skip, int M, int N, int K, int R, int round_x,
                         void* stream) {
  const auto aligned = [](const void* p) { return ((unsigned long long)p & 15) == 0; };
  const int vec = R % 4 == 0 && (N - R) % 4 == 0 && aligned(x) && aligned(skip) &&
                  aligned(b) && aligned(x_out);
  const Args a{h, w, x, nullptr, x_out, skip, nullptr, b, 1, 0, 0, M, N, K, N, R, round_x, vec};
  return launch_product<kResSkip>(a, (cudaStream_t)stream);
}

// x_prev, x [M, K]; w_prev, w_cur [K, 2R] (row-major, contiguous); h [M, R];
// row m's zb at zb + (m / zb_group) * zb_stride_group + (m % zb_group) *
// zb_stride_row, unit stride over its 2R columns; bias [2R] or null
int nvw_ordered_gate(const float* x_prev, const float* x, const float* w_prev,
                     const float* w_cur, const float* zb, const float* bias, float* h, int M,
                     int R, int K, long long zb_group, long long zb_stride_group,
                     long long zb_stride_row, void* stream) {
  const Args a{x_prev, w_prev, x, w_cur, h, nullptr, zb, bias, zb_group, zb_stride_group,
               zb_stride_row, M, R, K, 2 * R, 0, 0, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  if (tiles_of(M, R, 64, 64) < sm_count()) return launch<32, 64, 4, 8, kGate>(a, st);
  return launch<64, 128, 4, 8, kGate>(a, st);
}

}  // extern "C"
