"""Diagnostics of the staged generation kernel K1/K5
(`csrc/staged_generate.cu`) on the card: what one SM's bulk-copy ring
delivers, how long a copy takes to land, what the chain's arithmetic costs
alone, and where a flagship step goes inside the kernel.

    python3 -m nv_wavenet_tpu_torch.tools.staged_probe [ingest|latency|chain|trace]...

With no argument every mode runs.  Each prints JSON lines, then the card's
name and power limit.

- ingest: one CTA per SM (1 and 16 SMs) streams 48 MB of an L2-resident
  buffer through a ring of bulk copies (cp.async.bulk, mbarriers), 8
  consumer warps releasing each slot as it lands; per-SM GB/s against the
  slot size and the number of lanes issuing the copies.
- latency: one CTA issues k bulk copies into k slots back to back (one
  thread, or k lanes in one instruction); clock64 cycles at each issue
  and at each landing (the trace's cycles per µs convert them).
- chain: cycles of a 64-term dependent fp32 add chain from registers (one
  warp), and of K1's k-quad product loop over 16 quads of one column from
  shared memory at 1 and 10 warps, in both of the source's forms: the
  generic instance's `mac_quads` with the stride and trip count passed at
  run time, and the fixed-width instances' `mac_fixed` with both
  compile-time constants.
- trace: `staged_generate.cu` built with -DNVW_TRACE (clock64 stamps in
  block 0: the chain's thread 0, the last chain warp, prev thread 0),
  launched at the flagship (B=16, 64 steps) in exact and bf16: µs per step
  and per phase of a layer, and the chain's chunk waits.  The stamps are
  global stores beside the kernel's work; they add ~25% to the step.

Nothing here is on a user's path.  The probes are built with the
package's nvcc flags (`utils/build.py`) into the build directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from nv_wavenet_tpu_torch.utils import build

_PROBES_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "staged_generate.cu"

namespace {

// ingest: ring of nslots slots of `slot` bytes; lanes [0, nprod) of warp 8
// issue the copies, each lane its slot sequence; warps 0-7 consume
__global__ void ring_kernel(const unsigned char* src, long long src_bytes, int nslots, int slot,
                            long long total, int nprod) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = (uint64_t*)(sm + (size_t)nslots * slot);
  uint64_t* empty = full + nslots;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < nslots; ++s) { bar_init(full + s, 1); bar_init(empty + s, 8); }
    bar_init_fence();
  }
  __syncthreads();
  const long long chunks = total / slot;
  if (tid >= 256 && tid < 256 + nprod) {
    const long long off = ((long long)blockIdx.x * 1048576) % src_bytes;
    for (long long c = tid - 256; c < chunks; c += nprod) {
      const int s = (int)(c % nslots);
      bar_wait(empty + s, (uint32_t)((c / nslots) & 1) ^ 1u);
      bar_expect(full + s, slot);
      const long long o = ((off + c * slot) % (src_bytes - slot)) & ~127ll;
      bulk_copy(sm + (size_t)s * slot, src + o, slot, full + s);
    }
  } else if (tid < 256) {
    float acc = 0.f;
    for (long long c = 0; c < chunks; ++c) {
      const int s = (int)(c % nslots);
      bar_wait(full + s, (uint32_t)((c / nslots) & 1));
      acc += ((const float*)(sm + (size_t)s * slot))[tid];
      __syncwarp();
      if ((tid & 31) == 0) bar_arrive(empty + s);
    }
    if (acc == 12345.f) ((float*)src)[0] = acc;
  }
}

// latency: k copies of `bytes` into k slots; lanes of warp 1 stamp landings
__global__ void burst_kernel(const unsigned char* src, int k, int bytes, int lanes, long long* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* bar = (uint64_t*)(sm + (size_t)k * bytes);
  const int tid = threadIdx.x;
  if (tid == 0) { for (int i = 0; i < k; ++i) bar_init(bar + i, 1); bar_init_fence(); }
  __syncthreads();
  const long long t0 = clock64();
  if (tid < 32) {
    if (lanes) {
      if (tid < k) {
        out[64 + tid] = clock64() - t0;
        bar_expect(bar + tid, bytes);
        bulk_copy(sm + (size_t)tid * bytes, src + (size_t)tid * bytes, bytes, bar + tid);
      }
    } else if (tid == 0) {
      for (int i = 0; i < k; ++i) {
        out[64 + i] = clock64() - t0;
        bar_expect(bar + i, bytes);
        bulk_copy(sm + (size_t)i * bytes, src + (size_t)i * bytes, bytes, bar + i);
      }
    }
  } else if (tid < 64 && tid - 32 < k) {
    bar_wait(bar + tid - 32, 0);
    out[tid - 32] = clock64() - t0;
  }
}

// chain: mode 0 a 64-term dependent add chain from registers; 1 the
// generic quad loop over nq quads of act and weights in shared memory,
// quad-rows of np quads (both at run time); 2 the fixed-width loop over 16
// quads, quad-rows of 320
__global__ void chain_kernel(int mode, int iters, int np, int nq, long long* out, float* sink) {
  extern __shared__ __align__(128) unsigned char sm[];
  float* act = (float*)sm;
  unsigned char* w = sm + 256;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) act[i] = 1e-3f * i;
  for (int i = threadIdx.x; i < 16 * 320 * 4; i += blockDim.x) ((float*)w)[i] = 1e-4f * (i % 89);
  __syncthreads();
  float v[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) v[k] = act[(k * 7 + threadIdx.x) & 63];
  float acc[kMaxNC] = {0.f, 0.f, 0.f, 0.f};
  int col[kMaxNC];
  for (int k = 0; k < kMaxNC; ++k) col[k] = threadIdx.x + k * 320;
  const float sc[kMaxNC] = {1.f, 1.f, 1.f, 1.f};   // no scales (fp32)
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[0] = acc[0] + v[k];
    } else if (mode == 1) {
      mac_quads<4, kPrecExact, 1>(acc, act, w, col, sc, np, nq, 0);
    } else {
      mac_fixed<4, kPrecExact, 1, 320, 16>(acc, act, w, col, sc);
    }
    __syncwarp();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[0] = (t1 - t0) / iters;
  if (acc[0] == 12345.f) sink[0] = acc[1];
}
}  // namespace

extern "C" {
int probe_ring(const void* src, long long src_bytes, int blocks, int nslots, int slot,
               long long total, int nprod, void* stream) {
  const int smem = nslots * slot + 16 * nslots;
  cudaFuncSetAttribute(ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ring_kernel<<<blocks, 288, smem, (cudaStream_t)stream>>>((const unsigned char*)src, src_bytes,
                                                          nslots, slot, total, nprod);
  return (int)cudaGetLastError();
}
int probe_burst(const void* src, int k, int bytes, int lanes, void* out, void* stream) {
  const int smem = k * bytes + 8 * k;
  cudaFuncSetAttribute(burst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  burst_kernel<<<1, 64, smem, (cudaStream_t)stream>>>((const unsigned char*)src, k, bytes, lanes,
                                                     (long long*)out);
  return (int)cudaGetLastError();
}
int probe_chain(int mode, int threads, int np, int nq, void* out, void* sink, void* stream) {
  const int smem = 256 + 16 * 320 * 16;
  cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  chain_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(mode, 200, np, nq, (long long*)out,
                                                          (float*)sink);
  return (int)cudaGetLastError();
}
}
"""

def _compile(name: str, cu: str, prec: int = 0, defines=()) -> ctypes.CDLL:
    """Build the source at `cu` with the package's flags into the build
    directory."""
    out = os.path.join(build.build_dir(), "staged_probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"lib{name}_{prec}.so")
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, f"-DNVW_PREC={prec}",
                          *defines, "-I", build.CSRC_DIR, "-o", lib, cu],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(lib)


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def ingest(lib) -> None:
    lib.probe_ring.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    buf = torch.randn(4 << 20, device="cuda")   # 16 MB, L2-resident
    total = 48 << 20
    stream = torch.cuda.current_stream().cuda_stream
    for blocks in (1, 16):
        for nprod in (1, 2, 4):
            for slot, nslots in ((8192, 24), (16384, 12), (32768, 6), (65536, 3)):
                if nprod > nslots:
                    continue

                def run():
                    err = lib.probe_ring(buf.data_ptr(), buf.numel() * 4, blocks, nslots, slot,
                                         total, nprod, stream)
                    if err:
                        raise RuntimeError(f"probe_ring: CUDA error {err}")
                ms = _time_ms(run)
                _emit(mode="ingest", sms=blocks, issuing_lanes=nprod, slot_bytes=slot,
                      slots=nslots, gb_per_s_per_sm=total / ms / 1e6)


def latency(lib) -> None:
    lib.probe_burst.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    buf = torch.randn(2 << 20, device="cuda")
    out = torch.zeros(128, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for lanes in (0, 1):
        for k, nbytes in ((6, 32768), (12, 16384), (24, 8192)):
            for _ in range(3):   # the last of three runs is kept
                out.zero_()
                err = lib.probe_burst(buf.data_ptr(), k, nbytes, lanes, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"probe_burst: CUDA error {err}")
                torch.cuda.synchronize()
            o = out.cpu().tolist()
            _emit(mode="latency", issued_by="k lanes" if lanes else "one thread", copies=k,
                  bytes=nbytes, issued_cycles=o[64:64 + k], landed_cycles=o[:k])


def chain(lib) -> None:
    lib.probe_chain.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    loops = {1: "generic quad loop (mac_quads), stride and 16 quads at run time",
             2: "fixed-width quad loop (mac_fixed), 16 quads, constant stride"}
    for mode, what, threads in ((0, "64-term dependent add chain, registers", 32),
                                *((m, loops[m], t) for m in (1, 2) for t in (32, 320))):
        err = lib.probe_chain(mode, threads, 320, 16, out.data_ptr(), sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe_chain: CUDA error {err}")
        torch.cuda.synchronize()
        _emit(mode="chain", what=what, threads=threads, cycles=int(out[0]))


def trace() -> None:
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import persistent, scan_generate
    cfg, B, T = cfg_lib.FLAGSHIP_CONFIG, 16, 64
    L = cfg.num_layers
    dev = torch.device("cuda")
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=1), cfg), dev)
    rng = np.random.RandomState(1)
    cond_pre = torch.from_numpy(rng.uniform(-0.5, 0.5, (T, L, B, 2 * cfg.R))
                                .astype(np.float32)).to(dev)
    sel = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32)).to(dev)
    for prec, pid in (("exact", 0), ("bf16", 2)):
        lib = _compile("staged_trace", os.path.join(build.CSRC_DIR, "staged_generate.cu"),
                       pid, ("-DNVW_TRACE",))
        kernel = persistent.PERSISTENT_KERNELS[prec]
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        lib.nvw_set_trace.argtypes = [ctypes.c_void_p]
        stamps = torch.zeros(65536, dtype=torch.int64, device=dev)
        if lib.nvw_set_trace(stamps.data_ptr()):
            raise RuntimeError("nvw_set_trace failed")
        plan = persistent.staged_plan(cfg, B, prec)
        view = scan_generate.product_view(params, prec)
        weights = persistent.staged_stream(view, cfg, plan)
        plan_arr = persistent._plan_array(plan)
        ring = persistent.init_ring(cfg, B, dev, dtype=scan_generate.ring_dtype(prec))
        y_state = torch.full((2, B), cfg.silence_bin, dtype=torch.int32, device=dev)
        y = torch.zeros((T, B), dtype=torch.int32, device=dev)
        sched = persistent.fifo_schedule(cfg, dev)

        def run():
            err = fn(view["embed"].data_ptr(), weights.data_ptr(), None, None,
                     *(view[k].data_ptr() for k in ("rs_b", "out_b", "end_b")),
                     cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(), ring.data_ptr(),
                     y_state.data_ptr(), y.data_ptr(), None, None, None, None, None, None, 0,
                     0, T, B, L, cfg.R, cfg.S, cfg.A, int(cfg.tanh_embed), cfg.silence_bin, 0,
                     persistent._STORAGE_IDS[plan.storage], ctypes.addressof(plan_arr),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"traced K1: CUDA error {err}")
        ms = _time_ms(run, reps=1)   # the warm-up and the timed launch: two runs
        t = stamps.cpu().numpy().astype(np.float64)
        steps = t[:T * 8].reshape(T, 8)
        w = slice(8, T - 1)   # steady steps
        per_us = np.mean(steps[9:T, 0] - steps[8:T - 1, 0]) / (ms * 1e3 / T)   # cycles a µs

        def us(c):
            return float(np.nanmean(c) / per_us)
        lay = {}
        for who, base in (("chain warp 0", 2048), ("last chain warp", 2048 + 20480)):
            f = t[base:base + T * L * 8].reshape(T, L, 8)[w]
            nxt = np.concatenate([f[:, 1:, 0], np.full((f.shape[0], 1), np.nan)], axis=1)
            lay[who] = {"cur": us(f[:, :, 1] - f[:, :, 0]),
                        "to_gate_barrier": us(f[:, :, 2] - f[:, :, 1]),
                        "gate_barrier_to_rs_done": us(f[:, :, 3] - f[:, :, 2]),
                        "epilogue": us(f[:, :, 4] - f[:, :, 3]),
                        "end_barrier": us(nxt - f[:, :, 4])}
        pv = t[45056:45056 + T * L * 2].reshape(T, L, 2)[w]
        last = t[2048 + (np.arange(8, T - 1) * L + L - 1) * 8 + 4]   # the last layer's end
        _emit(mode="trace", precision=prec, B=B, steps=T, us_per_step=ms * 1e3 / T,
              cycles_per_us=per_us,
              step_us={"embedding": us(steps[w, 1] - steps[w, 0]),
                       "layers": us(last - steps[w, 1]),
                       "output_stack": us(steps[w, 3] - last),
                       "sampler": us(steps[w, 4] - steps[w, 3])},
              layer_us=lay, prev_product_us=us(pv[:, :, 1] - pv[:, :, 0]),
              chain_chunk_wait_us_per_step=float(t[60000] / (2 * T) / per_us),
              chunks_waited_over_300_cycles_per_step=float(t[60001] / (2 * T)),
              chunks_per_step=float(t[60002] / (2 * T)))


def _time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    modes = (sys.argv[1:] if argv is None else argv) or ["ingest", "latency", "chain", "trace"]
    if any(m not in ("ingest", "latency", "chain", "trace") for m in modes):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        raise SystemExit("staged_probe measures the card; no CUDA device is available")
    lib = None
    if set(modes) - {"trace"}:
        cu = os.path.join(build.build_dir(), "staged_probe", "staged_probes.cu")
        os.makedirs(os.path.dirname(cu), exist_ok=True)
        with open(cu, "w") as f:
            f.write(_PROBES_CU)
        lib = _compile("staged_probes", cu)
    for m in modes:
        if m == "trace":
            trace()
        else:
            globals()[m](lib)
    from nv_wavenet_tpu_torch.utils import profiling
    print(profiling.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
