"""The exact-math probe on the card: does nvcc contract a*b+c into an FMA
(probe P1, `fma_probe_kernel` of `csrc/probes.cu`), and do the exact
functions and the sampler (K0a, K0b) equal their plain versions bit for bit?

The port's counterpart of `tools/probe_exact_math_tpu.py`, on its inputs
(`RandomState(0)`, the same draws in the same order, :35-39 and :77-107):

  * P1 over n = 131,072 elements, from both builds of `csrc/probes.cu`
    (the port's -fmad=false, and the -fmad=true library), in the plain and
    the guarded form: the mismatches against numpy's separate a*b+c (a
    rounded product, then a rounded sum) and against the fp64 FMA rounded
    to fp32.  The guarded form and the -fmad=false build must show none
    against separate; the plain form built with -fmad=true shows the
    contraction that `utils/build.py`'s -fmad=false prevents in every other
    kernel of the port.  P1 moves 16-byte vectors where every pointer is
    16-byte aligned (`vector_count`); it is also timed at N_LARGE elements,
    where bytes decide, and its host path per call (`host_path_us`);
  * K0a (exact exp, tanh, sigmoid) over the probe's x sweep and K0b (the
    canonical sampler) over za [4096, 256], sel [4096, 1]: mismatches
    against the plain versions.

    python3 -m nv_wavenet_tpu_torch.tools.probe_exact_math

It runs on the card and fails without one; it ends with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.utils import build
from nv_wavenet_tpu_torch.utils.profiling import card

N = 131072
N_LARGE = 1 << 24          # 268 MB of traffic: a shape where bytes decide
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# a, b, c, o, n, n4, the SM count, guarded, stream
_ARGTYPES = [_P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int, _P]
# P1 from each build of csrc/probes.cu
FMA_PROBE_KERNELS = {
    "fmad=false": build.CudaKernel("probes.cu", "nvw_fma_probe", _ARGTYPES),
    "fmad=true": build.CudaKernel(build.unit("probes.cu", "fmad"),
                                  "nvw_fma_probe_fmad", _ARGTYPES)}
FORMS = ("plain", "guarded")


def fma_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """The plain version of P1: a rounded product, then a rounded sum (two
    torch operations, never contracted)."""
    return a * b + c


def vector_count(n: int, *tensors: torch.Tensor) -> int:
    """The float4s of P1's vector loop: n // 4 where every tensor's first
    element is 16-byte aligned, else 0 (an offset view takes the scalar
    loop alone)."""
    return 0 if any(t.data_ptr() % 16 for t in tensors) else n // 4


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`, asked once: P1's grid cap."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_operands(a, b, c):
    dev = a.device
    for name, t in (("a", a), ("b", b), ("c", c)):
        build.check_tensor(t, name, torch.float32, a.shape, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _launch(a, b, c, o, form: str, flags: str) -> None:
    FMA_PROBE_KERNELS[flags](a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             o.data_ptr(), a.numel(),
                             vector_count(a.numel(), a, b, c, o),
                             sm_count(a.device.index),
                             int(form == "guarded"),
                             build.current_stream(a.device))


def fma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              form: str = "plain", flags: str = "fmad=false") -> torch.Tensor:
    """o = a*b + c over float32 [n] tensors: P1 (`form` "plain" or
    "guarded", from the library built with `flags`) on CUDA tensors,
    `fma_plain` on CPU tensors."""
    if form not in FORMS or flags not in FMA_PROBE_KERNELS:
        raise ValueError(f"form {form!r} / flags {flags!r}: expected one of "
                         f"{FORMS} / {tuple(FMA_PROBE_KERNELS)}")
    _check_operands(a, b, c)
    if a.device.type == "cpu":
        return fma_plain(a, b, c)
    o = torch.empty_like(a)
    if a.numel():
        _launch(a, b, c, o, form, flags)
    return o


def host_path_us(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 calls: int = 1000) -> dict:
    """The host's time per call of the wrapper on CUDA tensors, by
    time.perf_counter over `calls` calls each: `fma_probe` whole, its
    checks alone (`_check_operands`), the output's allocation, the lookup
    of torch's current stream, the vector count and the cached SM count
    alone, and the ctypes call with what it passes (vector count, pointers,
    the SM count, the stream, the launch).  The launches are queued, not
    waited for."""
    o = torch.empty_like(a)

    def per_call(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        return dt

    return {"wrapper": per_call(lambda: fma_probe(a, b, c)),
            "checks": per_call(lambda: _check_operands(a, b, c)),
            "allocation": per_call(lambda: torch.empty_like(a)),
            "stream_lookup": per_call(lambda: build.current_stream(a.device)),
            "vector_count": per_call(
                lambda: vector_count(a.numel(), a, b, c, o)),
            "sm_count": per_call(lambda: sm_count(a.device.index)),
            "ctypes_call": per_call(
                lambda: _launch(a, b, c, o, "plain", "fmad=false")),
            "calls": calls}


def probe_inputs():
    """The TPU probe's inputs from RandomState(0), in its order: a, b, c
    [N] in [-2, 2); the x sweep of the exact functions [N]; za [4096, 256]
    in [-8, 8) and sel [4096, 1]."""
    rng = np.random.RandomState(0)
    a, b, c = (rng.uniform(-2, 2, N).astype(np.float32) for _ in range(3))
    x = np.concatenate([rng.uniform(-90, 90, N // 2),
                        rng.uniform(-4, 4, N // 4),
                        rng.uniform(-0.6, 0.6, N // 4)]).astype(np.float32)
    za = rng.uniform(-8, 8, (4096, 256)).astype(np.float32)
    sel = rng.uniform(0, 1, (4096, 1)).astype(np.float32)
    return a, b, c, x, za, sel


def references(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """numpy's separate a*b+c and the fp64 FMA rounded to fp32."""
    sep = a * b + c
    fma = (a.astype(np.float64) * b.astype(np.float64)
           + c.astype(np.float64)).astype(np.float32)
    return sep, fma


def bit_mismatches(x, y) -> int:
    return int(np.sum(np.asarray(x, np.float32).view(np.int32)
                      != np.asarray(y, np.float32).view(np.int32)))


def fma_report(a, b, c, dev) -> dict:
    """{(flags, form): (mismatches vs separate, vs fp64 FMA)} of P1 on
    `dev`, plus ("numpy", "fma64") for separate against FMA itself."""
    sep, fma = references(a, b, c)
    ta, tb, tc = (torch.from_numpy(v).to(dev) for v in (a, b, c))
    out = {("numpy", "fma64"): (bit_mismatches(sep, fma), 0)}
    for flags in FMA_PROBE_KERNELS:
        for form in FORMS:
            o = fma_probe(ta, tb, tc, form, flags).cpu().numpy()
            out[(flags, form)] = (bit_mismatches(o, sep),
                                  bit_mismatches(o, fma))
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_exact_math runs on a CUDA device and none "
                           "is available")
    dev = torch.device("cuda")
    a, b, c, x, za, sel = probe_inputs()
    rep = fma_report(a, b, c, dev)
    print(f"numpy separate vs fp64 FMA differ at "
          f"{rep[('numpy', 'fma64')][0]} of {N}", flush=True)
    for flags in FMA_PROBE_KERNELS:
        for form in FORMS:
            sep, fma = rep[(flags, form)]
            print(f"P1 {form:7s} a*b+c built with -{flags:10s}: {sep}/{N} "
                  f"mismatches vs numpy separate ({fma} vs fp64 FMA)",
                  flush=True)
    xt = torch.from_numpy(x).to(dev)
    for name in ("exp", "tanh", "sigmoid"):
        got = em.exact_fn(name, xt).cpu().numpy()
        ref = em.PLAIN_FNS[name](torch.from_numpy(x)).numpy()
        print(f"K0a exact_{name}: {bit_mismatches(got, ref)}/{N} mismatches "
              f"vs the plain version", flush=True)
    y_k = em.sample_from_logits(torch.from_numpy(za).to(dev),
                                torch.from_numpy(sel).to(dev), 128)
    y_p = em.sample_from_logits_plain(torch.from_numpy(za),
                                      torch.from_numpy(sel), 128)
    print(f"K0b sampler: {int((y_k.cpu() != y_p).sum())}/{len(sel)} "
          f"mismatches vs the plain version", flush=True)
    print(card(), flush=True)
    return rep


if __name__ == "__main__":
    main()
