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
    kernel of the port;
  * K0a (exact exp, tanh, sigmoid) over the probe's x sweep and K0b (the
    canonical sampler) over za [4096, 256], sel [4096, 1]: mismatches
    against the plain versions.

    python3 -m nv_wavenet_tpu_torch.tools.probe_exact_math

It runs on the card and fails without one; it ends with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.utils import build
from nv_wavenet_tpu_torch.utils.profiling import card

N = 131072
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
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


def fma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              form: str = "plain", flags: str = "fmad=false") -> torch.Tensor:
    """o = a*b + c over float32 [n] tensors: P1 (`form` "plain" or
    "guarded", from the library built with `flags`) on CUDA tensors,
    `fma_plain` on CPU tensors."""
    if form not in FORMS or flags not in FMA_PROBE_KERNELS:
        raise ValueError(f"form {form!r} / flags {flags!r}: expected one of "
                         f"{FORMS} / {tuple(FMA_PROBE_KERNELS)}")
    dev = a.device
    for name, t in (("a", a), ("b", b), ("c", c)):
        build.check_tensor(t, name, torch.float32, a.shape, dev)
    if dev.type == "cpu":
        return fma_plain(a, b, c)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    o = torch.empty_like(a)
    if a.numel():
        FMA_PROBE_KERNELS[flags](a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 o.data_ptr(), a.numel(),
                                 int(form == "guarded"),
                                 build.current_stream(dev))
    return o


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
