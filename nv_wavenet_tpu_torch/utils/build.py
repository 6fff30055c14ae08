"""Build the package's CUDA sources (`csrc/*.cu`) with nvcc at first use and
bind their plain C entry points with ctypes.

Each source becomes its own shared library under
`<repo>/build/nv_wavenet_tpu_torch/<hash of sources + flags>/`, and each
source with a compile-time precision (`PRECISION_SOURCES`) one library per
precision (`unit`): the same file compiled with `-DNVW_PREC=0, 1, 2`, each
holding that precision's entry points, so its instances compile in
parallel and the exact library holds the exact instances alone.  The probe
source (`FMAD_SOURCES`) is built twice: once with the port's flags and once
as unit `probes.cu@fmad` with `-fmad=true` and `-DNVW_FMAD=1`, the one
library where nvcc may contract a*b+c, so the probe shows what the flag
prevents everywhere else (tools/probe_exact_math.py).  All the
libraries are compiled in parallel, one nvcc each, all started together.
Nothing is built or loaded at import time: the first launch of a kernel
(or an explicit `build_all()`) does it.

Compile flags: `-fmad=false` keeps nvcc from contracting a*b+c into an FMA,
which would change the rounding of the exact-math library
(`csrc/exact_math.cuh`) and break its bit-identity with the numpy / C++ /
torch twins.  No `--use_fast_math` (it would also approximate `/` and
`expf`), and flush-to-zero stays off (the default), as in numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build",
                          "nv_wavenet_tpu_torch")
SOURCES = ("exact_math_kernels.cu", "ordered_matmul.cu", "persistent.cu",
           "staged_generate.cu", "stream_generate.cu", "fused_chain.cu",
           "probes.cu")
PRECISION_SOURCES = ("persistent.cu", "staged_generate.cu",
                     "stream_generate.cu", "fused_chain.cu")
# sources also built with contraction allowed, as unit `<source>@fmad`
FMAD_SOURCES = ("probes.cu",)
# -DNVW_PREC of each precision (csrc/step_common.cuh kPrec*; the names of
# ops/scan_generate.py PRECISIONS)
PREC_IDS = {"exact": 0, "fast": 1, "bf16": 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# loaded libraries by path: a CDLL is loaded once per process
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "nv_wavenet_tpu_torch are built at first use and need "
                       "the CUDA toolkit (PATH, $CUDA_HOME or /usr/local/cuda)")


def build_dir() -> str:
    """Directory keyed on the content of every file in csrc/ and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def unit(source: str, prec: str = "exact") -> str:
    """The library of `source` that holds precision `prec`'s entry points:
    the source's name for "exact" (and for a source without precisions),
    `source@prec` for the others; `source@fmad` is a source of
    FMAD_SOURCES built with `-fmad=true`."""
    if prec == "exact":
        return source
    if not ((source in PRECISION_SOURCES and prec in PREC_IDS)
            or (source in FMAD_SOURCES and prec == "fmad")):
        raise ValueError(f"{source} has no library for precision {prec!r}")
    return f"{source}@{prec}"


def _variants(source: str) -> tuple:
    if source in PRECISION_SOURCES:
        return tuple(PREC_IDS)
    return ("exact", "fmad") if source in FMAD_SOURCES else ("exact",)


UNITS = tuple(unit(s, p) for s in SOURCES for p in _variants(s))


def _split(name: str):
    source, _, prec = name.partition("@")
    return source, prec or "exact"


def library_path(name: str) -> str:
    """The library of a unit (a source's name is its exact unit)."""
    source, prec = _split(name)
    stem = os.path.splitext(source)[0] + ("" if prec == "exact" else "_" + prec)
    return os.path.join(build_dir(), "lib" + stem + ".so")


def build_all(units: Sequence[str] = UNITS) -> Dict[str, str]:
    """Compile every unit whose library is missing, all in parallel.
    Returns {unit: log}: the seconds from the start of the build to the
    unit's end ("built in ... s", the first line), then nvcc's output (the
    ptxas register / shared-memory report); raises RuntimeError naming the
    unit and nvcc's output on failure."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    todo = [u for u in units if not os.path.exists(library_path(u))]
    if todo:
        nvcc = find_nvcc()
        start = time.perf_counter()
        procs = {}
        for u in todo:
            source, prec = _split(u)
            tmp = f"{library_path(u)}.{os.getpid()}.tmp"
            flags, defines = list(NVCC_FLAGS), []
            if prec == "fmad":
                flags[flags.index("-fmad=false")] = "-fmad=true"
                defines = ["-DNVW_FMAD=1"]
            elif source in PRECISION_SOURCES:
                defines = [f"-DNVW_PREC={PREC_IDS[prec]}"]
            cmd = [nvcc, *flags, *defines, "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            with open(tmp + ".log", "w") as log:
                procs[u] = (tmp, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT))
        failed = []
        while procs:   # in the order they end, so each time is its own
            for u, (tmp, proc) in list(procs.items()):
                if proc.poll() is None:
                    continue
                del procs[u]
                with open(tmp + ".log") as f:
                    log = (f"built in {time.perf_counter() - start:.1f} s\n"
                           + f.read())
                os.remove(tmp + ".log")
                if proc.returncode != 0:
                    failed.append(f"{u} (exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, library_path(u))  # atomic against a concurrent build
                with open(library_path(u) + ".log", "w") as f:
                    f.write(log)
            time.sleep(0.05)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for u in units:
        log_path = library_path(u) + ".log"
        if os.path.exists(log_path):
            with open(log_path) as f:
                logs[u] = f.read()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of a unit, built first if it is missing."""
    path = library_path(name)
    if path not in _LOADED:
        if not os.path.exists(path):
            build_all()
        _LOADED[path] = ctypes.CDLL(path)
    return _LOADED[path]


def check_tensor(t, name: str, dtype, shape: Sequence[int], device) -> None:
    """Raise ValueError unless `t` is a contiguous tensor of exactly this
    dtype, shape and device: what a kernel's wrapper hands to C."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def current_stream(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


class CudaKernel:
    """One C entry point of a csrc/ library (a `unit`; it returns
    `cudaGetLastError()` after its launch) and the count of its launches.

    `launches` goes up by one each time the kernel is launched successfully
    and nowhere else, so a run can show that it went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._lib = load(self.source)
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib.nvw_error_string.argtypes = [ctypes.c_int]
            self._lib.nvw_error_string.restype = ctypes.c_char_p
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.nvw_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
