"""Build the package's CUDA sources (`csrc/*.cu`) with nvcc at first use and
bind their plain C entry points with ctypes.

Each source becomes its own shared library under
`<repo>/build/nv_wavenet_tpu_torch/<hash of sources + flags>/`; the sources
are compiled in parallel, one nvcc per file, all started together.  Nothing
is built or loaded at import time: the first launch of a kernel (or an
explicit `build_all()`) does it.

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
from typing import Dict, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build",
                          "nv_wavenet_tpu_torch")
SOURCES = ("exact_math_kernels.cu", "persistent.cu")
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


def library_path(source: str) -> str:
    return os.path.join(build_dir(), "lib" + os.path.splitext(source)[0] + ".so")


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: nvcc's log (ptxas register / shared-memory report)};
    raises RuntimeError naming the source and nvcc's output on failure."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    todo = [s for s in sources if not os.path.exists(library_path(s))]
    logs = {}
    if todo:
        nvcc = find_nvcc()
        procs = []
        for src in todo:
            tmp = f"{library_path(src)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, library_path(src))   # atomic against a concurrent build
            with open(library_path(src) + ".log", "w") as f:
                f.write(log)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in sources:
        log_path = library_path(src) + ".log"
        if os.path.exists(log_path):
            with open(log_path) as f:
                logs[src] = f.read()
    return logs


def load(source: str) -> ctypes.CDLL:
    path = library_path(source)
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
    """One C entry point of a csrc/ library (which returns
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
