"""The fixed-order matrix product of the time-parallel scorer (kernel K7,
`csrc/ordered_matmul.cu`), with its plain PyTorch version.

y[m, n] = sum_k x[m, k] w[k, n], accumulated from 0 over k = 0, 1, ...,
K-1 with every product and every sum rounded once: the order of K1's
per-column dot products (`csrc/persistent.cu::dot_column`).  The scorer's
products go through it so that its FIFO ring and distributions equal the
sequential kernels' bit for bit; cuBLAS (`x @ w`) sums in another order.

The plain version is one torch multiply and one add per k (no `addcmul`, no
`@`), so on the card it equals the kernel bit for bit, and on the CPU it is
the scorer's plain path.  `ordered_matmul` takes a CPU tensor to the plain
version and a CUDA tensor to K7, never one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from nv_wavenet_tpu_torch.utils import build

_P = ctypes.c_void_p
_I = ctypes.c_int

# K7: 64 x 64 output tiles, 4 x 4 outputs per thread, k in order
ORDERED_MATMUL_KERNEL = build.CudaKernel(
    "ordered_matmul.cu", "nvw_ordered_matmul", [_P, _P, _P, _I, _I, _I, _P])


def ordered_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] as K rounded multiplies and adds, k in order."""
    y = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        y = y + x[:, k:k + 1] * w[k:k + 1, :]
    return y


def ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] float32 @ w [K, N] float32 -> [M, N] in K1's summation
    order.  CPU tensors: the plain version; CUDA tensors: kernel K7."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ordered_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        if w.device != x.device:
            raise ValueError(f"w on {w.device}, x on {x.device}")
        return ordered_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M, K = x.shape
    N = w.shape[1]
    build.check_tensor(x, "x", torch.float32, (M, K), x.device)
    build.check_tensor(w, "w", torch.float32, (K, N), x.device)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        ORDERED_MATMUL_KERNEL(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N,
                              K, build.current_stream(x.device))
    return y
