"""The fixed-order matrix product of the time-parallel scorer (kernel K7,
`csrc/ordered_matmul.cu`), with its plain PyTorch version.

y[m, n] = sum_k x[m, k] w[k, n], accumulated from 0 over k = 0, 1, ...,
K-1 with every product and every sum rounded once: the order of K1's
per-column dot products (`csrc/step_common.cuh::dot_column`).  The scorer's
products go through it so that its FIFO ring and distributions equal the
sequential kernels' bit for bit; cuBLAS (`x @ w`) sums in another order.

The plain version is one torch multiply and one add per k (no `addcmul`, no
`@`), so on the card it equals the kernel bit for bit, and on the CPU it is
the scorer's plain path.  Two entries fuse the scorer's steps around a
product into K7's epilogue, each with the scorer's earlier composition of
separate steps as its plain version: `ordered_gate`, the dilated layer (the
two halves of the dilated product, the conditioning plus dil_b rounded
once, the gate tanh * sigmoid), and `ordered_res_skip`, the res/skip
product and its two adds (the residual stream stored rounded under bf16
compute).  Every wrapper takes a CPU tensor to the plain version and a CUDA
tensor to K7, never one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.utils import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# K7: persistent blocks of 128 x 128 (or 128 x 64, or 32 x 64) output
# tiles, k in order
ORDERED_MATMUL_KERNEL = build.CudaKernel(
    "ordered_matmul.cu", "nvw_ordered_matmul", [_P, _P, _P, _I, _I, _I, _P])
# K7's gate entry: both dilated halves, zb and tanh * sigmoid in one launch
ORDERED_GATE_KERNEL = build.CudaKernel(
    "ordered_matmul.cu", "nvw_ordered_gate",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _P])
# K7's res/skip entry: the product, the residual add and the skip sum
ORDERED_RES_SKIP_KERNEL = build.CudaKernel(
    "ordered_matmul.cu", "nvw_ordered_res_skip",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])


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


def _check_float32(**tensors) -> None:
    """The fused entries take float32 alone, on every device (the plain
    version's roundings are float32's)."""
    for name, t in tensors.items():
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")


def _zb_rows(zb: torch.Tensor, M: int, R: int):
    """(rows per group, group stride, row stride) addressing row m of zb
    ([M, 2R], or [T, B, 2R] with T * B = M, e.g. `cond[:, l]` of the
    [T, L, B, 2R] conditioning) at (m // group) * group_stride + (m % group)
    * row_stride, its 2R columns at unit stride."""
    if zb.shape[-1:] != (2 * R,) or zb.dim() not in (2, 3) or (
            zb.shape[:-1].numel() != M):
        raise ValueError(f"zb: expected [{M}, {2 * R}] or [T, B, {2 * R}] "
                         f"with T * B = {M}, got {tuple(zb.shape)}")
    if zb.stride(-1) != 1:
        raise ValueError("zb: its last axis must have unit stride")
    if zb.dim() == 2:
        return max(M, 1), 0, zb.stride(0)
    return zb.shape[1], zb.stride(0), zb.stride(1)


def ordered_gate_plain(x_prev: torch.Tensor, x: torch.Tensor,
                       w_prev: torch.Tensor, w_cur: torch.Tensor,
                       zb: torch.Tensor, bias=None) -> torch.Tensor:
    """h = tanh(z[:, :R]) * sigmoid(z[:, R:]) with z = (x_prev w_prev + x
    w_cur) + zb (zb = bias + zb first when bias is given), each product in
    K1's order: the scorer's dilated layer as separate plain steps."""
    M, R = x.shape[0], w_cur.shape[1] // 2
    if bias is not None:
        zb = bias + zb
    z = (ordered_matmul_plain(x_prev, w_prev)
         + ordered_matmul_plain(x, w_cur)) + zb.reshape(M, 2 * R)
    return em.tanh(z[:, :R]) * em.sigmoid(z[:, R:])


def ordered_gate(x_prev: torch.Tensor, x: torch.Tensor, w_prev: torch.Tensor,
                 w_cur: torch.Tensor, zb: torch.Tensor,
                 bias=None) -> torch.Tensor:
    """The scorer's dilated layer: x_prev, x [M, K]; w_prev, w_cur [K, 2R];
    zb [M, 2R] or [T, B, 2R] (any strides with a unit last one); bias [2R]
    or None -> h [M, R] float32.  CPU tensors: the plain version; CUDA
    tensors: K7's gate entry."""
    if (x.dim() != 2 or x_prev.shape != x.shape or w_cur.dim() != 2
            or w_prev.shape != w_cur.shape or x.shape[1] != w_cur.shape[0]
            or w_cur.shape[1] % 2):
        raise ValueError(f"ordered_gate: shapes {tuple(x_prev.shape)}, "
                         f"{tuple(x.shape)} @ {tuple(w_prev.shape)}, "
                         f"{tuple(w_cur.shape)}")
    M, K = x.shape
    R = w_cur.shape[1] // 2
    group, s_group, s_row = _zb_rows(zb, M, R)
    if bias is not None and tuple(bias.shape) != (2 * R,):
        raise ValueError(f"bias: expected [{2 * R}], got {tuple(bias.shape)}")
    _check_float32(x_prev=x_prev, x=x, w_prev=w_prev, w_cur=w_cur, zb=zb,
                   bias=bias)
    if x.device.type == "cpu":
        for name, t in (("x_prev", x_prev), ("w_prev", w_prev),
                        ("w_cur", w_cur), ("zb", zb), ("bias", bias)):
            if t is not None and t.device != x.device:
                raise ValueError(f"{name} on {t.device}, x on {x.device}")
        return ordered_gate_plain(x_prev, x, w_prev, w_cur, zb, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.check_tensor(x_prev, "x_prev", torch.float32, (M, K), x.device)
    build.check_tensor(x, "x", torch.float32, (M, K), x.device)
    build.check_tensor(w_prev, "w_prev", torch.float32, (K, 2 * R), x.device)
    build.check_tensor(w_cur, "w_cur", torch.float32, (K, 2 * R), x.device)
    if zb.device != x.device:
        raise ValueError(f"zb on {zb.device}, x on {x.device}")
    if bias is not None:
        build.check_tensor(bias, "bias", torch.float32, (2 * R,), x.device)
    h = torch.empty((M, R), dtype=torch.float32, device=x.device)
    if M and R:
        ORDERED_GATE_KERNEL(
            x_prev.data_ptr(), x.data_ptr(), w_prev.data_ptr(),
            w_cur.data_ptr(), zb.data_ptr(),
            None if bias is None else bias.data_ptr(), h.data_ptr(), M, R, K,
            group, s_group, s_row, build.current_stream(x.device))
    return h


def ordered_res_skip_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           x: torch.Tensor, skip: torch.Tensor,
                           round_x: bool = False) -> torch.Tensor:
    """rs = h w in K1's order; returns x_out = (rs[:, :R] + b[:R]) + x
    (rounded to bf16 when round_x) and sets skip = (skip + rs[:, R:]) +
    b[R:] in place: the scorer's residual and skip steps."""
    R = x.shape[1]
    rs = ordered_matmul_plain(h, w)
    x_out = (rs[:, :R] + b[:R]) + x
    if round_x:
        x_out = x_out.to(torch.bfloat16).to(torch.float32)
    skip.copy_((skip + rs[:, R:]) + b[R:])
    return x_out


def ordered_res_skip(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor, skip: torch.Tensor,
                     round_x: bool = False) -> torch.Tensor:
    """The scorer's res/skip layer step: h [M, K], w [K, R + S], b [R + S],
    x [M, R] (the residual stream), skip [M, S] (updated in place) ->
    x_out [M, R].  CPU tensors: the plain version; CUDA tensors: K7's
    res/skip entry."""
    if (h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]
            or x.dim() != 2 or skip.dim() != 2 or x.shape[0] != h.shape[0]
            or skip.shape[0] != h.shape[0]
            or x.shape[1] + skip.shape[1] != w.shape[1]):
        raise ValueError(f"ordered_res_skip: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, x {tuple(x.shape)}, skip "
                         f"{tuple(skip.shape)}")
    M, K = h.shape
    N, R = w.shape[1], x.shape[1]
    if tuple(b.shape) != (N,):
        raise ValueError(f"b: expected [{N}], got {tuple(b.shape)}")
    _check_float32(h=h, w=w, b=b, x=x, skip=skip)
    if h.device.type == "cpu":
        for name, t in (("w", w), ("b", b), ("x", x), ("skip", skip)):
            if t.device != h.device:
                raise ValueError(f"{name} on {t.device}, h on {h.device}")
        return ordered_res_skip_plain(h, w, b, x, skip, round_x)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    for name, t, shape in (("h", h, (M, K)), ("w", w, (K, N)), ("b", b, (N,)),
                           ("x", x, (M, R)), ("skip", skip, (M, N - R))):
        build.check_tensor(t, name, torch.float32, shape, h.device)
    x_out = torch.empty((M, R), dtype=torch.float32, device=h.device)
    if M and N:
        ORDERED_RES_SKIP_KERNEL(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(),
            x_out.data_ptr(), skip.data_ptr(), M, N, K, R, int(round_x),
            build.current_stream(h.device))
    return x_out
