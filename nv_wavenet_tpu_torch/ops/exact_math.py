"""Bit-identical fp32 transcendentals (exp / tanh / sigmoid) and the
canonical softmax + sampler, in PyTorch, plus the wrappers of their CUDA
kernels.

The port's copy of `nv_wavenet_tpu/ops/exact_math.py`.  The exact-match
contract needs every implementation to produce the same fp32 bits, so the
plain versions below perform the SAME op sequence, in the same Estrin
association, as the JAX library, its numpy twins and the C++ twin
(`csrc/exact_math.h`); the CUDA twin is `csrc/exact_math.cuh`.  Rules that
keep eager torch exactly rounded:

  * each op is its own torch op (eager mode rounds every result to fp32);
  * no fused ops (`addcmul`, `alpha=`);
  * every constant is a Python float holding an exact fp32 value, so
    torch's cast of the scalar to the tensor's float32 is lossless and the
    arithmetic runs in float32;
  * 2^k is built from exponent bits: ((k.int() + 127) << 23).view(float32).

Algorithms (constants from tools/gen_exact_math_coeffs.py):
  exp:  Cody-Waite reduction x = k ln2 + r, degree-6 Estrin polynomial for
        e^r, scale by 2^k; input clamped to [-87, 88].
  recip_1p: 1/(1+e) for e in [0, 1], one degree-9 polynomial, no division.
  tanh: |x| < 0.5: x + x^3 q(x^2); else 1 - 2 e2 recip_1p(e2), e2 = exp(-2|x|).
  sigmoid: e = exp(-|x|); r = recip_1p(e); x >= 0 -> r, x < 0 -> e r.
  sampler: e = exp(za - max), fixed-tree (Hillis-Steele) prefix sum, count
        of bins with cum <= sel * sum, silence_bin when that count is A.

`exact_fn` and `sample_from_logits` take a tensor on the CPU to the plain
version and a CUDA tensor to the kernel (K0a / K0b), never one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from nv_wavenet_tpu_torch.utils import build


def _f32(h: str) -> float:
    return float(np.float32(float.fromhex(h)))


LOG2E = _f32("0x1.715476p+0")
LN2_HI = _f32("0x1.62e400p-1")   # 12 trailing zero bits
LN2_LO = _f32("0x1.7f7d1cp-20")
EXP_LO = -87.0
EXP_HI = 88.0

# e^r on [-ln2/2, ln2/2], ASCENDING order E0..E6 (E0 = E1 = 1 exactly)
EXP_C = tuple(_f32(h) for h in (
    "0x1.000000p+0",    # E0
    "0x1.000000p+0",    # E1
    "0x1.000000p-1",    # E2
    "0x1.55547cp-3",    # E3
    "0x1.5554acp-5",    # E4
    "0x1.123d86p-7",    # E5
    "0x1.6d7536p-10",   # E6
))

# q(u) with tanh(x) = x + x^3 * q(x^2), u in [0, 0.25], ASCENDING D0..D5
TANH_Q = tuple(_f32(h) for h in (
    "-0x1.555556p-2",   # D0
    "0x1.11110cp-3",    # D1
    "-0x1.ba1802p-5",   # D2
    "0x1.65d0fap-6",    # D3
    "-0x1.1a8ffap-7",   # D4
    "0x1.5f814ep-9",    # D5
))

# 1/(1+e) on [0, 1], degree 9, ASCENDING R0..R9
RECIP_C = tuple(_f32(h) for h in (
    "0x1.fffffep-1",    # R0
    "-0x1.fffef8p-1",   # R1
    "0x1.ffdbfcp-1",    # R2
    "-0x1.fe110ap-1",   # R3
    "0x1.f22c3cp-1",    # R4
    "-0x1.c4ffa4p-1",   # R5
    "0x1.5ccfdap-1",    # R6
    "-0x1.90ca58p-2",   # R7
    "0x1.235bd0p-3",    # R8
    "-0x1.874680p-6",   # R9
))

TANH_SMALL = 0.5
ONE = 1.0
HALF = 0.5
NEG2 = -2.0


# ---------------------------------------------------------------------------
# plain versions: any device, one exactly-rounded torch op at a time
# ---------------------------------------------------------------------------

def exp(x: torch.Tensor) -> torch.Tensor:
    """Canonical fp32 e^x.  Normative Estrin association:
    pA = E6 r2 + (E5 r + E4); pB = E3 r + E2; pC = r + 1;
    p = pA r4 + (pB r2 + pC)."""
    x = torch.clamp(x, EXP_LO, EXP_HI)
    k = torch.floor(x * LOG2E + HALF)
    r = (x - k * LN2_HI) - k * LN2_LO
    r2 = r * r
    r4 = r2 * r2
    pA = EXP_C[6] * r2 + (EXP_C[5] * r + EXP_C[4])
    pB = EXP_C[3] * r + EXP_C[2]
    pC = r + ONE
    p = pA * r4 + (pB * r2 + pC)
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * scale


def _recip_1p(e: torch.Tensor) -> torch.Tensor:
    """1/(1 + e) for e in [0, 1], division-free.  Normative Estrin:
    q_i = R_{2i+1} e + R_{2i}; h0 = q1 e2 + q0; h1 = q3 e2 + q2;
    y = q4 e8 + (h1 e4 + h0)."""
    e2 = e * e
    e4 = e2 * e2
    e8 = e4 * e4
    q0 = RECIP_C[1] * e + RECIP_C[0]
    q1 = RECIP_C[3] * e + RECIP_C[2]
    q2 = RECIP_C[5] * e + RECIP_C[4]
    q3 = RECIP_C[7] * e + RECIP_C[6]
    q4 = RECIP_C[9] * e + RECIP_C[8]
    h0 = q1 * e2 + q0
    h1 = q3 * e2 + q2
    return q4 * e8 + (h1 * e4 + h0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """Canonical fp32 tanh (both branches computed, one selected)."""
    s = torch.abs(x)
    e2 = exp(s * NEG2)
    tb = ONE - (e2 + e2) * _recip_1p(e2)
    tb = torch.where(x < 0, -tb, tb)
    # small branch, normative Estrin: a = D5u + D4; b = D3u + D2;
    # c = D1u + D0; q = (a u2 + b) u2 + c
    u = x * x
    u2 = u * u
    a = TANH_Q[5] * u + TANH_Q[4]
    b = TANH_Q[3] * u + TANH_Q[2]
    c = TANH_Q[1] * u + TANH_Q[0]
    q = (a * u2 + b) * u2 + c
    ts = x + (x * u) * q
    return torch.where(s < TANH_SMALL, ts, tb)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Canonical fp32 logistic sigmoid."""
    e = exp(-torch.abs(x))
    r = _recip_1p(e)
    return torch.where(x >= 0, r, e * r)


def fixed_tree_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis with the FIXED Hillis-Steele
    association: log2(A) rounds of x[i] + (i >= k ? x[i-k] : 0)."""
    A = x.shape[-1]
    k = 1
    while k < A:
        x = x + F.pad(x[..., :-k], (k, 0))
        k *= 2
    return x


def softmax_cumsum(za: torch.Tensor):
    """(e, cum): e = exp(za - max), cum its fixed-tree prefix sum."""
    m = torch.amax(za, dim=-1, keepdim=True)
    e = exp(za - m)
    return e, fixed_tree_cumsum(e)


def softmax_p(e: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Normalized probabilities (a tolerance-governed output; sampling never
    divides)."""
    return e / cum[..., -1:]


def select_from_cumsum(cum: torch.Tensor, sel: torch.Tensor, A: int,
                       silence_bin: int) -> torch.Tensor:
    """Count of bins with cum <= sel * sum, silence_bin when that is A.
    cum: [..., A]; sel: [..., 1] uniforms in [0, 1)."""
    thr = sel * cum[..., -1:]
    idx = torch.sum(cum <= thr, dim=-1, dtype=torch.int32)
    return torch.where(idx < A, idx, silence_bin).to(torch.int32)


def sample_from_logits_plain(za: torch.Tensor, sel: torch.Tensor,
                             silence_bin: int) -> torch.Tensor:
    """The canonical sampler: za [..., A] logits, sel [..., 1] -> [...]
    int32."""
    _, cum = softmax_cumsum(za)
    return select_from_cumsum(cum, sel, za.shape[-1], silence_bin)


PLAIN_FNS = {"exp": exp, "tanh": tanh, "sigmoid": sigmoid}

# ---------------------------------------------------------------------------
# kernel wrappers (csrc/exact_math_kernels.cu)
# ---------------------------------------------------------------------------

_FN_IDS = {"exp": 0, "tanh": 1, "sigmoid": 2}
_P = ctypes.c_void_p

# K0a: elementwise exp/tanh/sigmoid
EXACT_FN_KERNEL = build.CudaKernel(
    "exact_math_kernels.cu", "nvw_exact_fn",
    [_P, _P, ctypes.c_longlong, ctypes.c_int, _P])
# K0b: one block per row: max, exp, fixed-tree cumsum, counting select
SAMPLE_KERNEL = build.CudaKernel(
    "exact_math_kernels.cu", "nvw_sample",
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def exact_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    """Canonical exp / tanh / sigmoid of every element of `x` (float32).
    CPU tensor: the plain version; CUDA tensor: kernel K0a."""
    if name not in _FN_IDS:
        raise ValueError(f"unknown exact function {name!r}")
    if _device_kind(x) == "cpu":
        return PLAIN_FNS[name](x)
    build.check_tensor(x, "x", torch.float32, x.shape, x.device)
    y = torch.empty_like(x)
    if x.numel():
        EXACT_FN_KERNEL(x.data_ptr(), y.data_ptr(), x.numel(), _FN_IDS[name],
                        build.current_stream(x.device))
    return y


def sample_from_logits(za: torch.Tensor, sel: torch.Tensor,
                       silence_bin: int) -> torch.Tensor:
    """The canonical sampler: za [..., A] float32 logits, sel [..., 1]
    uniforms -> [...] int32 bins.  CPU tensors: the plain version; CUDA
    tensors: kernel K0b (one block per row)."""
    if _device_kind(za) == "cpu":
        if sel.device != za.device:
            raise ValueError(f"sel on {sel.device}, za on {za.device}")
        return sample_from_logits_plain(za, sel, silence_bin)
    A = za.shape[-1]
    rows = za.shape[:-1]
    build.check_tensor(za, "za", torch.float32, za.shape, za.device)
    build.check_tensor(sel, "sel", torch.float32, (*rows, 1), za.device)
    y = torch.empty(rows, dtype=torch.int32, device=za.device)
    n = y.numel()
    if n:
        SAMPLE_KERNEL(za.data_ptr(), sel.data_ptr(), y.data_ptr(), n, A,
                      silence_bin, build.current_stream(za.device))
    return y
