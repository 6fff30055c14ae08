"""The collapsed-chain ("fused") generator: kernel K6
(`csrc/fused_chain.cu`) and its plain PyTorch version, the decode tier of
`WaveNetInfer(fuse_chain=True)` and `priority="latency"`.

The port's counterpart of `nv_wavenet_tpu/ops/fused_chain.py`.  The
residual stream x_l = x_0 + sum_{j<l} (h_j Wres_j + bres_j) is folded into
the weights, so layer l's pre-activation is

    u_l = ((x_0 Wcur_l + x_{t-d} Wprev_l) + fbias_l) + cond_l
          + [h_0 .. h_{l-1}] G_l,      G_l = [Wres_j Wcur_l]_{j<l},

one product against every earlier gate output; the skip sum becomes one
[L*P] x [L*P, S] product after the last layer.  The residual stream is
still built (off the chain) because the dilation FIFOs store it.  The fold
reassociates fp32 sums, so this tier is governed by the teacher-forced
distribution (TV) contract of tests/test_fused_chain.py and
tests/test_low_precision.py, not by bit-exactness.

`fast_math` here is the TPU's single-pass DEFAULT matrix precision: both
operands of every product are rounded to bf16 (round to nearest even), the
products and the sums stay fp32.  It is neither TF32 nor nvcc's
`--use_fast_math`; the exact-math library (tanh, sigmoid, the sampler)
stays exact.  The weights entering products are stored rounded
(`prepare_weights`), the activations are rounded as they enter each
product; biases stay fp32, added outside the products as in the JAX
kernel.  JAX on the CPU computes DEFAULT as full fp32, so only the port's
CPU tests see this rounding.  `compute_dtype=torch.bfloat16` (JAX
`ops/fused_chain.py:166-241`) rounds the same operands, stores the
residual stream rounded (x_0 after its tanh, x_l after each residual add,
done in fp32) and keeps the FIFO ring as bf16; JAX's casts are explicit
there, so JAX on the CPU is its oracle.  The precisions are
`scan_generate.PRECISIONS`.

The state format is `persistent.make_persistent_generator`'s: the plain
[ring_size, B, R] FIFO ring of `init_ring`, `fifo_schedule`, and `ring` /
`y_state` updated in place, so the engine swaps generators freely and a
fused run hands its state to K1/K5 exactly.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import exact_math as em
from nv_wavenet_tpu_torch.ops import persistent, scan_generate
from nv_wavenet_tpu_torch.utils import build

FOLDED_ORDER = ("embed", "wprev", "wres", "bres", "g_pack", "wcur_cat",
                "wskip_cat", "fbias", "skipb", "out_w", "out_b", "end_w",
                "end_b")
# the folded tensors that enter products: bf16-rounded under fast_math and
# compute_dtype=torch.bfloat16
PRODUCT_WEIGHTS = ("embed", "wprev", "wres", "g_pack", "wcur_cat",
                   "wskip_cat", "out_w", "end_w")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 20 + [ctypes.c_longlong] + [_I] * 11
             + [ctypes.c_ulonglong, _P])
# K6: one CTA per batch row, all steps inside one launch; one entry point
# per (selector source, precision) instance
FUSED_KERNELS = {
    (sel, prec): build.CudaKernel(
        build.unit("fused_chain.cu", prec),
        "nvw_fused_generate" + ("" if sel == "injected" else "_" + sel)
        + ("" if prec == "exact" else "_" + prec), _ARGTYPES)
    for sel in ("injected", "forced", "prng")
    for prec in scan_generate.PRECISIONS}
_SEL = {"sample": "injected", "argmax": "injected", "forced": "forced",
        "prng": "prng"}
THREADS = 256   # csrc/fused_chain.cu kThreads


def _row_stride(R: int, pack_gates: bool = False) -> int:
    """Rows of one layer's block in g_pack and wskip_cat: R packed, else the
    TPU's 128-lane blocks (max(R, 128); the pad rows are zero)."""
    return R if pack_gates else max(R, 128)


def fold_params(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                prefold_cond: bool, pack_gates: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The collapsed-chain weights from canonical params, in fp32 on the
    params' device (`torch.matmul`, TF32 refused on the card):
    g_pack [P*L(L-1)/2, 2R] (the blocks Wres_j Wcur_l, j < l, each padded to
    P rows), wcur_cat [R, L*2R], wskip_cat [L*P, S], fbias [L, 2R]
    (cumsum(bres) Wcur, plus dil_b unless prefold_cond), skipb [1, S], and
    wprev, wres, bres."""
    L, R = cfg.num_layers, cfg.R
    P = _row_stride(R, pack_gates)
    dil_w = params["dil_w"].to(torch.float32)
    scan_generate._check_fp32_matmul(dil_w)
    rs_w = params["rs_w"].to(torch.float32)
    rs_b = params["rs_b"].to(torch.float32)
    wcur, wprev = dil_w[:, R:, :], dil_w[:, :R, :]
    wres, wskip, bres = rs_w[:, :, :R], rs_w[:, :, R:], rs_b[:, :R]

    def pad_rows(x):   # [n, R, C] -> [n * P, C]
        x = torch.nn.functional.pad(x, (0, 0, 0, P - R))
        return x.reshape(-1, x.shape[-1])

    blocks = [pad_rows(torch.matmul(wres[:l], wcur[l])) for l in range(1, L)]
    g_pack = (torch.cat(blocks) if blocks
              else torch.zeros((P, 2 * R), dtype=torch.float32,
                               device=dil_w.device))   # L == 1: never read
    bcum = torch.cat([torch.zeros_like(bres[:1]),
                      torch.cumsum(bres[:-1], dim=0)])
    fbias = torch.matmul(bcum[:, None, :], wcur)[:, 0]
    if not prefold_cond:
        fbias = fbias + params["dil_b"].to(torch.float32)
    return {"wprev": wprev, "wres": wres, "bres": bres, "g_pack": g_pack,
            "wcur_cat": wcur.permute(1, 0, 2).reshape(R, L * 2 * R),
            "wskip_cat": pad_rows(wskip), "fbias": fbias,
            "skipb": rs_b[:, R:].sum(dim=0, keepdim=True)}


def prepare_weights(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                    prefold_cond: bool, weight_dtype=torch.float32,
                    pack_gates: bool = False, fast_math: bool = False,
                    compute_dtype=torch.float32) -> tuple:
    """The fold plus embed/out_w/out_b/end_w/end_b as K6's operand tuple
    (FOLDED_ORDER), contiguous fp32 tensors on the params' device holding
    the values the storage computes with: every tensor rounded to bf16
    under weight_dtype=torch.bfloat16 (the fold itself is taken over the
    fp32 weights), and under fast_math or compute_dtype=torch.bfloat16
    also the matrices that enter products (PRODUCT_WEIGHTS).  Callers that
    reuse weights (the engine) run it once per weight upload; pack_gates
    must match the generator's."""
    persistent.check_storage(weight_dtype, False)
    lowp = scan_generate.precision(compute_dtype, fast_math) != "exact"
    folded = fold_params(params, cfg, prefold_cond, pack_gates)
    for k in ("embed", "out_w", "end_w"):
        folded[k] = params[k].to(torch.float32)
    for k in ("out_b", "end_b"):
        folded[k] = params[k].to(torch.float32).reshape(1, -1)
    out = []
    for k in FOLDED_ORDER:
        v = folded[k]
        if weight_dtype == torch.bfloat16 or (lowp
                                              and k in PRODUCT_WEIGHTS):
            v = scan_generate.round_bf16(v)
        out.append(v.contiguous())
    return tuple(out)


def folded_shapes(cfg: WaveNetConfig, pack_gates: bool = False
                  ) -> Dict[str, tuple]:
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    P = _row_stride(R, pack_gates)
    return {"embed": (2 * A, R), "wprev": (L, R, 2 * R), "wres": (L, R, R),
            "bres": (L, R), "g_pack": (max(P * L * (L - 1) // 2, P), 2 * R),
            "wcur_cat": (R, L * 2 * R), "wskip_cat": (L * P, S),
            "fbias": (L, 2 * R), "skipb": (1, S), "out_w": (S, A),
            "out_b": (1, A), "end_w": (A, A), "end_b": (1, A)}


class FusedPlan(NamedTuple):
    """K6's shared-memory plan (`fused_plan`)."""
    row_stride: int     # P: rows of a layer's block in g_pack / wskip_cat
    smem_bytes: int     # dynamic shared memory K6 asks for


def _splits(n_columns: int) -> int:
    """Ranges a product's K terms split into: columns go four to a thread,
    and the threads left over take further ranges of K (fused_chain.cu
    block_matvec_parts)."""
    return max(1, THREADS // (n_columns // 4))


def fused_plan(cfg: WaveNetConfig, pack_gates: bool = False) -> FusedPlan:
    """K6's shared memory: the step's activations of one row, x_0 [R] and
    its operand copy [R], the FIFO reads [L*R], u [L*2R], the gates [L*R],
    skip [S], zs, za and two prefix buffers [A], and the partial sums of
    the split products.  Raises ValueError for a geometry K6 cannot run: R,
    S or A not a multiple of 8 (it loads four columns at a time, eight rows
    at a time), or activations beyond one block's 227 KB.  There is no
    fallback to the exact kernel."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    for name, n in (("R", R), ("S", S), ("A", A)):
        if n % 8:
            raise ValueError(f"K6 needs {name} a multiple of 8, got {n}")
    part = max(_splits(n) * n for n in (2 * R, S, A))
    floats = 2 * R + 4 * L * R + S + 4 * A + part
    smem = 4 * floats
    budget = persistent.SMEM_PER_BLOCK - persistent._STATIC_SMEM
    if smem > budget:
        raise ValueError(f"K6 keeps one row's activations in shared memory: "
                         f"{smem} bytes at L={L}, R={R}, S={S}, A={A}, more "
                         f"than the {budget} a block may use")
    return FusedPlan(_row_stride(R, pack_gates), smem)


def generate_fused_plain(cfg: WaveNetConfig, weights: tuple, t0: int,
                         cond: torch.Tensor, sel: torch.Tensor,
                         ring: torch.Tensor, y_state: torch.Tensor,
                         n_valid: int, mode: str = "sample", seed: int = 0,
                         fast_math: bool = False, pack_gates: bool = False,
                         compute_dtype=torch.float32):
    """The plain version of K6, on any device, in the JAX kernel's
    association (`_do_sample_step`): per step the embedding and exact tanh;
    all L x_{t-d} Wprev_l from the FIFO, read before any write of the step;
    one x_0 wcur_cat; per layer u = ((w0_l + pt_l) + fbias_l) + cond_l,
    then u + hbuf[:, :l*P] G_l for l > 0, h = tanh(u[:R]) * sigmoid(u[R:]);
    skip = relu(hbuf wskip_cat + skipb), zs, za; the sampler; and the
    residual stream x_l = (x_{l-1} + h_{l-1} Wres_{l-1}) + bres_{l-1} for
    the FIFO writes.  Under fast_math and compute_dtype=torch.bfloat16
    every product takes bf16-rounded activations (the weights arrive
    rounded); under bf16 x_0 and each x_l are stored rounded and the ring
    is bf16.  Outputs as `make_fused_generator`'s."""
    (embed, wprev, wres, bres, g_pack, wcur_cat, wskip_cat, fbias, skipb,
     out_w, out_b, end_w, end_b) = weights
    scan_generate._check_fp32_matmul(cond)
    prec = scan_generate.precision(compute_dtype, fast_math)
    scan_generate.check_ring(ring, prec)
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    P = _row_stride(R, pack_gates)
    T, _, B, _ = cond.shape
    dev = cond.device
    q, st = scan_generate.roundings(prec)   # an operand, the stored x
    if mode == "prng":
        sel = torch.from_numpy(scan_generate.prng_uniform_sel(
            seed, np.arange(t0, t0 + n_valid), B)).to(dev)
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    p_seq = (torch.zeros((T, B, A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    y_prev, y_cur = y_state[0].clone(), y_state[1].clone()
    for j in range(n_valid):
        t = t0 + j
        slots = [off + (t & (d - 1))
                 for off, d in zip(cfg.ring_offsets, cfg.dilations)]
        x0 = st(scan_generate.embed_lookup(embed, y_prev, y_cur, A,
                                           cfg.tanh_embed))
        xp = ring[slots].to(torch.float32)                 # [L, B, R]
        pts = torch.bmm(q(xp), wprev)                      # [L, B, 2R]
        w0 = q(x0) @ wcur_cat                              # [B, L*2R]
        hbuf = torch.zeros((B, L * P), dtype=torch.float32, device=dev)
        hs = []
        for l in range(L):
            u = ((w0[:, l * 2 * R:(l + 1) * 2 * R] + pts[l]) + fbias[l]
                 ) + cond[j, l]
            if l > 0:
                off = P * (l * (l - 1) // 2)
                u = u + q(hbuf[:, :l * P]) @ g_pack[off:off + l * P]
            h = em.tanh(u[:, :R]) * em.sigmoid(u[:, R:])
            hbuf[:, l * P:l * P + R] = h
            hs.append(h)
        skip = torch.clamp_min(q(hbuf) @ wskip_cat + skipb[0], 0.0)
        zs = torch.clamp_min(q(skip) @ out_w + out_b[0], 0.0)
        za = q(zs) @ end_w + end_b[0]
        if mode == "argmax":
            y_t = torch.argmax(za, dim=-1).to(torch.int32)
        else:
            e, cum = em.softmax_cumsum(za)
            if mode == "forced":
                y_t = sel[j].to(torch.int32)
                p_seq[j] = em.softmax_p(e, cum)
            else:
                y_t = em.select_from_cumsum(cum, sel[j][:, None], A,
                                            cfg.silence_bin)
        x = x0
        for l in range(L):
            if l > 0:
                x = st((x + q(hs[l - 1]) @ wres[l - 1]) + bres[l - 1])
            ring[slots[l]] = x.to(ring.dtype)
        y_prev, y_cur = y_cur, y_t
        y[j] = y_t
    y_state[0] = y_prev
    y_state[1] = y_cur
    out = (y, ring, y_state)
    return out + (p_seq,) if mode == "forced" else out


def _launch_fused(cfg: WaveNetConfig, plan: FusedPlan, weights: tuple,
                  sched: torch.Tensor, t0: int, cond: torch.Tensor,
                  sel: torch.Tensor, ring: torch.Tensor,
                  y_state: torch.Tensor, n_valid: int, mode: str,
                  prec: str, seed: int):
    T, _, B, _ = cond.shape
    dev = cond.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    # zeros: K6 writes no step past n_valid
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    for name, t in zip(FOLDED_ORDER + ("cond",), weights + (cond,)):
        if t.data_ptr() % 16:
            raise ValueError(f"K6 loads {name} in 16-byte units: it must "
                             f"start on a 16-byte boundary")
    if n_valid:
        FUSED_KERNELS[(_SEL[mode], prec)](
            *(w.data_ptr() for w in weights), cond.data_ptr(),
            None if mode == "prng" else sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
            None if p_seq is None else p_seq.data_ptr(), t0, n_valid, B,
            cfg.num_layers, cfg.R, cfg.S, cfg.A, plan.row_stride,
            int(cfg.tanh_embed), cfg.silence_bin, int(mode == "argmax"),
            plan.smem_bytes, seed & 0xFFFFFFFFFFFFFFFF,
            build.current_stream(dev))
    out = (y, ring, y_state)
    return out + (p_seq,) if mode == "forced" else out


def make_fused_generator(cfg: WaveNetConfig, batch: int,
                         mode: str = "sample", weight_dtype=torch.float32,
                         fast_math: bool = False, prefold_cond: bool = False,
                         pack_gates: bool = False,
                         compute_dtype=torch.float32):
    """Build `generate(params_or_prepared, t0, cond, sel, ring, y_state,
    n_valid=None, seed=0)` with `persistent.make_persistent_generator`'s
    call and state format: cond [T, L, B, 2R] (dil_b folded in when
    prefold_cond, else raw: fbias then carries dil_b), sel [T, B], ring
    [ring_size, B, R] from `init_ring`, y_state [2, B] int32, both updated
    in place.  `params_or_prepared` is a canonical params dict (folded
    inline) or the tuple of `prepare_weights` with this generator's
    prefold_cond, weight_dtype, pack_gates, fast_math and compute_dtype.
    The ring is bf16 under compute_dtype=torch.bfloat16 (`init_ring` with
    `scan_generate.ring_dtype`), else fp32.

    Modes: "sample", "argmax", "prng" (Philox selectors,
    `scan_generate.prng_uniform_sel`) and "forced" (sel holds the symbols;
    p_seq [T, B, A] is appended).  There is no dump: the activation getters
    use the exact kernel.  A CUDA tensor launches K6, a CPU tensor runs
    `generate_fused_plain`; neither falls back to the other.  A geometry
    K6 cannot run raises ValueError here (`fused_plan`)."""
    if mode not in scan_generate.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    persistent.check_storage(weight_dtype, False)
    prec = scan_generate.precision(compute_dtype, fast_math)
    plan = fused_plan(cfg, pack_gates)
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    B = batch
    shapes = folded_shapes(cfg, pack_gates)
    scheds: Dict[torch.device, torch.Tensor] = {}

    def generate(params, t0: int, cond: torch.Tensor, sel: torch.Tensor,
                 ring: torch.Tensor, y_state: torch.Tensor,
                 n_valid: int | None = None, seed: int = 0):
        dev = cond.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        weights = (prepare_weights(params, cfg, prefold_cond, weight_dtype,
                                   pack_gates, fast_math, compute_dtype)
                   if isinstance(params, dict) else tuple(params))
        T = cond.shape[0]
        check_t = build.check_tensor
        check_t(cond, "cond", torch.float32, (T, L, B, 2 * R), dev)
        check_t(sel, "sel", torch.float32, (T, B), dev)
        check_t(ring, "ring", scan_generate.ring_dtype(prec),
                (cfg.ring_size, B, R), dev)
        check_t(y_state, "y_state", torch.int32, (2, B), dev)
        if len(weights) != len(FOLDED_ORDER):
            raise ValueError(f"expected the {len(FOLDED_ORDER)} tensors of "
                             f"prepare_weights, got {len(weights)}")
        for k, w in zip(FOLDED_ORDER, weights):
            check_t(w, k, torch.float32, shapes[k], dev)
        n_valid = T if n_valid is None else int(n_valid)
        if not 0 <= n_valid <= T:
            raise ValueError(f"n_valid={n_valid} outside [0, T={T}]")
        t0 = int(t0)
        if t0 < 0:
            raise ValueError(f"t0={t0} must be >= 0")
        if mode == "forced":
            sym = sel[:n_valid]
            if not bool(((sym >= 0) & (sym < A) & (sym == sym.floor()))
                        .all()):
                raise ValueError(f"mode 'forced': sel must hold symbols, "
                                 f"integers in [0, A={A})")
        if dev.type == "cpu":
            return generate_fused_plain(cfg, weights, t0, cond, sel, ring,
                                        y_state, n_valid, mode, int(seed),
                                        fast_math, pack_gates, compute_dtype)
        if dev not in scheds:
            scheds[dev] = persistent.fifo_schedule(cfg, dev)
        return _launch_fused(cfg, plan, weights, scheds[dev], t0, cond, sel,
                             ring, y_state, n_valid, mode, prec, int(seed))

    return generate
