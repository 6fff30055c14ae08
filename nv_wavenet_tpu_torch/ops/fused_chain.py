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

Two kernels compute K6 on the card, and `fused_route` names the one a
generator launches, before any launch: the cluster K6 (`csrc/fused_chain.cu`,
`cluster_plan`: a thread-block cluster of CLUSTER CTAs per group of rows,
each CTA streaming its slice of the folded stacks, `cluster_stream`, by TMA,
the G products off the chain) wherever its plan holds, else the first K6
(`csrc/fused_chain_first.cu`, `fused_plan`: one CTA per row, the weights
read from L2), with the cluster plan's error as the note.  A geometry the
first K6 cannot run has no K6.  `cluster_model` is the plain model of the
cluster K6's sums, in its order.
"""

from __future__ import annotations

import ctypes
import math
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


def _instances(source: str, prefix: str, argtypes) -> dict:
    """One entry point per (selector source, precision) instance."""
    return {(sel, prec): build.CudaKernel(
        build.unit(source, prec),
        prefix + ("" if sel == "injected" else "_" + sel)
        + ("" if prec == "exact" else "_" + prec), argtypes)
        for sel in ("injected", "forced", "prng")
        for prec in scan_generate.PRECISIONS}


# K6: a thread-block cluster per group of rows, all steps inside one launch
FUSED_KERNELS = _instances(
    "fused_chain.cu", "nvw_fused_generate",
    [_P] * 14 + [ctypes.c_longlong] * 2 + [_I] * 14
    + [ctypes.c_ulonglong, _P])
# the first K6: one CTA per batch row, where `cluster_plan` raises
FIRST_FUSED_KERNELS = _instances(
    "fused_chain_first.cu", "nvw_first_fused_generate",
    [_P] * 20 + [ctypes.c_longlong] + [_I] * 11 + [ctypes.c_ulonglong, _P])
_SEL = {"sample": "injected", "argmax": "injected", "forced": "forced",
        "prng": "prng"}
THREADS = 256   # csrc/fused_chain_first.cu kThreads
CLUSTER = 8                # csrc/fused_chain.cu kCluster: CTAs a group
CLUSTER_THREADS = 256      # kWorkers: the threads that own product tiles
CLUSTER_MAX_ROWS = 2       # kMaxRows: rows a group, at most (y's slots)
CLUSTER_H_SLOTS = 3        # kHSlots
CLUSTER_SLOT_BYTES = 32768  # a ring slot, unless 4 rows of a matrix need more
CLUSTER_MAX_SLOTS = 6
_Y_BYTES = 4 * 3 * CLUSTER_MAX_ROWS   # y_prev, y_cur, the step's y


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
    """The first K6's shared-memory plan (`fused_plan`)."""
    row_stride: int     # P: rows of a layer's block in g_pack / wskip_cat
    smem_bytes: int     # dynamic shared memory K6 asks for


def _splits(n_columns: int) -> int:
    """Ranges a product's K terms split into: columns go four to a thread,
    and the threads left over take further ranges of K (fused_chain.cu
    block_matvec_parts)."""
    return max(1, THREADS // (n_columns // 4))


def fused_plan(cfg: WaveNetConfig, pack_gates: bool = False) -> FusedPlan:
    """The first K6's shared memory: the step's activations of one row, x_0 [R] and
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


class ClusterPlan(NamedTuple):
    """The cluster K6's plan (`cluster_plan`)."""
    cluster: int             # CTAs of a group's cluster (CLUSTER)
    rows: int                # rows of a group
    groups: int              # clusters of the launch
    widths: tuple            # a CTA's columns (u_l, skip, x padded to 4, zs/za)
    matrices: tuple          # (K, W) of each matrix of a step's stream
    piece_rows: tuple        # rows of each matrix one copy brings
    chunks: int              # copies a step
    step_bytes: int          # one CTA's stream (one step)
    slot_bytes: int          # a ring slot
    slots: int
    activation_floats: int   # the floats beside the ring
    smem_bytes: int          # dynamic shared memory of the launch


def cluster_widths(cfg: WaveNetConfig) -> tuple:
    """(wu, ws, wr, wa): the columns a CTA owns of u_l (R/CLUSTER column
    pairs), skip, the residual stream (R/CLUSTER, padded to a multiple of 4
    with zero columns) and zs / za."""
    half = cfg.R // CLUSTER
    return 2 * half, cfg.S // CLUSTER, -(-half // 4) * 4, cfg.A // CLUSTER


def cluster_matrices(cfg: WaveNetConfig) -> list:
    """The matrices of one step's stream, in the order the cluster K6
    consumes them, as (name, l, K, W): Wprev of every layer (each column
    block takes its layer's x_{t-d}), Wcur of every layer, then for l = 1
    .. L-1 G_{l-1,l} ("crit", on the chain) and [G_{l-1,l+1} .. G_{l-1,L-1}
    | Wskip_{l-1} | Wres_{l-1}] ("off"), then Wskip_{L-1}, out_w, end_w."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    wu, ws, wr, wa = cluster_widths(cfg)
    mats = [("prev", 0, R, L * wu), ("cur", 0, R, L * wu)]
    for l in range(1, L):
        mats += [("crit", l, R, wu), ("off", l, R, (L - 1 - l) * wu + ws + wr)]
    return mats + [("skip", L - 1, R, ws), ("out", 0, S, wa),
                   ("end", 0, A, wa)]


def _piece_rows(K: int, W: int, slot_bytes: int) -> int:
    """Rows of a fp32 [K, W] matrix one copy brings: whole 4-row groups that
    fit a slot (csrc/fused_chain.cu piece_rows)."""
    return min(K, slot_bytes // (W * 4) & ~3)



def cluster_plan(cfg: WaveNetConfig, batch: int, prec: str = "exact"
                 ) -> ClusterPlan:
    """Decide the cluster K6's groups, ring and stream for `batch` rows in
    precision `prec`.

    Each group of rows is a cluster of CLUSTER CTAs, CTA c owning the
    columns `cluster_widths` gives (u_l's column pairs i, R + i for i in
    [c R/8, (c+1) R/8), and R/8, S/8, A/8 of the others), so R must be a
    multiple of 16 (R/8 column pairs in tiles of 4 columns) and S and A of
    32.  A group is the most rows of (2, 1) that divide the batch and
    whose activations fit beside a ring of three slots (two for one row,
    at the least): the FIFO
    reads of every layer, x_0, both halves of u's base, the running sums,
    CLUSTER_H_SLOTS buffers of h, skip, zs, the sums of the output stack,
    za and the sampler's buffers, x's slice and the rows' y.  More rows a
    group would share each staged byte more, but every CTA computes the
    products of all its group's rows on its own SM, whose products are
    bound by their chains, not by the bytes: at the flagship, B=16, groups
    of 2 rows ran 6-7% faster than groups of 4 on an H100 (PERF.md).  A slot is CLUSTER_SLOT_BYTES, or 4 rows of the widest matrix
    where that is more; a copy brings whole 4-row groups of one matrix
    (`_piece_rows`).  The stream is fp32 in every precision: under fast_math
    and bf16 its values are bf16 values, and staging them as bf16 measured
    slower on an H100 (the widening sat on the products' chain, PERF.md).
    Raises ValueError for a geometry it cannot hold."""
    scan_generate._check_precision(prec)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    for name, n, m in (("R", R, 16), ("S", S, 32), ("A", A, 32)):
        if n % m:
            raise ValueError(f"the cluster K6 splits {name} over {CLUSTER} "
                             f"CTAs in 4-column tiles: {name} = {n} must be a "
                             f"multiple of {m}")
    wu, ws, wr, wa = cluster_widths(cfg)
    mats = [(K, W) for _, _, K, W in cluster_matrices(cfg)]
    slot = max(CLUSTER_SLOT_BYTES, -(-16 * max(W for _, W in mats) // 128)
               * 128)
    pieces = tuple(_piece_rows(K, W, slot) for K, W in mats)
    for rows in (2, 1):
        if batch % rows:
            continue
        act = (L * rows * R + rows * R + 2 * rows * L * wu
               + rows * (L * wu + ws + wr) + CLUSTER_H_SLOTS * rows * R
               + rows * S + rows * A + rows * wa + 3 * A + rows * wr)
        budget = (persistent.SMEM_PER_BLOCK - persistent._STATIC_SMEM
                  - 4 * act - _Y_BYTES)
        slots = min(CLUSTER_MAX_SLOTS, (budget - 16) // (slot + 8))
        if slots >= (2 if rows == 1 else 3):
            break
    else:
        raise ValueError(f"the cluster K6 needs two ring slots of {slot} "
                         f"bytes beside one row's activations ({4 * act} "
                         f"bytes) in {persistent.SMEM_PER_BLOCK} bytes of "
                         f"shared memory")
    smem = slots * slot + -(-8 * slots // 16) * 16 + 4 * act + _Y_BYTES
    chunks = sum(-(-K // p) for (K, _), p in zip(mats, pieces))
    return ClusterPlan(CLUSTER, rows, batch // rows, (wu, ws, wr, wa),
                       tuple(mats), pieces, chunks,
                       sum(K * W for K, W in mats) * 4, slot, slots, act,
                       smem)


def _cluster_blocks(weights: tuple, cfg: WaveNetConfig, pack_gates: bool):
    """The folded stacks as the cluster K6 reads them, fp32: wprev [L, R,
    2R], wcur [L, R, 2R], g(j, l) -> G_{j,l} [R, 2R], wskip(j) -> [R, S],
    wres [L, R, R], out_w, end_w; only the R real rows of a g_pack /
    wskip_cat block."""
    (_, wprev, wres, _, g_pack, wcur_cat, wskip_cat, _, _, out_w, _, end_w,
     _) = weights
    L, R = cfg.num_layers, cfg.R
    P = _row_stride(R, pack_gates)
    wcur = wcur_cat.view(R, L, 2 * R).permute(1, 0, 2)

    def g(j, l):
        o = P * (l * (l - 1) // 2 + j)
        return g_pack[o:o + R]
    return (wprev, wcur, g, lambda j: wskip_cat[j * P:j * P + R], wres,
            out_w, end_w)


def cluster_slices(weights: tuple, cfg: WaveNetConfig,
                   pack_gates: bool = False) -> list:
    """Each CTA's matrices of one step, in `cluster_matrices`' order, as
    fp32 [CLUSTER, K, W] tensors (CTA c's slice of each): the columns of
    `cluster_widths` (u_l's pairs: the tanh half's R/8 columns, then the
    sigmoid half's), Wres_j's slice padded with zero columns to wr."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    wu, ws, wr, wa = cluster_widths(cfg)
    half = R // CLUSTER
    wprev, wcur, g, wskip, wres, out_w, end_w = _cluster_blocks(
        weights, cfg, pack_gates)
    dev = wprev.device
    cu = torch.stack([torch.cat([torch.arange(c * half, (c + 1) * half),
                                 R + torch.arange(c * half, (c + 1) * half)])
                      for c in range(CLUSTER)]).to(dev)        # [8, wu]
    cs = torch.arange(S, device=dev).view(CLUSTER, ws)
    ca = torch.arange(A, device=dev).view(CLUSTER, wa)
    cr = torch.arange(R, device=dev).view(CLUSTER, half)

    def cols(w, idx):   # [K, N] -> [8, K, idx.shape[1]]
        return w[:, idx].permute(1, 0, 2)

    def res(j):         # Wres_j's slices, padded to wr columns
        return torch.nn.functional.pad(cols(wres[j], cr), (0, wr - half))
    out = []
    for name, l, _, _ in cluster_matrices(cfg):
        if name in ("prev", "cur"):
            src = wprev if name == "prev" else wcur
            out.append(torch.cat([cols(src[m], cu) for m in range(L)], -1))
        elif name == "crit":
            out.append(cols(g(l - 1, l), cu))
        elif name == "off":
            out.append(torch.cat(
                [cols(g(l - 1, m), cu) for m in range(l + 1, L)]
                + [cols(wskip(l - 1), cs), res(l - 1)], -1))
        elif name == "skip":
            out.append(cols(wskip(L - 1), cs))
        else:
            out.append(cols(out_w if name == "out" else end_w, ca))
    return out


def cluster_stream(weights: tuple, cfg: WaveNetConfig, plan: ClusterPlan,
                   pack_gates: bool = False) -> torch.Tensor:
    """The cluster K6's weight stream, [CLUSTER, step elements] fp32: row c
    is CTA c's matrices (`cluster_slices`), each row-major, in the order a
    step consumes them.  Built once per prepared weights."""
    out = torch.cat([m.reshape(CLUSTER, -1) for m in
                     cluster_slices(weights, cfg, pack_gates)], 1)
    out = out.to(torch.float32).contiguous()
    if out.numel() * out.element_size() != CLUSTER * plan.step_bytes:
        raise ValueError(f"the stream holds {out.numel() * out.element_size()}"
                         f" bytes, the plan {CLUSTER * plan.step_bytes}")
    return out


class FusedRoute(NamedTuple):
    """The K6 a fused generator launches (`fused_route`)."""
    kernel: str          # "cluster" (csrc/fused_chain.cu) or "first"
    plan: object         # ClusterPlan or FusedPlan
    note: str | None     # why the cluster plan was not taken

    def cuda_kernel(self, mode: str, prec: str = "exact"
                    ) -> build.CudaKernel:
        """The entry point (and launch count) of mode `mode` in `prec`."""
        table = (FUSED_KERNELS if self.kernel == "cluster"
                 else FIRST_FUSED_KERNELS)
        return table[(_SEL[mode], prec)]


def fused_route(cfg: WaveNetConfig, batch: int, prec: str = "exact",
                pack_gates: bool = False) -> FusedRoute:
    """Name the K6 a fused generator's calls run on the card, before any
    launch and without a card: the cluster K6 where `cluster_plan` holds,
    else the first K6 with the cluster plan's error as the note.  K6 runs
    where the first K6's plan holds (`fused_plan` raises ValueError
    elsewhere, as it always has), so the geometries no K6 runs do not
    change."""
    first = fused_plan(cfg, pack_gates)
    try:
        return FusedRoute("cluster", cluster_plan(cfg, batch, prec), None)
    except ValueError as err:
        return FusedRoute("first", first, str(err))


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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         ties: bool = True) -> torch.Tensor:
    """a * b + c rounded once to fp32, as __fmaf_rn.  The fp32 product is
    exact in fp64; the fp64 sum s is rounded to fp32.  That second rounding
    differs from one rounding only where s lands exactly on the midpoint of
    two fp32 values while the exact sum does not: there s is moved one fp64
    step towards the exact sum (its TwoSum error) before it is rounded.
    With `ties` False that check is skipped, which is exact where a and b
    are bf16 values (fast_math and bf16): the product then has 16
    significant bits, so s is the exact sum, or the smaller term lies below
    2^-29 of the larger and s cannot land on a midpoint."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    if ties:
        tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
        if bool(tie.any()):
            bb = s - p
            err = (p - (s - bb)) + (cd - bb)
            toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
            s = torch.where(tie & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def cluster_model(cfg: WaveNetConfig, plan: ClusterPlan,
                  stream: torch.Tensor, weights: tuple, t0: int,
                  cond: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
                  y_state: torch.Tensor, n_valid: int, mode: str = "sample",
                  seed: int = 0, prec: str = "exact"):
    """The plain model of the cluster K6 (`csrc/fused_chain.cu`), on any
    device: its sums in its order, read from its stream.  CTA by CTA (the
    leading axis of every sum: CTA c's column slices of `cluster_slices`),
    every row at once (a row's sums never take another row's terms, so the
    groups of `plan.rows` rows the kernel runs share no arithmetic), per
    step: x_{t-d} Wprev_l and
    x_0 Wcur_l from 0; base_l = ((x_0 Wcur_l + x_{t-d} Wprev_l) + fbias_l)
    + cond_l; the running sums of u_l's G terms, skip and the residual
    product, each column from 0 in the stream's order (j = 0, 1, ..., then
    k within j), one FMA a term (`_fma`); u_l = base_l + its sum (base_0
    alone); the gate; skip, zs, za; the sampler of `generate_fused_plain`;
    x_l = (x_{l-1} + h_{l-1} Wres_{l-1}) + bres_{l-1} and the FIFO writes.
    Outputs as `make_fused_generator`'s.  It differs from
    `generate_fused_plain` only in the order of the sums."""
    embed, bres, fbias, skipb, out_b, end_b = (
        weights[i] for i in (0, 3, 7, 8, 10, 12))
    scan_generate.check_ring(ring, prec)
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    wu, ws, wr, wa = plan.widths
    half, LW = R // CLUSTER, L * wu
    T, _, B, _ = cond.shape
    C = CLUSTER
    dev = cond.device
    q, st = scan_generate.roundings(prec)
    # the stream un-laid: [C, K, W] fp32 per matrix
    flat = stream.reshape(C, -1).to(torch.float32)
    mats, o = [], 0
    for K, W in plan.matrices:
        mats.append(flat[:, o:o + K * W].reshape(C, K, W))
        o += K * W
    cu = torch.stack([torch.cat([torch.arange(c * half, (c + 1) * half),
                                 R + torch.arange(c * half, (c + 1) * half)])
                      for c in range(C)]).to(dev)              # [C, wu]

    def full(x):        # [C, B, w] slices -> [B, C * w]
        return x.permute(1, 0, 2).reshape(x.shape[1], -1)

    def consume(m, op, acc):
        """acc [C, B, W] += op_k w[k], k in order, one FMA a term; op(k)
        -> [B, W] or [B, 1], the operand of every CTA."""
        w = mats[m]
        for k in range(w.shape[1]):
            acc = _fma(op(k)[None], w[:, k][:, None, :], acc,
                       prec == "exact")
        return acc

    if mode == "prng":
        sel = torch.from_numpy(scan_generate.prng_uniform_sel(
            seed, np.arange(t0, t0 + n_valid), B)).to(dev)
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    p_seq = (torch.zeros((T, B, A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)  # noqa: E731
    y_prev, y_cur = y_state[0].clone(), y_state[1].clone()
    for j in range(n_valid):
        t = t0 + j
        slots = [off + (t & (d - 1))
                 for off, d in zip(cfg.ring_offsets, cfg.dilations)]
        xp = q(ring[slots].to(torch.float32))      # [L, B, R]
        pp = consume(0, lambda k: xp[:, :, k].T.repeat_interleave(
            wu, dim=1), zeros(C, B, LW))
        x = scan_generate.embed_lookup(embed, y_prev, y_cur, A,
                                       cfg.tanh_embed)
        x0op, x = q(x), st(x)
        pc = consume(1, lambda k: x0op[:, k:k + 1], zeros(C, B, LW))
        fb = fbias[:, cu].permute(1, 0, 2).reshape(C, 1, LW)
        cd = cond[j][:, :, cu].permute(2, 1, 0, 3).reshape(
            C, B, LW)
        base = ((pc + pp) + fb) + cd
        D = zeros(C, B, LW + ws + wr)
        hs, ress = [], []
        for l in range(L):
            lo = slice(l * wu, (l + 1) * wu)
            if l:
                D[:, :, lo] = consume(2 * l, lambda k: hs[l - 1][:, k:k + 1],
                                      D[:, :, lo])
            u = base[:, :, lo] + D[:, :, lo] if l else base[:, :, lo]
            hs.append(q(full(em.tanh(u[..., :half])
                             * em.sigmoid(u[..., half:]))))
            if l:
                rest = slice((l + 1) * wu, None)
                D[:, :, rest] = consume(
                    2 * l + 1, lambda k: hs[l - 1][:, k:k + 1],
                    D[:, :, rest])
                # h_{l-1} Wres_{l-1} on each CTA's R/8 columns; the
                # region starts from 0 for the next layer
                ress.append(full(D[:, :, LW + ws:LW + ws + half]))
                D[:, :, LW + ws:] = 0.0
        D[:, :, LW:LW + ws] = consume(2 * L, lambda k: hs[L - 1][:, k:k + 1],
                                      D[:, :, LW:LW + ws])
        skip = q(full(torch.clamp_min(
            D[:, :, LW:LW + ws] + skipb[0].view(C, 1, ws), 0.0)))
        zs = q(full(torch.clamp_min(consume(
            2 * L + 1, lambda k: skip[:, k:k + 1], zeros(C, B, wa))
            + out_b[0].view(C, 1, wa), 0.0)))
        za = full(consume(2 * L + 2, lambda k: zs[:, k:k + 1],
                          zeros(C, B, wa)) + end_b[0].view(C, 1, wa))
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
        # the residual stream and the FIFO writes
        for l in range(L):
            if l:
                x = st((x + ress[l - 1]) + bres[l - 1])
            ring[slots[l]] = x.to(ring.dtype)
        y_prev, y_cur = y_cur, y_t
        y[j] = y_t
    y_state[0] = y_prev
    y_state[1] = y_cur
    out = (y, ring, y_state)
    return out + (p_seq,) if mode == "forced" else out


def _launch_cluster(cfg: WaveNetConfig, plan: ClusterPlan, weights: tuple,
                    stream: torch.Tensor, sched: torch.Tensor, t0: int,
                    cond: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
                    y_state: torch.Tensor, n_valid: int, mode: str,
                    prec: str, seed: int):
    T, _, B, _ = cond.shape
    dev = cond.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    # zeros: K6 writes no step past n_valid
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    if n_valid:
        FUSED_KERNELS[(_SEL[mode], prec)](
            stream.data_ptr(),
            *(weights[i].data_ptr() for i in (0, 3, 7, 8, 10, 12)),
            cond.data_ptr(), None if mode == "prng" else sel.data_ptr(),
            sched.data_ptr(), ring.data_ptr(), y_state.data_ptr(),
            y.data_ptr(), None if p_seq is None else p_seq.data_ptr(), t0,
            plan.step_bytes, n_valid, B, cfg.num_layers, cfg.R, cfg.S,
            cfg.A, plan.rows, plan.slot_bytes, plan.slots, plan.chunks,
            int(cfg.tanh_embed), cfg.silence_bin, int(mode == "argmax"),
            plan.smem_bytes, seed & 0xFFFFFFFFFFFFFFFF,
            build.current_stream(dev))
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
        FIRST_FUSED_KERNELS[(_SEL[mode], prec)](
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
                         compute_dtype=torch.float32,
                         route: FusedRoute | None = None):
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
    use the exact kernel.  A CUDA tensor launches K6 (the kernel
    `fused_route` names, kept on the generator as `.route`: the cluster K6
    on its stream, `cluster_stream`, made once per prepared weights, or
    the first K6), a CPU tensor runs `generate_fused_plain`; neither falls
    back to the other.  A geometry K6 cannot run raises ValueError here
    (`fused_plan`).  `route` names the first K6 in place of `fused_route`'s
    choice, for a check that holds the two kernels against each other
    (FusedRoute("first", fused_plan(cfg, pack_gates), note))."""
    if mode not in scan_generate.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    persistent.check_storage(weight_dtype, False)
    prec = scan_generate.precision(compute_dtype, fast_math)
    if route is None:
        route = fused_route(cfg, batch, prec, pack_gates)
    elif route.kernel != "first" or route.plan != fused_plan(cfg, pack_gates):
        raise ValueError("only the first K6 (FusedRoute('first', fused_plan("
                         "cfg, pack_gates), note)) may be named")
    plan = route.plan
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    B = batch
    shapes = folded_shapes(cfg, pack_gates)
    scheds: Dict[torch.device, torch.Tensor] = {}
    streams: Dict[str, object] = {}   # the last prepared weights' stream

    def stream_of(weights):
        key = tuple(w._version for w in weights)
        old = streams.get("weights")
        if (old is None or streams["key"] != key
                or any(a is not b for a, b in zip(old, weights))):
            streams.update(weights=weights, key=key, stream=cluster_stream(
                weights, cfg, plan, pack_gates))
        return streams["stream"]

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
        if route.kernel == "cluster":
            return _launch_cluster(cfg, plan, weights, stream_of(weights),
                                   scheds[dev], t0, cond, sel, ring, y_state,
                                   n_valid, mode, prec, int(seed))
        return _launch_fused(cfg, plan, weights, scheds[dev], t0, cond, sel,
                             ring, y_state, n_valid, mode, prec, int(seed))

    def prepare(params, dev) -> None:
        """Build, on the current stream, what a launch on `dev` reads
        besides its arguments (the FIFO layout; the cluster stream of
        prepared weights): see `persistent.make_persistent_generator`."""
        dev = torch.device(dev)
        if dev.type != "cuda":
            return
        if dev not in scheds:
            scheds[dev] = persistent.fifo_schedule(cfg, dev)
        if route.kernel == "cluster" and not isinstance(params, dict):
            stream_of(tuple(params))

    generate.route = route
    generate.prepare = prepare
    return generate
