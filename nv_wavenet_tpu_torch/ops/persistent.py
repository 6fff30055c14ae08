"""The persistent generator: the whole generation of a call in one kernel
launch (`csrc/staged_generate.cu`, one kernel template for K1, K5, K2, K3
and K4 wherever `staged_plan` holds the geometry: K1 and K5, K2 and K3 on
K1's own stream, K4 on a stream in the storage's own bytes; where it raises
K1 card-wide, `csrc/wide_generate.cu`, lockstep and exact where `wide_plan`
holds, else `csrc/generic_generate.cu` for K1/K5, and
`csrc/stream_generate.cu`, the first K4, for K4 and for K2/K3 where
`stream_plan` holds, else the generic kernel), with its plain PyTorch
version.
`generation_route` names the kernel a call runs, before any launch.

The port's counterpart of `nv_wavenet_tpu/ops/persistent.py`
(`make_persistent_generator`): modes "sample" and "argmax" with the
optional last-step activation dump (K1), mode "forced" (K2: teacher forcing,
the per-step distributions p_seq appended to the outputs), mode "prng" (K3:
selectors drawn on the card from Philox, `scan_generate.prng_uniform_sel`),
and `ragged=True`, per-row clocks and lengths in mode "sample" (K5, the
ragged feeds of the serving path).  A CUDA tensor launches the kernel; a CPU
tensor runs the plain loop of `ops/scan_generate.py`.  Nothing falls back
from one to the other.

Precision (`fast_math`, `compute_dtype`; `scan_generate.PRECISIONS`): each
of K1, K2, K3, K5 and K4 has an instance per precision, with its precision's
entry points and launch counts (`PERSISTENT_KERNELS[prec]`, ...).  "fast" and
"bf16" compute with the storage's values rounded to bf16 where they enter
products (`scan_generate.product_view`, made once per params object), and
"bf16" keeps the FIFO ring as bf16 (`init_ring(dtype=...)`).

Weight storage and streaming (K4, the engine's `Impl.MANYBLOCK`):
  * `weight_dtype=torch.bfloat16` stores the nine parameters as bf16; every
    path computes with their fp32 values, `value_view`.  `stream_quant`
    stores dil_w and rs_w as int8 with one fp32 scale per (layer, output
    column) (`quantize_stream_weights`); the value of a weight is the one
    rounded product q * s (`dequantize_stream_params`).
  * `stream_weights=True` launches K4: K1's staged step (`staged_plan`
    with the storage's dtype) on a stream that holds dil_w and rs_w in the
    storage's own bytes (fp32, bf16, or int8 q with its scales applied in
    the kernel, one rounded product q * s a weight) and out_w and end_w as
    the value view holds them.  Every output column still sums k = 0, 1,
    ..., K-1 from 0, so K4 equals K1 fed `value_view` bit for bit.  Where
    that plan cannot hold the geometry, the first K4 runs: dil_w and rs_w
    copied into a ring of shared-memory stages by bulk asynchronous copies
    (1D TMA), each stage a block of `StreamPlan.rows_per_stage` whole rows
    of one matrix, the same sums.
  * `stream_group_size` G and `stream_prefetch` schedule the first K4's
    copies only; on the staged K4 they schedule nothing (its ring always
    runs on across layers and steps) and are checked all the same.  On the
    TPU one copy brings G layers, double buffered, so the copies run one
    group ahead.  A Hopper block may use 227 KB of shared memory, less than
    two fp32 flagship layers (288 KB), so in the first K4 G sets how far
    ahead the copies run: the ring holds G layers of stages (G *
    stages-per-layer + 1 slots), clamped to the shared memory;
    `stream_plan` reports the clamp.  `stream_prefetch=True` lets its
    copies run on past the end of a step, so the next step's first stages
    load under this step's last layers, output stack and sampler;
    otherwise each step starts with an empty ring.  Neither changes a
    value, and no copy is issued for a step past n_valid.

Differences from the TPU kernel, all value-preserving:
  * no chunk padding and no grid: the kernel loops over `n_valid` steps
    itself, so a call may have any length;
  * the FIFO ring is the plain [ring_size, B, R] layout of
    `WaveNetConfig.ring_offsets` (the TPU's lane-packed ring is a 128-lane
    tiling artifact);
  * `rotate_ring_phase` is not ported.  The TPU kernel shares one ring phase
    across the batch, so its ragged calls rotate each row's FIFOs to a
    call-local phase and back around the kernel.  Here each row's absolute
    clock enters the kernel (one CTA per row addresses only its own row),
    so the stored ring keeps the absolute convention, slot
    offs[l] + (t & (d_l - 1)), in every call;
  * `rs_split` and `embed_split` are TPU schedules that give the same
    values; they are not ported.  `prev_prefetch` is K1/K5's: their prev
    warps compute x_{t-d} Wprev ahead of the chain (`staged_plan`);
  * `ring` and `y_state` are updated IN PLACE and returned (torch may do so
    where JAX is functional; it saves an 8.4 MB ring copy per call at the
    flagship geometry).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import scan_generate
from nv_wavenet_tpu_torch.utils import build, tracing

_MODE_IDS = {"sample": 0, "argmax": 1, "forced": 2, "prng": 3}
_DUMP_KEYS = ("xt", "skip", "zs", "za", "p")
_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernels(source: str, symbol: str, argtypes) -> Dict[str, build.CudaKernel]:
    """One entry point per precision, each in its precision's library
    (`build.unit`): `symbol` for "exact", `symbol_fast` and `symbol_bf16`
    for the others."""
    return {p: build.CudaKernel(build.unit(source, p), symbol + (
        "" if p == "exact" else "_" + p), argtypes)
            for p in scan_generate.PRECISIONS}


# K1, K2, K3 and K4 (lockstep, every mode and storage): one CTA per batch
# row, all steps and layers inside one launch, every weight staged into
# shared memory by TMA (`staged_plan`, `staged_stream`)
PERSISTENT_KERNELS = _kernels(
    "staged_generate.cu", "nvw_staged_generate",
    [_P] * 19 + [ctypes.c_longlong, ctypes.c_ulonglong] + [_I] * 10
    + [_P, _P])
# K5: the same step with per-row clocks and lengths (ragged feeds), which
# travel in the launch's parameters from two host arrays
RAGGED_KERNELS = _kernels(
    "staged_generate.cu", "nvw_staged_generate_ragged",
    [_P] * 13 + [_I] * 8 + [_P, _P])
# K1 and K5 where the staged plan cannot hold the geometry (fault F2 of
# ROADMAP.md), K2 and K3 where the first K4's cannot either: every
# product's columns looped over 256 threads, the weights read from L2 (the
# K1 of commit 14b57bc); the lockstep entry takes every mode
GENERIC_KERNELS = _kernels(
    "generic_generate.cu", "nvw_generic_generate",
    [_P] * 20 + [ctypes.c_longlong, ctypes.c_ulonglong] + [_I] * 9 + [_P])
GENERIC_RAGGED_KERNELS = _kernels(
    "generic_generate.cu", "nvw_generic_generate_ragged",
    [_P] * 16 + [_I] * 8 + [_P])
# K1 where the staged plan cannot hold the geometry and `wide_plan` can
# (lockstep, exact, no dump): every CTA of the card a slice of every
# product's columns for all rows, the weights streamed once a step
WIDE_KERNELS = {"exact": build.CudaKernel(
    "wide_generate.cu", "nvw_wide_generate",
    [_P] * 14 + [ctypes.c_longlong] + [_I] * 9 + [_P, _P,
                                                   ctypes.POINTER(_I)])}
# K4, and K2/K3, where the staged plan cannot hold the geometry: dil_w and
# rs_w streamed through a ring of row blocks, every mode
STREAM_KERNELS = _kernels(
    "stream_generate.cu", "nvw_stream_generate",
    [_P] * 22 + [ctypes.c_longlong, ctypes.c_ulonglong] + [_I] * 17 + [_P])
# the stacks' storage dtypes in K4 (csrc/stream_generate.cu kStorage*)
_STORAGE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the shared memory one H100 block may use, and the H100's SMs
SMEM_PER_BLOCK = 232448
SMS = 132
STREAM_MAX_COLUMNS = 1024  # the first K4's output columns a product in one pass: kMaxTasks * kThreads
_STATIC_SMEM = 1024       # the block helpers' static shared memory, rounded up


def stream_group(L: int, group_size: int = 8):
    """(group size, group count) of HBM weight streaming: `group_size`
    layers per group, at most L (the JAX package's `stream_group`)."""
    if group_size < 1:
        raise ValueError(f"stream_group_size must be >= 1, got {group_size}")
    G = min(group_size, L)
    return G, -(-L // G)


def quantize_stream_weights(params: Dict[str, torch.Tensor]):
    """Per-output-column symmetric int8 quantization of the two streamed
    stacks, dil_w [L, 2R, 2R] and rs_w [L, R, R+S]: s = max|w| / 127 over
    the input axis per (layer, output column), 1 where that is 0, and
    q = clip(round_half_even(w / s), -127, 127).  Returns (q_dil int8,
    s_dil [L, 2R], q_rs int8, s_rs [L, R+S]) on the params' device."""
    def q(w):
        w = w.to(torch.float32)
        s = w.abs().amax(dim=1) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        qw = torch.clamp(torch.round(w / s[:, None, :]), -127, 127)
        return qw.to(torch.int8), s

    qd, sd = q(params["dil_w"])
    qr, sr = q(params["rs_w"])
    return qd, sd, qr, sr


def dequantize_stream_params(params: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """params with dil_w and rs_w replaced by their int8 round trip q * s,
    one rounded fp32 product per weight: the values K4 computes with under
    `stream_quant`."""
    qd, sd, qr, sr = quantize_stream_weights(params)
    return {**params,
            "dil_w": qd.to(torch.float32) * sd[:, None, :],
            "rs_w": qr.to(torch.float32) * sr[:, None, :]}


def check_storage(weight_dtype, stream_quant: bool) -> None:
    """Raise ValueError for a storage the port does not have: the JAX
    package's weight dtypes fp32 and bf16, int8 stacks only over fp32."""
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {weight_dtype}")
    if stream_quant and weight_dtype != torch.float32:
        raise ValueError("stream_quant (int8) replaces the stacks' storage "
                         "dtype; combine it with weight_dtype=torch.float32 "
                         "only")


def value_view(params: Dict[str, torch.Tensor],
               weight_dtype=torch.float32,
               stream_quant: bool = False) -> Dict[str, torch.Tensor]:
    """The fp32 values a weight storage computes with: every parameter
    rounded to bf16 under weight_dtype=torch.bfloat16, dil_w and rs_w
    dequantized (q * s) under stream_quant, the params themselves under
    fp32.  Apply it to canonical params once: the int8 round trip is not
    idempotent."""
    check_storage(weight_dtype, stream_quant)
    if weight_dtype == torch.bfloat16:
        return {k: v.to(torch.bfloat16).to(torch.float32)
                for k, v in params.items()}
    if stream_quant:
        return dequantize_stream_params(params)
    return params


class StreamPlan(NamedTuple):
    """The first K4's shared-memory plan (`stream_plan`)."""
    storage: torch.dtype      # the stacks' dtype in device memory
    rows_per_stage: int       # weight rows one stage (one copy) brings
    stage_bytes: int          # one ring slot
    stages: int               # ring slots
    smem_bytes: int           # dynamic shared memory K4 asks for
    group_layers: int         # the lookahead asked for, min(G, L) layers
    lookahead_layers: float   # what the ring holds: (stages - 1) / per layer
    clamped: bool             # the shared memory cut the lookahead
    waves: int                # CTA waves of the batch, one CTA per SM
    general: bool             # the general instance (columns looped, rows padded)
    dil_stride: int           # elements of a stored dil_w row: 2R padded to 16 bytes
    rs_stride: int            # elements of a stored rs_w row: R+S padded to 16 bytes


def stream_storage(weight_dtype=torch.float32, stream_quant: bool = False,
                   prec: str = "exact"):
    """The dtype K4's stacks are stored in on the card: int8 under
    stream_quant, else bf16 under the low precisions (the stacks enter
    products rounded to bf16, so bf16 holds their operands exactly), else
    weight_dtype."""
    if stream_quant:
        return torch.int8
    return torch.bfloat16 if prec != "exact" else weight_dtype


def activation_smem_bytes(cfg: WaveNetConfig, prec: str = "exact",
                          general: bool = False) -> int:
    """The shared memory one step's activations take in a CTA of the
    generic kernel or the first K4, beside its stages ((7R + S + 4A)
    floats, R more under "fast" for the rounded copy of x; the first K4's
    general instance holds max(4R, R+S) floats of products where the others
    hold 4R; the launches in csrc/generic_generate.cu and
    csrc/stream_generate.cu compute the same)."""
    R = cfg.R
    zh = max(4 * R, R + cfg.S) if general else 4 * R
    return (3 * R + zh + cfg.S + 4 * cfg.A
            + (R if prec == "fast" else 0)) * 4


def _padded(n: int, eb: int) -> int:
    """n elements of eb bytes padded to whole 16-byte units."""
    return -(-n * eb // 16) * 16 // eb


def stream_plan(cfg: WaveNetConfig, batch: int, storage=torch.float32,
                stream_group_size: int = 8, prec: str = "exact"
                ) -> StreamPlan:
    """Decide the first K4's stages (csrc/stream_generate.cu, the fallback
    where `staged_plan` cannot hold the geometry) for `batch` rows with the
    stacks stored as `storage` (torch.float32, torch.bfloat16 or
    torch.int8; `stream_storage`) in precision `prec`
    (`scan_generate.PRECISIONS`; "fast" keeps a rounded copy of x beside
    the activations, R more floats).

    A stage is one block of `rows_per_stage` whole rows: for dil_w those
    rows of Wprev and of Wcur, for rs_w those rows of [R, R+S]; a layer
    takes 2 R / rows_per_stage stages.  Every stage costs a barrier and a
    wait (~0.45 us on an H100, PERF.md), so the stage is the largest power
    of two of rows dividing R of which two fit: the whole of Wprev and Wcur
    (64 KB) or of rs_w (80 KB) at the flagship widths in fp32.  The ring has
    G * stages-per-layer + 1 slots (G = stream_group_size, at most L), as
    many as fit beside the step's activations ((7R + S + 4A) floats, as K1)
    and the stages' barriers.  One CTA runs one batch row and, with this
    much shared memory, has its SM alone: a batch of more than 132 rows
    runs in waves.  Raises ValueError for a geometry it cannot run: more
    than 1024 output columns in a product (4R or R+S), rows that are not
    whole 16-byte units (the unit of a bulk copy), or fewer than two stages
    of one row.

    The general instance (`general`) takes what the others cannot: more
    than STREAM_MAX_COLUMNS output columns in a product (4R or R+S; its
    columns loop over the threads, each still summed in k order), or
    stored rows that are not whole 16-byte units (dil_stride and rs_stride
    pad them with zeros that no sum reads; `_stream_stacks`)."""
    if storage not in _STORAGE_IDS:
        raise ValueError(f"K4 stores its stacks as {list(_STORAGE_IDS)}, "
                         f"got {storage}")
    if prec != "exact" and storage == torch.float32:
        raise ValueError(f"K4 in precision {prec!r} takes its stacks as bf16 "
                         f"or int8 (stream_storage)")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    L, R, S = cfg.num_layers, cfg.R, cfg.S
    eb = torch.empty((), dtype=storage).element_size()
    ldd, ldr = _padded(2 * R, eb), _padded(R + S, eb)
    general = (max(4 * R, R + S) > STREAM_MAX_COLUMNS
               or (ldd, ldr) != (2 * R, R + S))
    act = -(-activation_smem_bytes(cfg, prec, general) // 16) * 16
    budget = SMEM_PER_BLOCK - _STATIC_SMEM - act - 8
    rows = R & -R
    while True:
        stage = -(-max(2 * rows * ldd, rows * ldr) * eb // 128) * 128
        fit = budget // (stage + 8)
        if fit >= 2 or rows == 1:
            break
        rows //= 2
    if fit < 2:
        raise ValueError(f"K4 needs two stages of {stage} bytes beside "
                         f"{act} bytes of activations in {SMEM_PER_BLOCK} "
                         f"bytes of shared memory")
    per_layer = 2 * (R // rows)
    G, _ = stream_group(L, stream_group_size)
    stages = min(G * per_layer + 1, fit)
    smem = stages * stage + -(-8 * stages // 16) * 16 + act
    return StreamPlan(storage, rows, stage, stages, smem, G,
                      (stages - 1) / per_layer, stages < G * per_layer + 1,
                      -(-batch // SMS), general, ldd, ldr)


STAGED_MAX_THREADS = 512   # chain + prev + producer (kMaxThreads)
STAGED_MAX_COLUMNS = 4     # columns a thread owns in one product (kMaxNC)
STAGED_SLOT_BYTES = 32768  # a prev ring slot at most, half a chain slot
STAGED_CHAIN_SLOTS = 3     # slots of the chain ring (2 where 3 do not fit)
STAGED_LOOKAHEAD = 4       # layers the prev buffer holds, at most L
# (R, S, A) of the instances compiled for fixed widths, geometry 1, 2, ...
# (csrc/staged_generate.cu `fixed_widths`): the flagship's and config 4's.
# Every other geometry runs the generic instance (geometry 0).
STAGED_FIXED_WIDTHS = ((64, 256, 256), (128, 256, 256))
# the stream's matrices, in a layer's order and then the output stack's:
# (name, K, N) of each as functions of (R, S, A)
STAGED_MATRICES = (("prev", lambda R, S, A: (R, 2 * R)),
                   ("cur", lambda R, S, A: (R, 2 * R)),
                   ("rs", lambda R, S, A: (R, R + S)),
                   ("out", lambda R, S, A: (S, A)),
                   ("end", lambda R, S, A: (A, A)))


class StagedMatrix(NamedTuple):
    """One stack in K1/K5's stream, as k-quads [kq, Np, 4]."""
    name: str
    K: int
    N: int
    Np: int           # columns of the layout: N rounded up to 4
    kq: int           # quad-rows, ceil(K / 4)
    row_bytes: int    # one quad-row
    rows: int         # quad-rows one copy (one ring slot) brings
    chunks: int       # copies of the whole matrix
    offset: int       # bytes from the stream's start (layer 0's, per layer)


class StagedPlan(NamedTuple):
    """K1/K5's and K4's plan (`staged_plan`)."""
    storage: torch.dtype      # Wprev, Wcur, rs_w (K1: fp32 in exact, else bf16)
    chain_threads: int        # the chain's warps, a multiple of 32
    prev_threads: int         # the prev warps'
    threads: int              # chain + prev + one producer warp
    slot_bytes: int           # one slot of either ring
    chain_slots: int
    prev_slots: int
    lookahead: int            # layers of zp and cond the prev buffer holds
    prev_slot_bytes: int      # one slot of the prev ring (slot_bytes: chain)
    matrices: tuple           # StagedMatrix of STAGED_MATRICES
    layer_bytes: int          # one layer's Wprev, Wcur and rs_w
    stream_bytes: int         # the whole stream
    activation_bytes: int     # the floats beside the rings
    smem_bytes: int           # dynamic shared memory of the launch
    waves: int                # CTA waves of the batch, one CTA per SM
    geometry: int             # the instance: 1 + index in STAGED_FIXED_WIDTHS, 0 generic
    out_storage: torch.dtype  # out_w and end_w (`staged_out_storage`)

    def kernel_args(self) -> tuple:
        """The plan array of the entry points (csrc/staged_generate.cu
        `launch`)."""
        eb = self.storage.itemsize
        head = (self.chain_threads, self.prev_threads, self.slot_bytes,
                self.chain_slots, self.prev_slots, self.lookahead,
                self.prev_slot_bytes, eb, self.layer_bytes, self.smem_bytes, self.threads,
                self.stream_bytes)
        return head + tuple(v for m in self.matrices
                            for v in (m.offset, m.row_bytes, m.rows, m.kq)
                            ) + (self.geometry,)


def staged_storage(prec: str = "exact") -> torch.dtype:
    """The dtype K1/K5 stage their stacks in: bf16 under the low precisions
    (their weights are bf16 values, `scan_generate.product_view`), else
    fp32."""
    return torch.float32 if prec == "exact" else torch.bfloat16


def staged_out_storage(storage: torch.dtype, prec: str = "exact"
                       ) -> torch.dtype:
    """The dtype of out_w and end_w in a stream whose layer stacks are
    `storage`: the same, but fp32 (exact) or bf16 beside int8 stacks, since
    int8 quantises dil_w and rs_w only and the output stack keeps the value
    view's values."""
    if storage == torch.int8:
        return staged_storage(prec)
    return storage


def staged_activation_floats(cfg: WaveNetConfig, prec: str,
                             lookahead: int) -> int:
    """The floats beside K1/K5's rings, each array rounded up to a whole
    quad: x (and its rounded copy under "fast"), h, skip, zs, za, the two
    prefix-sum buffers, the prev warps' operand x_{t-d}, and `lookahead`
    layers of zp [2R], cond [2R] and the FIFO slot as stored [R]."""
    c4 = lambda n: -(-n // 4) * 4  # noqa: E731
    R, S, A = cfg.R, cfg.S, cfg.A
    return (c4(R) * (2 if prec == "fast" else 1) + c4(R) + c4(S) + 4 * c4(A)
            + c4(R) + lookahead * (2 * c4(2 * R) + c4(R)))


def staged_threads(cfg: WaveNetConfig) -> tuple:
    """(chain threads, prev threads) of K1/K5.  The prev warps own the 2R
    columns of x_{t-d} Wprev, at most four a thread; the chain's own R + S
    res/skip columns and A output columns, the fewest a thread (one at the
    flagship widths) that fits with them and the producer warp in
    STAGED_MAX_THREADS, and the R column pairs (i, R + i) of x_t Wcur, at
    most two a thread."""
    R, S, A = cfg.R, cfg.S, cfg.A
    prev = min(128, -(-2 * R // 32) * 32)
    if 2 * R > STAGED_MAX_COLUMNS * prev:
        raise ValueError(f"K1/K5 compute x_(t-d) Wprev on {prev} threads, at "
                         f"most {STAGED_MAX_COLUMNS} of its 2R = {2 * R} "
                         f"columns each")
    cols = max(R + S, A)
    for nc in range(1, STAGED_MAX_COLUMNS + 1):
        chain = max(-(-cols // (32 * nc)) * 32, -(-R // 64) * 32)
        if chain + prev + 32 <= STAGED_MAX_THREADS:
            return chain, prev
    raise ValueError(f"K1/K5 cannot spread R + S = {R + S} and A = {A} "
                     f"output columns over {STAGED_MAX_THREADS} threads, "
                     f"{STAGED_MAX_COLUMNS} a thread")


def staged_plan(cfg: WaveNetConfig, batch: int, prec: str = "exact",
                storage: torch.dtype | None = None) -> StagedPlan:
    """Decide K1/K5's threads, rings and stream layout for `batch` rows in
    precision `prec` (`scan_generate.PRECISIONS`), or K4's with its layer
    stacks stored as `storage` (torch.float32, torch.bfloat16 or
    torch.int8; `stream_storage`).

    The stream holds each stack as k-quads [ceil(K/4), Np, 4] (Np: its
    columns rounded up to 4, zero-padded; `staged_stream`): per layer
    Wprev, Wcur, rs_w in `storage` (K1/K5: fp32 under "exact" and bf16
    otherwise, `staged_storage`), then out_w and end_w in
    `staged_out_storage`.  A quad-row's bytes follow its dtype, so an int8
    stream brings a quarter of the fp32 stream's layer bytes in as many
    quad-rows, and a slot holds four times the int8 quad-rows.  A copy
    brings whole quad-rows into one slot of a ring:
    Wprev into the prev ring (two slots, Wprev whole up to
    STAGED_SLOT_BYTES), the rest into the chain ring (STAGED_CHAIN_SLOTS
    slots of what the shared memory leaves, at most 2 STAGED_SLOT_BYTES;
    two where three do not fit), one producer lane a slot.  On an H100 a
    step's time grows with its count of copies (PERF.md), so the slots are
    few and large.  The prev buffer holds min(L, 4) layers.  Widths in
    STAGED_FIXED_WIDTHS with a full prev buffer run the instance compiled
    for them (`geometry`), every other geometry the generic one.  Raises
    ValueError before any launch for a geometry K1/K5 cannot hold: too many
    columns for the threads (`staged_threads`), an odd R under "bf16" (the
    bf16 FIFO slot is copied 4 bytes at a time), or rings of two slots
    that do not fit beside the activations in SMEM_PER_BLOCK."""
    scan_generate._check_precision(prec)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if storage is None:
        storage = staged_storage(prec)
    elif storage not in _STORAGE_IDS or (prec != "exact"
                                         and storage == torch.float32):
        raise ValueError(f"the staged K4 stores its stacks as fp32 (exact "
                         f"only), bf16 or int8, got {storage} in {prec!r}")
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    if prec == "bf16" and R % 2:
        raise ValueError(f"K1/K5 in bf16 copy the FIFO slot 4 bytes at a "
                         f"time: R = {R} must be even")
    chain, prev = staged_threads(cfg)
    out_storage = staged_out_storage(storage, prec)
    lookahead = min(L, STAGED_LOOKAHEAD)
    act = 4 * staged_activation_floats(cfg, prec, lookahead)
    shapes = [(name, *f(R, S, A)) for name, f in STAGED_MATRICES]
    row_bytes = [-(-N // 4) * 4 * 4
                 * (out_storage if name in ("out", "end") else storage).itemsize
                 for name, _, N in shapes]
    budget = SMEM_PER_BLOCK - _STATIC_SMEM - act

    def bar_bytes(slots):
        return -(-8 * 2 * (slots + lookahead) // 16) * 16

    r128 = lambda n: -(-n // 128) * 128  # noqa: E731
    # a prev slot holds Wprev whole up to STAGED_SLOT_BYTES (one copy a
    # layer); the chain ring takes the rest in CHAIN_SLOTS slots of at most
    # twice that, fewer and larger as the shared memory allows
    kq_r = -(-R // 4)
    prev_slot = r128(max(row_bytes[0], min(kq_r * row_bytes[0],
                                           STAGED_SLOT_BYTES)))
    for chain_slots in (STAGED_CHAIN_SLOTS, 2):
        room = budget - 2 * prev_slot - bar_bytes(chain_slots + 2)
        slot = min(room // chain_slots // 128 * 128, 2 * STAGED_SLOT_BYTES)
        if slot >= max(row_bytes[1:]):
            break
    else:
        raise ValueError(f"K1/K5 need two ring slots of {prev_slot} bytes and "
                         f"two of {r128(max(row_bytes[1:]))} beside {act} "
                         f"bytes of activations in {SMEM_PER_BLOCK} bytes of "
                         f"shared memory")
    matrices, offset = [], 0
    for (name, K, N), rb in zip(shapes, row_bytes):
        kq = -(-K // 4)
        rows = min(kq, (prev_slot if name == "prev" else slot) // rb)
        matrices.append(StagedMatrix(name, K, N, -(-N // 4) * 4, kq, rb, rows,
                                     -(-kq // rows), offset))
        offset += kq * rb
        if name == "rs":
            layer_bytes = offset
            offset = L * layer_bytes
    prev_slots = 2
    smem = (chain_slots * slot + prev_slots * prev_slot
            + bar_bytes(chain_slots + prev_slots) + act)
    fixed = (R, S, A) in STAGED_FIXED_WIDTHS and lookahead == STAGED_LOOKAHEAD
    return StagedPlan(storage, chain, prev, chain + prev + 32, slot,
                      chain_slots, prev_slots, lookahead, prev_slot,
                      tuple(matrices),
                      layer_bytes, offset, act, smem, -(-batch // SMS),
                      STAGED_FIXED_WIDTHS.index((R, S, A)) + 1 if fixed else 0,
                      out_storage)


def staged_quads(w: torch.Tensor, dtype) -> torch.Tensor:
    """A stack w [K, N] (row k feeds every column) as k-quads [ceil(K/4),
    Np, 4] in `dtype`, zero-padded: element [q, n, u] is w[4q + u, n]."""
    K, N = w.shape
    kq, Np = -(-K // 4), -(-N // 4) * 4
    q = torch.zeros((kq * 4, Np), dtype=torch.float32, device=w.device)
    q[:K, :N] = w
    return q.view(kq, 4, Np).permute(0, 2, 1).contiguous().to(dtype)


def staged_stacks(params: Dict[str, torch.Tensor], cfg: WaveNetConfig):
    """The stacks of STAGED_MATRICES as [K, N] tensors: per layer (Wprev,
    Wcur, rs_w) from dil_w's rows [0, R) and [R, 2R) and rs_w, then
    (out_w, end_w)."""
    R = cfg.R
    layers = [(params["dil_w"][l, :R], params["dil_w"][l, R:],
               params["rs_w"][l]) for l in range(cfg.num_layers)]
    return layers, (params["out_w"], params["end_w"])


def staged_stream(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                  plan: StagedPlan) -> torch.Tensor:
    """The weight stream of K1/K5 or K4, one flat tensor laid out as
    `staged_plan` says: the layer stacks in `plan.storage`, out_w and end_w
    in `plan.out_storage`; in that dtype where the two agree, else as bytes
    (uint8).  Built once per upload from the values the products take
    (`scan_generate.product_view`: bf16 values under the low precisions, so
    storing them as bf16 is exact), or for int8 stacks from params whose
    dil_w and rs_w are the integers q (`quantize_stream_weights`)."""
    layers, tail = staged_stacks(params, cfg)
    parts = [staged_quads(w, plan.storage).reshape(-1)
             for stacks in layers for w in stacks]
    parts += [staged_quads(w, plan.out_storage).reshape(-1) for w in tail]
    if plan.storage != plan.out_storage:
        parts = [p.view(torch.uint8) for p in parts]
    out = torch.cat(parts)
    if out.numel() * out.element_size() != plan.stream_bytes:
        raise ValueError(f"the stream holds {out.numel() * out.element_size()}"
                         f" bytes, the plan {plan.stream_bytes}")
    return out


def staged_columns(cfg: WaveNetConfig, plan: StagedPlan) -> Dict[str, list]:
    """The columns each thread of K1/K5 owns, by product: {"cur": [(thread,
    column)], "prev", "rs", "out"}; the kernel computes the same.  Chain
    thread t owns the column pairs (i, R + i) of x_t Wcur for i = t + k Tc
    (k < 2) and the columns t + k Tc of res/skip and of both output
    products (k < 4); prev thread p the columns p + k Tp of x_{t-d} Wprev."""
    R, S, A = cfg.R, cfg.S, cfg.A
    Tc, Tp = plan.chain_threads, plan.prev_threads
    out = {"cur": [], "prev": [], "rs": [], "out": []}
    for t in range(Tc):
        for k in range(STAGED_MAX_COLUMNS // 2):
            if t + k * Tc < R:
                out["cur"] += [(t, t + k * Tc), (t, R + t + k * Tc)]
        for k in range(STAGED_MAX_COLUMNS):
            if t + k * Tc < R + S:
                out["rs"].append((t, t + k * Tc))
            if t + k * Tc < A:
                out["out"].append((t, t + k * Tc))
    for p in range(Tp):
        for k in range(STAGED_MAX_COLUMNS):
            if p + k * Tp < 2 * R:
                out["prev"].append((p, p + k * Tp))
    return out


WIDE_MAX_THREADS = 512    # chain + prev + producer (csrc/wide_generate.cu kWideThreads)
WIDE_MAX_SLOT_BYTES = 65536   # one slice of a product, one ring slot at most
WIDE_CHAIN_SLOTS = 4      # slots of the chain ring, at most (2 at least)
WIDE_PREV_SLOTS = 2
WIDE_LOOKAHEAD = 2        # layer-steps of zp the prev warps run ahead (kLookahead)


def wide_bounds(n: int, ctas: int) -> tuple:
    """The first column of each CTA's slice of n columns, then n: CTA c owns
    [c n / G, (c + 1) n / G), rounded down (csrc/wide_generate.cu `bound`)."""
    return tuple(c * n // ctas for c in range(ctas + 1))


def _wide_stride(n: int) -> int:
    """A row stride of n floats in K1 card-wide's shared memory: n padded to
    a multiple of 32 and 4 more, so that the rows of a warp's float4 loads
    fall in different banks."""
    return -(-n // 32) * 32 + 4


class WidePlan(NamedTuple):
    """K1 card-wide's plan (`wide_plan`)."""
    ctas: int             # G: co-resident CTAs, one an SM, a cooperative launch
    chain_threads: int    # the chain's warps: the products, the gate, the sampler
    prev_threads: int     # the prev warps': x_{t-d} Wprev, ahead
    threads: int          # chain + prev + one producer warp
    pairs: tuple          # wide_bounds(R, G): each CTA's column pairs (i, R + i)
    rs: tuple             # wide_bounds(R + S, G): its res/skip columns
    out: tuple            # wide_bounds(A, G): its columns of out_w and of end_w
    chain_slots: int
    prev_slots: int
    slot_bytes: int       # a chain slot: the largest Wcur, rs_w, out_w or end_w slice
    prev_slot_bytes: int  # a prev slot: the largest Wprev slice
    xs: int               # row stride of x, h and x_{t-d} (floats)
    ss: int               # of relu(skip)
    as_: int              # of zs, za and the sampler's sums
    arena_floats: int     # x | h, or the output stack's vectors
    smem_bytes: int       # dynamic shared memory of the launch
    cta_bytes: tuple      # each CTA's bytes of the stream
    stream_bytes: int     # the whole stream
    scratch_floats: int   # the activations between CTAs: x, h, skip, zs, za

    def kernel_args(self) -> tuple:
        """The plan array of the entry point (csrc/wide_generate.cu
        `launch`)."""
        return (self.ctas, self.chain_threads, self.prev_threads,
                self.chain_slots, self.prev_slots, self.slot_bytes,
                self.prev_slot_bytes, self.xs, self.ss, self.as_,
                self.smem_bytes)


def wide_plan(cfg: WaveNetConfig, batch: int, prec: str = "exact",
              mode: str = "sample", sms: int = SMS) -> WidePlan:
    """Decide K1 card-wide's grid, threads, rings and stream layout for
    `batch` rows (csrc/wide_generate.cu).

    The grid is the fewest CTAs, at most one an SM (`sms`), that give no CTA
    more column pairs than one an SM would: G = ceil(R / ceil(R / sms)).
    CTA c owns the pairs, res/skip columns and output columns of
    `wide_bounds` (uneven where G does not divide a width).  Its stream
    holds, per layer, its Wprev, Wcur and rs_w columns, then its out_w and
    end_w columns, each as k-quads [K/4][columns][4] (`wide_stream`), one
    slice a ring slot: Wprev through the prev ring, the rest through the
    chain ring (up to WIDE_CHAIN_SLOTS slots, as the shared memory allows).
    The launch groups the grid into clusters of up to 8 CTAs (the most that
    divide it and that the card holds at once), whose CTAs share the reads
    of each vector passed between CTAs by multicast copies.
    A chain thread has one (column, row) task of each product at most (two
    columns, the pair's halves, in the dilated one), a prev thread a (pair,
    row) or more.

    Raises ValueError for what it does not run: another precision than
    "exact", a mode other than "sample" or "argmax", R, S or A not a
    multiple of 4 (whole k-quads), a slice past WIDE_MAX_SLOT_BYTES, more
    tasks than chain threads, or two chain slots and the activations past
    SMEM_PER_BLOCK."""
    scan_generate._check_precision(prec)
    if prec != "exact":
        raise ValueError(f"K1 card-wide runs the exact precision only, not "
                         f"{prec!r}")
    if mode not in ("sample", "argmax"):
        raise ValueError(f"K1 card-wide runs modes 'sample' and 'argmax', "
                         f"not {mode!r}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    if R % 4 or S % 4 or A % 4:
        raise ValueError(f"K1 card-wide sums whole k-quads: R = {R}, S = {S} "
                         f"and A = {A} must be multiples of 4")
    G = -(-R // -(-R // sms))
    pairs, rs, out = (wide_bounds(R, G), wide_bounds(R + S, G),
                      wide_bounds(A, G))
    width = lambda bd: max(b - a for a, b in zip(bd, bd[1:]))  # noqa: E731
    pmax, qmax, amax = width(pairs), width(rs), width(out)
    prev_slot = 4 * R * 2 * pmax
    slot = 4 * max(R * 2 * pmax, R * qmax, S * amax, A * amax)
    if max(slot, prev_slot) > WIDE_MAX_SLOT_BYTES:
        raise ValueError(f"K1 card-wide streams a slice of "
                         f"{max(slot, prev_slot)} bytes, past "
                         f"{WIDE_MAX_SLOT_BYTES} bytes a slot")
    r128 = lambda n: -(-n // 128) * 128  # noqa: E731
    slot, prev_slot = r128(slot), r128(prev_slot)
    xs, ss, as_ = _wide_stride(R), _wide_stride(S), _wide_stride(A)
    arena = max(2 * batch * xs, batch * ss, 3 * batch * as_)
    act = 4 * (arena + batch * xs + WIDE_LOOKAHEAD * 2 * pmax * batch
               + qmax * batch + batch + 3 * batch)
    bars = -(-8 * (2 * (WIDE_CHAIN_SLOTS + WIDE_PREV_SLOTS + WIDE_LOOKAHEAD)
                   + 1) // 16) * 16
    room = SMEM_PER_BLOCK - _STATIC_SMEM - act - WIDE_PREV_SLOTS * prev_slot
    chain_slots = min(WIDE_CHAIN_SLOTS, (room - bars) // slot)
    if chain_slots < 2:
        raise ValueError(f"K1 card-wide needs two chain slots of {slot} bytes "
                         f"and two prev slots of {prev_slot} beside {act} "
                         f"bytes of activations in {SMEM_PER_BLOCK} bytes of "
                         f"shared memory")
    bars = -(-8 * (2 * (chain_slots + WIDE_PREV_SLOTS + WIDE_LOOKAHEAD) + 1)
             // 16) * 16
    smem = (chain_slots * slot + WIDE_PREV_SLOTS * prev_slot + bars + act)
    rup = lambda n: -(-n // 32) * 32  # noqa: E731
    chain = max(128, rup(batch * max(pmax, qmax, amax)))
    if chain > WIDE_MAX_THREADS - 32 - 128:
        raise ValueError(f"K1 card-wide gives a chain thread one (column, "
                         f"row) task of each product: {batch} rows of "
                         f"{max(pmax, qmax, amax)} columns a CTA need more "
                         f"than {WIDE_MAX_THREADS - 32 - 128} threads")
    prev = min(max(128, rup(batch * pmax)), WIDE_MAX_THREADS - 32 - chain)
    cta = tuple(4 * (L * (2 * R * 2 * (pairs[c + 1] - pairs[c])
                          + R * (rs[c + 1] - rs[c]))
                     + (S + A) * (out[c + 1] - out[c])) for c in range(G))
    return WidePlan(G, chain, prev, chain + prev + 32, pairs, rs, out,
                    chain_slots, WIDE_PREV_SLOTS, slot, prev_slot, xs, ss,
                    as_, arena, smem, cta, sum(cta),
                    batch * (2 * R + S + 2 * A))


def _wide_quads(w: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """Columns [c0, c1) of w [..., K, N] as k-quads [..., K/4, c1 - c0, 4]:
    element [q, n, u] is w[4q + u, c0 + n]."""
    s = w[..., c0:c1]
    K = s.shape[-2]
    return s.reshape(*s.shape[:-2], K // 4, 4, c1 - c0).transpose(-1, -2)


def wide_stream(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                plan: WidePlan) -> torch.Tensor:
    """K1 card-wide's weight stream, one flat float32 tensor: for each CTA
    in turn, per layer its Wprev and Wcur columns (the pairs (i, R + i) of
    its slice, interleaved i, R + i, i + 1, ...) and its rs_w columns, then
    its out_w and end_w columns, each as k-quads [K/4][columns][4]
    (`wide_plan`).  Built once per upload."""
    L, R = cfg.num_layers, cfg.R
    dev = params["dil_w"].device
    i = torch.arange(R, device=dev)
    pairs = torch.stack([i, R + i], 1).reshape(-1)
    prev = params["dil_w"][:, :R][:, :, pairs]
    cur = params["dil_w"][:, R:][:, :, pairs]
    parts = []
    for c in range(plan.ctas):
        p0, p1 = plan.pairs[c], plan.pairs[c + 1]
        q0, q1 = plan.rs[c], plan.rs[c + 1]
        a0, a1 = plan.out[c], plan.out[c + 1]
        layers = torch.cat([
            _wide_quads(prev, 2 * p0, 2 * p1).reshape(L, -1),
            _wide_quads(cur, 2 * p0, 2 * p1).reshape(L, -1),
            _wide_quads(params["rs_w"], q0, q1).reshape(L, -1)], 1)
        parts += [layers.reshape(-1),
                  _wide_quads(params["out_w"], a0, a1).reshape(-1),
                  _wide_quads(params["end_w"], a0, a1).reshape(-1)]
    out = torch.cat(parts).contiguous()
    if 4 * out.numel() != plan.stream_bytes:
        raise ValueError(f"the stream holds {4 * out.numel()} bytes, the "
                         f"plan {plan.stream_bytes}")
    return out


def wide_model(cfg: WaveNetConfig, plan: WidePlan, stream: torch.Tensor,
               params: Dict[str, torch.Tensor], t0: int,
               cond_pre: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
               y_state: torch.Tensor, n_valid: int, mode: str = "sample"):
    """A plain model of K1 card-wide on the CPU: each CTA's slices read from
    `stream` at the kernel's offsets, every column summed in k order
    (`ordered_matmul_plain`), the ring written by each CTA's pair slice
    after every CTA has read the layer's slot, the sampler on the whole za.
    Returns (y [T, B], ring, y_state), updated in place as the kernel's."""
    from nv_wavenet_tpu_torch.ops import exact_math as em
    from nv_wavenet_tpu_torch.ops.ordered_matmul import ordered_matmul_plain
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    T, _, B, _ = cond_pre.shape
    offs, dils = cfg.ring_offsets, cfg.dilations
    ctas, pos = [], 0
    for c in range(plan.ctas):
        np_ = plan.pairs[c + 1] - plan.pairs[c]
        nq = plan.rs[c + 1] - plan.rs[c]
        na = plan.out[c + 1] - plan.out[c]

        def take(K, n):
            nonlocal pos
            q = stream[pos:pos + K * n].view(K // 4, n, 4)
            pos += K * n
            return q.permute(0, 2, 1).reshape(K, n)
        layers = [(take(R, 2 * np_), take(R, 2 * np_), take(R, nq))
                  for _ in range(L)]
        ctas.append((layers, take(S, na), take(A, na)))
    y = torch.zeros((T, B), dtype=torch.int32)
    y_prev, y_cur = y_state[0].clone().long(), y_state[1].clone().long()
    for j in range(n_valid):
        t = t0 + j
        x = params["embed"][y_prev] + params["embed"][A + y_cur]
        if cfg.tanh_embed:
            x = em.tanh(x)
        skip = torch.zeros((B, S))
        for l in range(L):
            slot = offs[l] + (t & (dils[l] - 1))
            x_prev = ring[slot].clone()
            h = torch.empty((B, R))
            for c, (layers, _, _) in enumerate(ctas):
                p0, p1 = plan.pairs[c], plan.pairs[c + 1]
                wp, wc, _ = layers[l]
                zp = ordered_matmul_plain(x_prev, wp)
                zc = ordered_matmul_plain(x, wc)
                zt = (zp[:, 0::2] + zc[:, 0::2]) + cond_pre[j, l, :, p0:p1]
                zg = (zp[:, 1::2] + zc[:, 1::2]) + cond_pre[j, l, :,
                                                           R + p0:R + p1]
                h[:, p0:p1] = em.tanh(zt) * em.sigmoid(zg)
            for c in range(plan.ctas):   # after the gate barrier
                p0, p1 = plan.pairs[c], plan.pairs[c + 1]
                ring[slot, :, p0:p1] = x[:, p0:p1]
            x_next = torch.empty((B, R))
            for c, (layers, _, _) in enumerate(ctas):
                q0, q1 = plan.rs[c], plan.rs[c + 1]
                acc = ordered_matmul_plain(h, layers[l][2])
                for v, o in enumerate(range(q0, q1)):
                    bo = params["rs_b"][l, o]
                    if o < R:
                        x_next[:, o] = (acc[:, v] + bo) + x[:, o]
                    else:
                        skip[:, o - R] = (skip[:, o - R] + acc[:, v]) + bo
            x = x_next
        skip = torch.clamp_min(skip, 0.0)
        zs, za = torch.empty((B, A)), torch.empty((B, A))
        for c, (_, wo, _) in enumerate(ctas):
            a0, a1 = plan.out[c], plan.out[c + 1]
            zs[:, a0:a1] = torch.clamp_min(ordered_matmul_plain(skip, wo)
                                           + params["out_b"][a0:a1], 0.0)
        for c, (_, _, we) in enumerate(ctas):
            a0, a1 = plan.out[c], plan.out[c + 1]
            za[:, a0:a1] = ordered_matmul_plain(zs, we) + params["end_b"][a0:a1]
        if mode == "argmax":
            y_t = torch.argmax(za, dim=-1).to(torch.int32)
        else:
            _, cum = em.softmax_cumsum(za)
            y_t = em.select_from_cumsum(cum, sel[j][:, None], A,
                                        cfg.silence_bin)
        y[j] = y_t
        y_prev, y_cur = y_cur, y_t.long()
    y_state[0] = y_prev.to(torch.int32)
    y_state[1] = y_cur.to(torch.int32)
    return y, ring, y_state


class Route(NamedTuple):
    """The kernel one call of a generator runs (`generation_route`)."""
    kernel: str       # "staged", "wide", "generic", "staged_stream" or "stream"
    ragged: bool
    plan: object      # StagedPlan ("staged", "staged_stream"), WidePlan ("wide"), StreamPlan ("stream") or None
    note: str | None  # why the staged plan was not taken, for a fallback

    def cuda_kernel(self, prec: str = "exact") -> build.CudaKernel:
        """The entry point (and launch count) this route launches in
        precision `prec`."""
        table = {"staged": RAGGED_KERNELS if self.ragged
                 else PERSISTENT_KERNELS,
                 "generic": GENERIC_RAGGED_KERNELS if self.ragged
                 else GENERIC_KERNELS,
                 "wide": WIDE_KERNELS,
                 "staged_stream": PERSISTENT_KERNELS,
                 "stream": STREAM_KERNELS}[self.kernel]
        return table[prec]


def generation_route(cfg: WaveNetConfig, batch: int, prec: str = "exact",
                     mode: str = "sample", ragged: bool = False,
                     stream_weights: bool = False,
                     storage: torch.dtype = torch.float32,
                     stream_group_size: int = 8, dump: bool = False) -> Route:
    """Name the kernel a generator's call runs on the card, before any
    launch and without a card:

      * stream_weights (K4, every mode): the staged K4 where `staged_plan`
        holds the geometry with the stacks stored as `storage`
        (`stream_storage`), else the first K4 (`stream_plan`, which raises
        for a geometry it cannot hold either: the call raises as before);
      * mode "forced" (K2) or "prng" (K3), in the precision's storage
        (`staged_storage`): the staged step on K1's own stream (route
        "staged_stream": its plan is K1's) where `staged_plan` holds the
        geometry, else the first K4 (`stream_plan`) where it holds it, else
        the generic kernel (`csrc/generic_generate.cu`, no width limit);
      * modes "sample" and "argmax", lockstep (K1) or ragged (K5): the
        staged kernel where `staged_plan` holds the geometry; else, lockstep
        without `dump`, K1 card-wide (`csrc/wide_generate.cu`) where
        `wide_plan` holds it (the exact precision); else the generic one
        (`csrc/generic_generate.cu`, no width limit).

    The routes "staged" and "staged_stream" launch the one staged entry
    point (`PERSISTENT_KERNELS`, K5's `RAGGED_KERNELS`).  A fallback carries
    the staged plan's error as its `note`."""
    if stream_weights:
        stream_group(cfg.num_layers, stream_group_size)   # checked always
        try:
            return Route("staged_stream", False,
                         staged_plan(cfg, batch, prec, storage), None)
        except ValueError as err:
            return Route("stream", False, stream_plan(
                cfg, batch, storage, stream_group_size, prec), str(err))
    if mode in ("forced", "prng"):
        storage = staged_storage(prec)
        try:
            return Route("staged_stream", False,
                         staged_plan(cfg, batch, prec, storage), None)
        except ValueError as err:
            try:
                return Route("stream", False, stream_plan(
                    cfg, batch, storage, stream_group_size, prec), str(err))
            except ValueError:
                return Route("generic", False, None, str(err))
    try:
        return Route("staged", ragged, staged_plan(cfg, batch, prec), None)
    except ValueError as err:
        if not (ragged or dump):
            try:
                return Route("wide", False, wide_plan(cfg, batch, prec, mode),
                             str(err))
            except ValueError:
                pass
        return Route("generic", ragged, None, str(err))


def init_ring(cfg: WaveNetConfig, batch: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Zero FIFO state [ring_size, batch, R]: 'no past activations', as the
    golden model treats t < d_l.  dtype: torch.bfloat16 under the "bf16"
    precision (`scan_generate.ring_dtype`), else fp32."""
    return torch.zeros((cfg.ring_size, batch, cfg.R), dtype=dtype,
                       device=device)


def generate_plain(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   t0, cond_pre: torch.Tensor, sel: torch.Tensor,
                   ring: torch.Tensor, y_state: torch.Tensor, n_valid,
                   mode: str = "sample", dump: bool = False, seed: int = 0,
                   prec: str = "exact"):
    """The plain version of K1, K2, K3 and K5 in precision `prec`, on any
    device: the loop of `scan_generate.run_steps`, with the kernel's outputs
    (see `make_persistent_generator`).  t0 and n_valid are ints (K1, K2, K3)
    or the per-row host tensors t0_row and n_valid_row (K5)."""
    if isinstance(n_valid, torch.Tensor):
        t0, n_valid = t0.to(cond_pre.device), n_valid.to(cond_pre.device)
    y, aux, p_seq = scan_generate.run_steps(
        params, cfg, t0, cond_pre, sel, ring, y_state, n_valid, mode, dump,
        seed, "p" if mode == "forced" else None, prec)
    out = (y, ring, y_state)
    if dump:
        if aux is None:
            aux = _empty_dumps(cfg, cond_pre.shape[2], cond_pre.device)
        out += tuple(aux[k] for k in _DUMP_KEYS)
    if mode == "forced":
        out += (p_seq,)
    return out


def _empty_dumps(cfg: WaveNetConfig, B: int, device) -> Dict[str, torch.Tensor]:
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {"xt": z(L, B, R), "skip": z(L, B, S), "zs": z(B, A),
            "za": z(B, A), "p": z(B, A)}


def fifo_schedule(cfg: WaveNetConfig, device) -> torch.Tensor:
    """K1's FIFO layout, [2, L] int32: each layer's first ring slot
    (`cfg.ring_offsets`) and its dilation (`cfg.dilations`), so the layout
    has one owner, `config.py`."""
    return torch.tensor([cfg.ring_offsets, cfg.dilations], dtype=torch.int32,
                        device=device)


_WEIGHTS = ("embed", "dil_w", "rs_w", "rs_b", "out_w", "out_b", "end_w",
            "end_b")
_CPU = torch.device("cpu")


def _plan_array(plan: StagedPlan):
    """The plan as the host array the staged entry points read."""
    args = plan.kernel_args()
    return (ctypes.c_longlong * len(args))(*args)


def _launch_kernel(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   sched: torch.Tensor, t0: int, cond_pre: torch.Tensor,
                   sel: torch.Tensor, ring: torch.Tensor,
                   y_state: torch.Tensor, n_valid: int, mode: str, dump: bool,
                   seed: int, prec: str, stream: int):
    """The generic kernel (K1, K2, K3 where no other plan holds the
    geometry) on the raw CUDA stream `stream`."""
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    dumps = _empty_dumps(cfg, B, dev) if dump else None
    d_ptrs = ([dumps[k].data_ptr() for k in _DUMP_KEYS] if dump
              else [None] * len(_DUMP_KEYS))
    # zeros: K2 writes no step past n_valid
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    if n_valid:
        GENERIC_KERNELS[prec](
            *(params[k].data_ptr() for k in _WEIGHTS), cond_pre.data_ptr(),
            sel.data_ptr(), sched.data_ptr(), ring.data_ptr(),
            y_state.data_ptr(), y.data_ptr(), *d_ptrs,
            None if p_seq is None else p_seq.data_ptr(), t0,
            seed & 0xFFFFFFFFFFFFFFFF, n_valid, B, cfg.num_layers, cfg.R,
            cfg.S, cfg.A, int(cfg.tanh_embed), cfg.silence_bin,
            _MODE_IDS[mode], stream)
    out = (y, ring, y_state)
    if dump:
        out += tuple(dumps[k] for k in _DUMP_KEYS)
    if mode == "forced":
        out += (p_seq,)
    return out


def _launch_stream(cfg: WaveNetConfig, plan: StreamPlan, prefetch: bool,
                   params: Dict[str, torch.Tensor], stacks: tuple,
                   sched: torch.Tensor, t0: int, cond_pre: torch.Tensor,
                   sel: torch.Tensor, ring: torch.Tensor,
                   y_state: torch.Tensor, n_valid: int, mode: str, dump: bool,
                   seed: int, prec: str, stream: int):
    """The first K4: `params` gives the fp32 values of the small tensors,
    `stacks` the stored (dil_w, rs_w, dil_s, rs_s); outputs as
    `_launch_kernel`."""
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    dumps = _empty_dumps(cfg, B, dev) if dump else None
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    outs = ([dumps[k] for k in _DUMP_KEYS] if dump else []) + (
        [p_seq] if mode == "forced" else [])
    dil, rs, dil_s, rs_s = stacks
    if dil.data_ptr() % 16 or rs.data_ptr() % 16:
        raise ValueError("K4 copies dil_w and rs_w in 16-byte units: both "
                         "must start on a 16-byte boundary")
    if n_valid:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        STREAM_KERNELS[prec](
            params["embed"].data_ptr(), dil.data_ptr(), rs.data_ptr(),
            ptr(dil_s), ptr(rs_s),
            *(params[k].data_ptr() for k in _WEIGHTS[3:]),
            cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
            *(ptr(dumps[k]) if dump else None for k in _DUMP_KEYS),
            ptr(p_seq), t0, seed & 0xFFFFFFFFFFFFFFFF, n_valid, B,
            cfg.num_layers, cfg.R, cfg.S, cfg.A, int(cfg.tanh_embed),
            cfg.silence_bin, _MODE_IDS[mode],
            _STORAGE_IDS[plan.storage], plan.rows_per_stage, plan.stages,
            plan.stage_bytes, int(prefetch), plan.smem_bytes,
            plan.dil_stride if plan.general else 0,
            plan.rs_stride if plan.general else 0, stream)
    return (y, ring, y_state, *outs)


def _launch_staged(cfg: WaveNetConfig, plan: StagedPlan, plan_arr,
                   params: Dict[str, torch.Tensor], stored: tuple,
                   sched: torch.Tensor, t0: int, cond_pre: torch.Tensor,
                   sel: torch.Tensor, ring: torch.Tensor,
                   y_state: torch.Tensor, n_valid: int, mode: str,
                   dump: bool, seed: int, prec: str, stream: int):
    """Every lockstep call of the staged step (K1, K2, K3, K4: routes
    "staged" and "staged_stream"): `params` gives the fp32 values of the
    small tensors, `stored` the stream and the int8 scales (dil_s, rs_s;
    None otherwise), `plan_arr` the plan's array (`_plan_array`); outputs
    as `_launch_kernel`."""
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    dumps = _empty_dumps(cfg, B, dev) if dump else None
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    outs = ([dumps[k] for k in _DUMP_KEYS] if dump else []) + (
        [p_seq] if mode == "forced" else [])
    weights, dil_s, rs_s = stored
    if n_valid:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        PERSISTENT_KERNELS[prec](
            params["embed"].data_ptr(), weights.data_ptr(), ptr(dil_s),
            ptr(rs_s), *(params[k].data_ptr() for k in ("rs_b", "out_b",
                                                          "end_b")),
            cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
            *(ptr(dumps[k]) if dump else None for k in _DUMP_KEYS),
            ptr(p_seq), t0, seed & 0xFFFFFFFFFFFFFFFF, n_valid, B,
            cfg.num_layers, cfg.R, cfg.S, cfg.A, int(cfg.tanh_embed),
            cfg.silence_bin, _MODE_IDS[mode],
            _STORAGE_IDS[plan.storage], ctypes.addressof(plan_arr), stream)
    return (y, ring, y_state, *outs)


def _launch_ragged(kernel: build.CudaKernel, bound: dict,
                   t0_row: torch.Tensor, cond_pre: torch.Tensor,
                   sel: torch.Tensor, n_valid_row: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """K5 (`kernel`: the staged or the generic instance) with the arguments
    a generator keeps between calls (`bound`: the weights' and the state's
    pointers, then the widths, the plan and the stream), returning y.  The
    rows' clocks and lengths go to the entry point as host arrays, which it
    copies into the launch's own parameters; K5 writes every step of y, 0
    past a row's length, so y is not zeroed first.  `steps` is the longest
    row's length: at 0 nothing is launched."""
    T, _, B, _ = cond_pre.shape
    if not steps:
        return torch.zeros((T, B), dtype=torch.int32, device=cond_pre.device)
    y = torch.empty((T, B), dtype=torch.int32, device=cond_pre.device)
    kernel(*bound["head"], cond_pre.data_ptr(), sel.data_ptr(),
           *bound["state"], y.data_ptr(), t0_row.data_ptr(),
           n_valid_row.data_ptr(), T, *bound["tail"])
    return y


# K1 card-wide's stamps (csrc/wide_generate.cu `stats`, `Stat`): on each
# card its CTAs' chains' cycles, summed there: in the grid barriers
# (gen.wide.wait_cycles), over the launches (gen.wide.cta_cycles), waiting
# for a weight slice (gen.wide.stream_wait_cycles) and by the step's other
# parts; on unless WIDE_STAMPS is False.  Read into the counters only when
# `tracing.counters()` is read.
WIDE_STAMPS = True
WIDE_STATS = ("gen.wide.wait_cycles", "gen.wide.cta_cycles",
              "gen.wide.stream_wait_cycles", "gen.wide.prev_wait_cycles",
              "gen.wide.cur_cycles", "gen.wide.load_h_cycles",
              "gen.wide.rs_cycles", "gen.wide.load_x_cycles",
              "gen.wide.step_ends_cycles", "gen.wide.vector_wait_cycles")
_WIDE_STATS: Dict[torch.device, torch.Tensor] = {}


def _wide_stats(dev) -> torch.Tensor:
    if dev not in _WIDE_STATS:
        _WIDE_STATS[dev] = torch.zeros(len(WIDE_STATS), dtype=torch.int64,
                                       device=dev)
    return _WIDE_STATS[dev]


def _wide_counters() -> Dict[str, int]:
    """The stamps summed over the cards, or nothing before a launch."""
    if not _WIDE_STATS:
        return {}
    total = [0] * len(WIDE_STATS)
    for t in _WIDE_STATS.values():
        total = [a + b for a, b in zip(total, t.tolist())]
    return dict(zip(WIDE_STATS, total))


tracing.add_source(_wide_counters)


def _launch_wide(cfg: WaveNetConfig, plan_arr, params: Dict[str, torch.Tensor],
                 weights: torch.Tensor, scratch: torch.Tensor,
                 sync: torch.Tensor, sched: torch.Tensor, t0: int,
                 cond_pre: torch.Tensor, sel: torch.Tensor, ring: torch.Tensor,
                 y_state: torch.Tensor, n_valid: int, mode: str, stream: int):
    """K1 card-wide: `weights` the stream (`wide_stream`), `scratch` the
    activations between its CTAs, `sync` its grid barrier's count (one
    unsigned int; one of each a generator and card), `plan_arr` the plan's
    array; outputs as `_launch_kernel`.  Counts `gen.wide.launches`,
    `gen.wide.row_steps`, `gen.wide.barriers` (the grid barriers every CTA
    passes, 2L + 2 a step) and `gen.wide.clusters` (the clusters the launch
    ran in, G over the cluster size the C side launched with: each vector
    passed between CTAs leaves L2 once a cluster), and the launch is the
    span `nvw:gen.wide.launch`."""
    T, _, B, _ = cond_pre.shape
    y = torch.zeros((T, B), dtype=torch.int32, device=cond_pre.device)
    if n_valid:
        tracing.count("gen.wide.launches", 1)
        tracing.count("gen.wide.row_steps", B * n_valid)
        stats = (_wide_stats(cond_pre.device).data_ptr() if WIDE_STAMPS
                 else None)
        cluster = ctypes.c_int(0)
        with tracing.span("gen.wide.launch"):
            WIDE_KERNELS["exact"](
                params["embed"].data_ptr(), weights.data_ptr(),
                *(params[k].data_ptr() for k in ("rs_b", "out_b", "end_b")),
                cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
                ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), sync.data_ptr(), stats, t0, n_valid, B,
                cfg.num_layers, cfg.R, cfg.S, cfg.A, int(cfg.tanh_embed),
                cfg.silence_bin, _MODE_IDS[mode], ctypes.addressof(plan_arr),
                stream, ctypes.pointer(cluster))
        tracing.count("gen.wide.barriers",
                      n_valid * (2 * cfg.num_layers + 2))
        tracing.count("gen.wide.clusters", plan_arr[0] // cluster.value)
    return y, ring, y_state


def _stream_stacks(params: Dict[str, torch.Tensor], plan: StreamPlan
                   ) -> tuple:
    """The first K4's stored stacks (dil_w, rs_w, dil_s, rs_s) in
    `plan.storage` (`stream_storage`): int8 with their scales, bf16, or the
    fp32 tensors themselves (no scales); rows padded with zeros to
    `plan.dil_stride` and `plan.rs_stride` elements."""
    if plan.storage == torch.int8:
        qd, sd, qr, sr = quantize_stream_weights(params)
    else:
        qd, qr = (params[k].to(plan.storage) for k in ("dil_w", "rs_w"))
        sd = sr = None

    def pad(w, n):
        return torch.nn.functional.pad(w, (0, n - w.shape[-1])).contiguous()
    return pad(qd, plan.dil_stride), pad(qr, plan.rs_stride), sd, sr


def make_persistent_generator(cfg: WaveNetConfig, batch: int,
                              mode: str = "sample", dump: bool = False,
                              weight_dtype=torch.float32,
                              stream_weights: bool = False,
                              stream_group_size: int = 8,
                              stream_prefetch: bool = False,
                              stream_quant: bool = False,
                              ragged: bool = False,
                              compute_dtype=torch.float32,
                              fast_math: bool = False,
                              shared: Dict | None = None):
    """Build `generate(params, t0, cond_pre, sel, ring, y_state, n_valid=None,
    seed=0)` (K1, K2, K3), or with ragged=True `generate(params, t0_row,
    cond_pre, sel, ring, y_state, n_valid_row)` (K5).

    params: canonical float32 tensors (`models/params.canonical_to_torch`);
    t0: absolute index of the call's first sample (FIFO addressing, so
    chunked calls equal one call); cond_pre: [T, L, B, 2R] conditioning with
    dil_b already added; sel: [T, B] uniforms; ring: [ring_size, B, R] from
    `init_ring`; y_state: [2, B] int32 (y_prev, y_cur); n_valid: the number
    of leading steps to run (default T) - later steps leave the state
    untouched and emit 0.

    Modes: "sample" (inverse CDF over the uniforms in sel) and "argmax"
    (K1); "forced" (K2): sel carries the symbols to emit, integers in
    [0, A) as floats, checked on the host; "prng" (K3): sel is not read,
    step t of row b draws `scan_generate.prng_uniform_sel(seed, t, B)[b]`
    (seed: an int, taken modulo 2^64).

    ragged=True (mode "sample", no dump): t0_row [B] int64 and n_valid_row
    [B] int32 are CPU tensors, per-row control as K1's t0 and n_valid are
    host ints.  Row b runs its first n_valid_row[b] steps (0 <= n <= T) from
    its own absolute clock t0_row[b] >= 0; past its length a row keeps its
    FIFO content and y_state and emits 0.  The wrapper checks them on the
    host, and K5 takes them by value in its launch's parameters: no copy,
    no synchronisation, and no fill of y (K5 writes its 0s itself).

    A generator binds what outlives a call once and keeps it while it holds
    (checked, with its storage, its FIFO layout and for K5 the entry
    point's arguments): the params' tensors, unchanged in place, the ring
    and y_state objects, the device and its current stream.  A call checks
    cond_pre and sel (and K5's t0_row and n_valid_row) alone; a change to
    any of the others binds anew, and a ragged generator counts that in
    `utils/tracing` as `k5.binds`.

    Returns y [T, B] int32, ring, y_state (the same tensors, updated in
    place), plus xt [L,B,R], skip [L,B,S], zs, za, p [B,A] of the last run
    step when dump=True, plus p_seq [T, B, A] float32 (zero past n_valid)
    in mode "forced": the JAX order.  All tensors on one device: CPU runs
    the plain loop, CUDA launches the kernel `generation_route` names (K1,
    K2, K3, K5, or K4 in every mode with stream_weights=True; a geometry
    the staged plan cannot hold runs the generic K1/K5 and the first K4 in
    K4's and K2/K3's place, or the generic kernel where its plan raises).
    The route is made here and kept on the generator as `.route`.

    Storage (see the module docstring): params stay the canonical fp32
    tensors; weight_dtype=torch.bfloat16 and stream_quant (int8 stacks, only
    with stream_weights, as in the JAX package) make every path compute
    with `value_view(params)`, and K4 holds the stored form on the card
    (bf16 stacks, or int8 stacks and their scales), both built once per
    params object.  stream_group_size and stream_prefetch schedule the
    first K4's copies (`stream_plan`) and change no value; the staged K4
    runs one schedule whatever they say.  ragged=True never streams.

    Precision (`scan_generate.precision(compute_dtype, fast_math)`): under
    fast_math or compute_dtype=torch.bfloat16 every path computes with
    `scan_generate.product_view` of the storage's values and rounds the
    activations entering products; K4 then streams the stacks as bf16
    (`stream_storage`; int8 stays int8).  compute_dtype=torch.bfloat16
    stores x rounded and takes the ring as bf16 (`init_ring(dtype=
    scan_generate.ring_dtype(...))`); a ring of another dtype raises.

    shared: a dict that several generators of one caller (the engine) pass
    alike.  Their storage is kept there by what it holds, so generators
    whose kernels read the same stream (K1/K5 and the staged K2/K3, on K1's
    stream in the precision's storage) hold one copy of the weights.
    """
    if mode not in scan_generate.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    prec = scan_generate.precision(compute_dtype, fast_math)
    stream_quant = bool(stream_quant and stream_weights)
    check_storage(weight_dtype, stream_quant)
    if ragged and (mode != "sample" or dump or stream_weights):
        raise ValueError("ragged=True (K5) runs mode='sample' without dump "
                         "or stream_weights only, as the TPU kernel's ragged "
                         "variant")
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    B = batch
    route = generation_route(
        cfg, B, prec, mode, ragged, stream_weights,
        stream_storage(weight_dtype, stream_quant, prec), stream_group_size,
        dump)
    plan = route.plan
    shapes = params_lib.canonical_shapes(L, R, cfg.S, A)
    scheds: Dict[torch.device, torch.Tensor] = {}  # the FIFO layout per card
    # K1 card-wide's activations between CTAs and its barrier's count, per card
    wide_bufs: Dict[torch.device, tuple] = {}
    # the last params object's storage, under a key that names what it
    # holds: one stream for every staged route on the same layout
    layout = ((plan.matrices, plan.storage, plan.out_storage)
              if route.kernel in ("staged", "staged_stream")
              else (route.kernel, plan))
    slot = (weight_dtype, stream_quant, prec, layout)
    stored: Dict[str, tuple] = ({} if shared is None
                                else shared.setdefault(slot, {}))

    def build_stored(params, view):
        """What the route's kernel reads besides the view: the staged
        kernels' (stream, dil_s, rs_s), the first K4's stacks (dil_w, rs_w,
        dil_s, rs_s); None for the others."""
        if route.kernel == "wide":
            return wide_stream(view, cfg, plan), None, None
        if route.kernel in ("staged", "staged_stream"):
            if plan.storage == torch.int8:
                # int8 quantises the canonical params; K4 rounds q * s
                qd, sd, qr, sr = quantize_stream_weights(params)
                return (staged_stream({**view, "dil_w": qd, "rs_w": qr}, cfg,
                                      plan), sd, sr)
            return staged_stream(view, cfg, plan), None, None
        if route.kernel == "stream":
            return _stream_stacks(params if stream_quant else view, plan)
        return None

    def storage(params, dev):
        """(the values the products take, what `build_stored` makes on a
        card or None), rebuilt when a tensor of params is replaced or
        changed in place."""
        on_card = dev.type == "cuda" and route.kernel in (
            "staged", "staged_stream", "stream", "wide")
        if (weight_dtype == torch.float32 and not stream_quant
                and prec == "exact" and not on_card):
            return params, None
        src = tuple(params[k] for k in params_lib.PARAM_ORDER)
        key = tuple(t._version for t in src)
        old = stored.get("src")
        if (old is None or stored["key"] != key
                or any(a is not b for a, b in zip(old, src))):
            view = scan_generate.product_view(
                value_view(params, weight_dtype, stream_quant), prec)
            stored.update(src=src, key=key, view=view,
                          built=build_stored(params, view) if on_card
                          else None)
        return stored["view"], stored["built"]

    def check(cond_pre, sel):
        """What a call brings anew: (its device, T)."""
        dev = cond_pre.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        T = cond_pre.shape[0]
        build.check_tensor(cond_pre, "cond_pre", torch.float32,
                           (T, L, B, 2 * R), dev)
        build.check_tensor(sel, "sel", torch.float32, (T, B), dev)
        return dev, T

    # the plan as the staged entry points read it, made once
    plan_arr = (_plan_array(plan)
                if route.kernel in ("staged", "staged_stream", "wide")
                else None)
    kernel = route.cuda_kernel(prec)
    bound: Dict[str, object] = {}   # `bind`'s arguments, while they hold

    def bind(params, dev, ring, y_state) -> Dict[str, object]:
        """The arguments of a call that outlive it, checked once and kept
        while they hold: the params' tensors (the same objects, unchanged
        in place: their `_version`s), the ring and y_state (the same
        objects), the device and its current stream.  When any differs they
        are checked and bound anew (K5 counts it, `k5.binds`): the storage
        (`storage`), the FIFO layout, and for K5 on a card the entry point's
        arguments but those of the call (`_launch_ragged`)."""
        stream = build.current_stream(dev) if dev.type == "cuda" else None
        src = [params[k] for k in params_lib.PARAM_ORDER]
        if (bound and bound["ring"] is ring and bound["y_state"] is y_state
                and bound["dev"] == dev and bound["stream"] == stream
                and all(a is b for a, b in zip(bound["src"], src))
                and bound["versions"] == [t._version for t in src]):
            return bound
        check_t = build.check_tensor
        check_t(ring, "ring", scan_generate.ring_dtype(prec),
                (cfg.ring_size, B, R), dev)
        check_t(y_state, "y_state", torch.int32, (2, B), dev)
        for k, shape in shapes.items():
            check_t(params[k], k, torch.float32, shape, dev)
        view, built = storage(params, dev)
        new = {"src": src, "versions": [t._version for t in src],
               "ring": ring, "y_state": y_state, "dev": dev,
               "stream": stream, "view": view, "built": built}
        if dev.type == "cuda":
            if dev not in scheds:
                scheds[dev] = fifo_schedule(cfg, dev)
            new["sched"] = sched = scheds[dev]
            if ragged:
                weights = ((view["embed"], built[0],
                            *(view[k] for k in ("rs_b", "out_b", "end_b")))
                           if route.kernel == "staged"
                           else tuple(view[k] for k in _WEIGHTS))
                new["head"] = tuple(w.data_ptr() for w in weights)
                new["state"] = (sched.data_ptr(), ring.data_ptr(),
                                y_state.data_ptr())
                new["tail"] = ((B, L, R, cfg.S, A, int(cfg.tanh_embed),
                                cfg.silence_bin)
                               + ((ctypes.addressof(plan_arr),)
                                  if plan_arr is not None else ())
                               + (stream,))
        bound.clear()
        bound.update(new)
        if ragged:
            tracing.count("k5.binds", 1)
        return bound

    def generate(params: Dict[str, torch.Tensor], t0: int,
                 cond_pre: torch.Tensor, sel: torch.Tensor,
                 ring: torch.Tensor, y_state: torch.Tensor,
                 n_valid: int | None = None, seed: int = 0):
        dev, T = check(cond_pre, sel)
        bnd = bind(params, dev, ring, y_state)
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
        view, built = bnd["view"], bnd["built"]
        if dev.type == "cpu":
            return generate_plain(cfg, view, t0, cond_pre, sel, ring,
                                  y_state, n_valid, mode, dump, int(seed),
                                  prec)
        sched, stream = bnd["sched"], bnd["stream"]
        if route.kernel == "wide":
            if dev not in wide_bufs:
                wide_bufs[dev] = (
                    torch.empty(plan.scratch_floats, dtype=torch.float32,
                                device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
            return _launch_wide(cfg, plan_arr, view, built[0], *wide_bufs[dev],
                                sched, t0, cond_pre, sel, ring, y_state,
                                n_valid, mode, stream)
        if route.kernel in ("staged", "staged_stream"):
            return _launch_staged(cfg, plan, plan_arr, view, built, sched,
                                  t0, cond_pre, sel, ring, y_state, n_valid,
                                  mode, dump, int(seed), prec, stream)
        if route.kernel == "stream":
            return _launch_stream(cfg, plan, stream_prefetch, view, built,
                                  sched, t0, cond_pre, sel, ring, y_state,
                                  n_valid, mode, dump, int(seed), prec,
                                  stream)
        return _launch_kernel(cfg, view, sched, t0, cond_pre, sel, ring,
                              y_state, n_valid, mode, dump, int(seed), prec,
                              stream)

    def generate_ragged(params: Dict[str, torch.Tensor],
                        t0_row: torch.Tensor, cond_pre: torch.Tensor,
                        sel: torch.Tensor, ring: torch.Tensor,
                        y_state: torch.Tensor, n_valid_row: torch.Tensor):
        dev, T = check(cond_pre, sel)
        bnd = bind(params, dev, ring, y_state)
        build.check_tensor(t0_row, "t0_row", torch.int64, (B,), _CPU)
        build.check_tensor(n_valid_row, "n_valid_row", torch.int32, (B,),
                           _CPU)
        t0 = t0_row.tolist()   # B ints: cheaper than torch's reductions
        if min(t0) < 0:
            raise ValueError(f"t0_row {t0} must be >= 0")
        nv = n_valid_row.tolist()
        steps = max(nv)
        if min(nv) < 0 or steps > T:
            raise ValueError(f"n_valid_row {nv} outside [0, T={T}]")
        # K5's CTA b loops n_valid_row[b] steps (staged_generate.cu and
        # generic_generate.cu), so the launch lasts its longest row's: of
        # its B x that many row-steps, sum(n_valid_row) are live
        tracing.count("k5.row_steps", B * steps)
        tracing.count("k5.live_row_steps", sum(nv))
        if dev.type == "cpu":
            return generate_plain(cfg, bnd["view"], t0_row, cond_pre, sel,
                                  ring, y_state, n_valid_row, prec=prec)
        return (_launch_ragged(kernel, bnd, t0_row, cond_pre, sel,
                               n_valid_row, steps), ring, y_state)

    def prepare(params: Dict[str, torch.Tensor], dev) -> None:
        """Build, on the current stream, what a launch on `dev` reads
        besides its arguments (the FIFO layout, the storage of `params`): a
        caller that launches one generator on several streams of a device
        calls this first, so that no launch reads a cache another stream is
        still writing."""
        dev = torch.device(dev)
        if dev.type == "cuda" and dev not in scheds:
            scheds[dev] = fifo_schedule(cfg, dev)
        storage(params, dev)

    out = generate_ragged if ragged else generate
    out.route = route
    out.prepare = prepare
    return out
