"""The persistent generator: the whole generation of a call in one kernel
launch (K1, K2, K3 and K5, `csrc/persistent.cu`; K4,
`csrc/stream_generate.cu`), with its plain PyTorch version.

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
of K1, K2, K3, K5 and K4 has an instance per precision, with its own entry
point and launch count (`PERSISTENT_KERNELS[prec]`, ...).  "fast" and
"bf16" compute with the storage's values rounded to bf16 where they enter
products (`scan_generate.product_view`, made once per params object), and
"bf16" keeps the FIFO ring as bf16 (`init_ring(dtype=...)`).

Weight storage and streaming (K4, the engine's `Impl.MANYBLOCK`):
  * `weight_dtype=torch.bfloat16` stores the nine parameters as bf16; every
    path computes with their fp32 values, `value_view`.  `stream_quant`
    stores dil_w and rs_w as int8 with one fp32 scale per (layer, output
    column) (`quantize_stream_weights`); the value of a weight is the one
    rounded product q * s (`dequantize_stream_params`).
  * `stream_weights=True` launches K4: K1's step, with dil_w and rs_w
    copied into a ring of shared-memory stages by bulk asynchronous copies
    (1D TMA), each stage a block of `StreamPlan.rows_per_stage` whole rows
    of one matrix.  Every output column still sums k = 0, 1, ..., K-1 from
    0 across the stages, so K4 equals K1 fed `value_view` bit for bit.
  * `stream_group_size` G: on the TPU one copy brings G layers, double
    buffered, so the copies run one group ahead.  A Hopper block may use
    227 KB of shared memory, less than two fp32 flagship layers (288 KB),
    so here G sets how far ahead the copies run: the ring holds G layers of
    stages (G * stages-per-layer + 1 slots), clamped to the shared memory;
    `stream_plan` reports the clamp.  `stream_prefetch=True` lets the
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
  * `prev_prefetch`, `rs_split` and `embed_split` are TPU schedules that give
    the same values; they are not ported;
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
from nv_wavenet_tpu_torch.utils import build

_MODE_IDS = {"sample": 0, "argmax": 1}
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


# K1: one CTA per batch row, all steps and layers inside one launch
PERSISTENT_KERNELS = _kernels(
    "persistent.cu", "nvw_persistent_generate",
    [_P] * 19 + [ctypes.c_longlong] + [_I] * 9 + [_P])
# K5: K1's instance with per-row clocks and lengths (ragged feeds)
RAGGED_KERNELS = _kernels(
    "persistent.cu", "nvw_persistent_generate_ragged",
    [_P] * 16 + [_I] * 7 + [_P])
# K2: K1's instance that consumes the symbols in sel and writes p_seq
FORCED_KERNELS = _kernels(
    "persistent.cu", "nvw_persistent_generate_forced",
    [_P] * 20 + [ctypes.c_longlong] + [_I] * 8 + [_P])
# K3: K1's instance that draws its selectors from Philox on the card
PRNG_KERNELS = _kernels(
    "persistent.cu", "nvw_persistent_generate_prng",
    [_P] * 18 + [ctypes.c_longlong] + [_I] * 8 + [ctypes.c_ulonglong, _P])
# K4: K1 with dil_w and rs_w streamed through shared memory, every mode
STREAM_KERNELS = _kernels(
    "stream_generate.cu", "nvw_stream_generate",
    [_P] * 22 + [ctypes.c_longlong, ctypes.c_ulonglong] + [_I] * 15 + [_P])
_STREAM_MODE_IDS = {"sample": 0, "argmax": 1, "forced": 2, "prng": 3}
# the stacks' storage dtypes in K4 (csrc/stream_generate.cu kStorage*)
_STORAGE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the shared memory one H100 block may use, and the H100's SMs
SMEM_PER_BLOCK = 232448
SMS = 132
STREAM_MAX_COLUMNS = 1024  # output columns of one product: kMaxTasks * kThreads
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
    """K4's shared-memory plan (`stream_plan`)."""
    storage: torch.dtype      # the stacks' dtype in device memory
    rows_per_stage: int       # weight rows one stage (one copy) brings
    stage_bytes: int          # one ring slot
    stages: int               # ring slots
    smem_bytes: int           # dynamic shared memory K4 asks for
    group_layers: int         # the lookahead asked for, min(G, L) layers
    lookahead_layers: float   # what the ring holds: (stages - 1) / per layer
    clamped: bool             # the shared memory cut the lookahead
    waves: int                # CTA waves of the batch, one CTA per SM


def stream_storage(weight_dtype=torch.float32, stream_quant: bool = False,
                   prec: str = "exact"):
    """The dtype K4's stacks are stored in on the card: int8 under
    stream_quant, else bf16 under the low precisions (the stacks enter
    products rounded to bf16, so bf16 holds their operands exactly), else
    weight_dtype."""
    if stream_quant:
        return torch.int8
    return torch.bfloat16 if prec != "exact" else weight_dtype


def activation_smem_bytes(cfg: WaveNetConfig, prec: str = "exact") -> int:
    """The shared memory one step's activations take in a CTA: K1's whole
    dynamic shared memory, and what K4 keeps beside its stages ((7R + S +
    4A) floats, R more under "fast" for the rounded copy of x; the launch
    in csrc/persistent.cu computes the same)."""
    return (7 * cfg.R + cfg.S + 4 * cfg.A
            + (cfg.R if prec == "fast" else 0)) * 4


def stream_plan(cfg: WaveNetConfig, batch: int, storage=torch.float32,
                stream_group_size: int = 8, prec: str = "exact"
                ) -> StreamPlan:
    """Decide K4's stages for `batch` rows with the stacks stored as
    `storage` (torch.float32, torch.bfloat16 or torch.int8; `stream_storage`)
    in precision `prec` (`scan_generate.PRECISIONS`; "fast" keeps a rounded
    copy of x beside the activations, R more floats).

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
    runs in waves.  Raises ValueError for a geometry K4 cannot run: more
    than 1024 output columns in a product (4R or R+S), rows that are not
    whole 16-byte units (the unit of a bulk copy), or fewer than two stages
    of one row."""
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
    if max(4 * R, R + S) > STREAM_MAX_COLUMNS:
        raise ValueError(f"K4 computes at most {STREAM_MAX_COLUMNS} output "
                         f"columns per product; 4R = {4 * R} and R+S = "
                         f"{R + S}")
    for name, n in (("dil_w", 2 * R), ("rs_w", R + S)):
        if n * eb % 16:
            raise ValueError(f"K4 copies whole 16-byte units: a row of "
                             f"{name} is {n * eb} bytes in {storage}")
    act = -(-activation_smem_bytes(cfg, prec) // 16) * 16
    budget = SMEM_PER_BLOCK - _STATIC_SMEM - act - 8
    rows = R & -R
    while True:
        stage = -(-max(2 * rows * 2 * R, rows * (R + S)) * eb // 128) * 128
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
                      -(-batch // SMS))


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


def _launch_kernel(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   sched: torch.Tensor, t0: int, cond_pre: torch.Tensor,
                   sel: torch.Tensor, ring: torch.Tensor,
                   y_state: torch.Tensor, n_valid: int, mode: str, dump: bool,
                   seed: int, prec: str):
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    dumps = _empty_dumps(cfg, B, dev) if dump else None
    d_ptrs = ([dumps[k].data_ptr() for k in _DUMP_KEYS] if dump
              else [None] * len(_DUMP_KEYS))
    # zeros: K2 writes no step past n_valid
    p_seq = (torch.zeros((T, B, cfg.A), dtype=torch.float32, device=dev)
             if mode == "forced" else None)
    head = [*(params[k].data_ptr() for k in _WEIGHTS), cond_pre.data_ptr()]
    state = [sched.data_ptr(), ring.data_ptr(), y_state.data_ptr(),
             y.data_ptr(), *d_ptrs]
    shape = [t0, n_valid, B, cfg.num_layers, cfg.R, cfg.S, cfg.A,
             int(cfg.tanh_embed), cfg.silence_bin]
    stream = build.current_stream(dev)
    if n_valid:
        if mode == "forced":
            FORCED_KERNELS[prec](*head, sel.data_ptr(), *state,
                                 p_seq.data_ptr(), *shape, stream)
        elif mode == "prng":
            PRNG_KERNELS[prec](*head, *state, *shape,
                               seed & 0xFFFFFFFFFFFFFFFF, stream)
        else:
            PERSISTENT_KERNELS[prec](*head, sel.data_ptr(), *state, *shape,
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
                   seed: int, prec: str):
    """K4: `params` gives the fp32 values of the small tensors, `stacks`
    the stored (dil_w, rs_w, dil_s, rs_s); outputs as `_launch_kernel`."""
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
            cfg.silence_bin, _STREAM_MODE_IDS[mode],
            _STORAGE_IDS[plan.storage], plan.rows_per_stage, plan.stages,
            plan.stage_bytes, int(prefetch), plan.smem_bytes,
            build.current_stream(dev))
    return (y, ring, y_state, *outs)


def _launch_ragged(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   sched: torch.Tensor, t0_row: torch.Tensor,
                   cond_pre: torch.Tensor, sel: torch.Tensor,
                   ring: torch.Tensor, y_state: torch.Tensor,
                   n_valid_row: torch.Tensor, prec: str):
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    # zeros, never empty: K5 writes no step past a row's length
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    if int(n_valid_row.max()):
        # pinned staging and non-blocking copies: the launch waits for
        # nothing queued before it
        t0_dev, nv_dev = (x.pin_memory().to(dev, non_blocking=True)
                          for x in (t0_row, n_valid_row))
        RAGGED_KERNELS[prec](
            *(params[k].data_ptr() for k in _WEIGHTS),
            cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
            t0_dev.data_ptr(), nv_dev.data_ptr(), B, cfg.num_layers, cfg.R,
            cfg.S, cfg.A, int(cfg.tanh_embed), cfg.silence_bin,
            build.current_stream(dev))
    return y, ring, y_state


def _stream_stacks(params: Dict[str, torch.Tensor], storage) -> tuple:
    """K4's stored stacks (dil_w, rs_w, dil_s, rs_s) in `storage`
    (`stream_storage`): int8 with their scales, bf16, or the fp32 tensors
    themselves (no scales)."""
    if storage == torch.int8:
        qd, sd, qr, sr = quantize_stream_weights(params)
        return qd, qr, sd, sr
    return (params["dil_w"].to(storage).contiguous(),
            params["rs_w"].to(storage).contiguous(), None, None)


def make_persistent_generator(cfg: WaveNetConfig, batch: int,
                              mode: str = "sample", dump: bool = False,
                              weight_dtype=torch.float32,
                              stream_weights: bool = False,
                              stream_group_size: int = 8,
                              stream_prefetch: bool = False,
                              stream_quant: bool = False,
                              ragged: bool = False,
                              compute_dtype=torch.float32,
                              fast_math: bool = False):
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
    host and stages them to the card without a synchronisation.

    Returns y [T, B] int32, ring, y_state (the same tensors, updated in
    place), plus xt [L,B,R], skip [L,B,S], zs, za, p [B,A] of the last run
    step when dump=True, plus p_seq [T, B, A] float32 (zero past n_valid)
    in mode "forced": the JAX order.  All tensors on one device: CPU runs
    the plain loop, CUDA launches K1 (K2, K3, K5), or K4 in every mode with
    stream_weights=True.

    Storage (see the module docstring): params stay the canonical fp32
    tensors; weight_dtype=torch.bfloat16 and stream_quant (int8 stacks, only
    with stream_weights, as in the JAX package) make every path compute
    with `value_view(params)`, and K4 holds the stored form on the card
    (bf16 stacks, or int8 stacks and their scales), both built once per
    params object.  stream_group_size and stream_prefetch schedule K4's
    copies (`stream_plan`) and change no value.  ragged=True never streams.

    Precision (`scan_generate.precision(compute_dtype, fast_math)`): under
    fast_math or compute_dtype=torch.bfloat16 every path computes with
    `scan_generate.product_view` of the storage's values and rounds the
    activations entering products; K4 then streams the stacks as bf16
    (`stream_storage`; int8 stays int8).  compute_dtype=torch.bfloat16
    stores x rounded and takes the ring as bf16 (`init_ring(dtype=
    scan_generate.ring_dtype(...))`); a ring of another dtype raises.
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
    plan = (stream_plan(cfg, B, stream_storage(weight_dtype, stream_quant,
                                               prec),
                        stream_group_size, prec) if stream_weights else None)
    shapes = params_lib.canonical_shapes(L, R, cfg.S, A)
    scheds: Dict[torch.device, torch.Tensor] = {}  # the FIFO layout per card
    stored: Dict[str, tuple] = {}   # the last params object's storage

    def storage(params, dev):
        """(the values the products take, K4's stacks or None), rebuilt
        when a tensor of params is replaced or changed in place."""
        if (weight_dtype == torch.float32 and not stream_quant
                and plan is None and prec == "exact"):
            return params, None
        src = tuple(params[k] for k in params_lib.PARAM_ORDER)
        key = tuple(t._version for t in src)
        old = stored.get("src")
        if (old is None or stored["key"] != key
                or any(a is not b for a, b in zip(old, src))):
            view = scan_generate.product_view(
                value_view(params, weight_dtype, stream_quant), prec)
            # int8 quantises the canonical params; K4 rounds q * s itself
            stacks = (_stream_stacks(params if stream_quant else view,
                                     plan.storage)
                      if plan is not None and dev.type == "cuda" else None)
            stored.update(src=src, key=key, stacks=stacks, view=view)
        return stored["view"], stored["stacks"]

    def check(params, cond_pre, sel, ring, y_state):
        dev = cond_pre.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        T = cond_pre.shape[0]
        check_t = build.check_tensor
        check_t(cond_pre, "cond_pre", torch.float32, (T, L, B, 2 * R), dev)
        check_t(sel, "sel", torch.float32, (T, B), dev)
        check_t(ring, "ring", scan_generate.ring_dtype(prec),
                (cfg.ring_size, B, R), dev)
        check_t(y_state, "y_state", torch.int32, (2, B), dev)
        for k, shape in shapes.items():
            check_t(params[k], k, torch.float32, shape, dev)
        if dev.type == "cuda" and dev not in scheds:
            scheds[dev] = fifo_schedule(cfg, dev)
        return dev, T

    def generate(params: Dict[str, torch.Tensor], t0: int,
                 cond_pre: torch.Tensor, sel: torch.Tensor,
                 ring: torch.Tensor, y_state: torch.Tensor,
                 n_valid: int | None = None, seed: int = 0):
        dev, T = check(params, cond_pre, sel, ring, y_state)
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
        view, stacks = storage(params, dev)
        if dev.type == "cpu":
            return generate_plain(cfg, view, t0, cond_pre, sel, ring,
                                  y_state, n_valid, mode, dump, int(seed),
                                  prec)
        if plan is not None:
            return _launch_stream(cfg, plan, stream_prefetch, view, stacks,
                                  scheds[dev], t0, cond_pre, sel, ring,
                                  y_state, n_valid, mode, dump, int(seed),
                                  prec)
        return _launch_kernel(cfg, view, scheds[dev], t0, cond_pre, sel,
                              ring, y_state, n_valid, mode, dump, int(seed),
                              prec)

    def generate_ragged(params: Dict[str, torch.Tensor],
                        t0_row: torch.Tensor, cond_pre: torch.Tensor,
                        sel: torch.Tensor, ring: torch.Tensor,
                        y_state: torch.Tensor, n_valid_row: torch.Tensor):
        dev, T = check(params, cond_pre, sel, ring, y_state)
        cpu = torch.device("cpu")
        build.check_tensor(t0_row, "t0_row", torch.int64, (B,), cpu)
        build.check_tensor(n_valid_row, "n_valid_row", torch.int32, (B,), cpu)
        if int(t0_row.min()) < 0:
            raise ValueError(f"t0_row {t0_row.tolist()} must be >= 0")
        if int(n_valid_row.min()) < 0 or int(n_valid_row.max()) > T:
            raise ValueError(f"n_valid_row {n_valid_row.tolist()} outside "
                             f"[0, T={T}]")
        view, _ = storage(params, dev)
        if dev.type == "cpu":
            return generate_plain(cfg, view, t0_row, cond_pre, sel, ring,
                                  y_state, n_valid_row, prec=prec)
        return _launch_ragged(cfg, view, scheds[dev], t0_row, cond_pre,
                              sel, ring, y_state, n_valid_row, prec)

    return generate_ragged if ragged else generate
