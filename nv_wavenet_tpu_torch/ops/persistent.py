"""The persistent generator: the whole generation of a call in one kernel
launch (K1, K2, K3 and K5, `csrc/persistent.cu`), with its plain PyTorch
version.

The port's counterpart of `nv_wavenet_tpu/ops/persistent.py`
(`make_persistent_generator`): modes "sample" and "argmax" with the
optional last-step activation dump (K1), mode "forced" (K2: teacher forcing,
the per-step distributions p_seq appended to the outputs), mode "prng" (K3:
selectors drawn on the card from Philox, `scan_generate.prng_uniform_sel`),
and `ragged=True`, per-row clocks and lengths in mode "sample" (K5, the
ragged feeds of the serving path).  A CUDA tensor launches the kernel; a CPU
tensor runs the plain loop of `ops/scan_generate.py`.  Nothing falls back
from one to the other.  `stream_weights`/`stream_quant` (K4) are still to
port and raise NotImplementedError.

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
from typing import Dict

import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import scan_generate
from nv_wavenet_tpu_torch.utils import build

_MODE_IDS = {"sample": 0, "argmax": 1}
_DUMP_KEYS = ("xt", "skip", "zs", "za", "p")
_P = ctypes.c_void_p
_I = ctypes.c_int

# K1: one CTA per batch row, all steps and layers inside one launch
PERSISTENT_KERNEL = build.CudaKernel(
    "persistent.cu", "nvw_persistent_generate",
    [_P] * 19 + [ctypes.c_longlong] + [_I] * 9 + [_P])
# K5: K1's instance with per-row clocks and lengths (ragged feeds)
RAGGED_KERNEL = build.CudaKernel(
    "persistent.cu", "nvw_persistent_generate_ragged",
    [_P] * 16 + [_I] * 7 + [_P])
# K2: K1's instance that consumes the symbols in sel and writes p_seq
FORCED_KERNEL = build.CudaKernel(
    "persistent.cu", "nvw_persistent_generate_forced",
    [_P] * 20 + [ctypes.c_longlong] + [_I] * 8 + [_P])
# K3: K1's instance that draws its selectors from Philox on the card
PRNG_KERNEL = build.CudaKernel(
    "persistent.cu", "nvw_persistent_generate_prng",
    [_P] * 18 + [ctypes.c_longlong] + [_I] * 8 + [ctypes.c_ulonglong, _P])


def init_ring(cfg: WaveNetConfig, batch: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Zero FIFO state [ring_size, batch, R]: 'no past activations', as the
    golden model treats t < d_l."""
    return torch.zeros((cfg.ring_size, batch, cfg.R), dtype=dtype,
                       device=device)


def generate_plain(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   t0, cond_pre: torch.Tensor, sel: torch.Tensor,
                   ring: torch.Tensor, y_state: torch.Tensor, n_valid,
                   mode: str = "sample", dump: bool = False, seed: int = 0):
    """The plain version of K1, K2, K3 and K5, on any device: the loop of
    `scan_generate.run_steps`, with the kernel's outputs (see
    `make_persistent_generator`).  t0 and n_valid are ints (K1, K2, K3) or
    the per-row host tensors t0_row and n_valid_row (K5)."""
    if isinstance(n_valid, torch.Tensor):
        t0, n_valid = t0.to(cond_pre.device), n_valid.to(cond_pre.device)
    y, aux, p_seq = scan_generate.run_steps(
        params, cfg, t0, cond_pre, sel, ring, y_state, n_valid, mode, dump,
        seed, "p" if mode == "forced" else None)
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
                   seed: int):
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
            FORCED_KERNEL(*head, sel.data_ptr(), *state, p_seq.data_ptr(),
                          *shape, stream)
        elif mode == "prng":
            PRNG_KERNEL(*head, *state, *shape, seed & 0xFFFFFFFFFFFFFFFF,
                        stream)
        else:
            PERSISTENT_KERNEL(*head, sel.data_ptr(), *state, *shape,
                              _MODE_IDS[mode], stream)
    out = (y, ring, y_state)
    if dump:
        out += tuple(dumps[k] for k in _DUMP_KEYS)
    if mode == "forced":
        out += (p_seq,)
    return out


def _launch_ragged(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   sched: torch.Tensor, t0_row: torch.Tensor,
                   cond_pre: torch.Tensor, sel: torch.Tensor,
                   ring: torch.Tensor, y_state: torch.Tensor,
                   n_valid_row: torch.Tensor):
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    # zeros, never empty: K5 writes no step past a row's length
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    if int(n_valid_row.max()):
        # pinned staging and non-blocking copies: the launch waits for
        # nothing queued before it
        t0_dev, nv_dev = (x.pin_memory().to(dev, non_blocking=True)
                          for x in (t0_row, n_valid_row))
        RAGGED_KERNEL(
            *(params[k].data_ptr() for k in _WEIGHTS),
            cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(),
            t0_dev.data_ptr(), nv_dev.data_ptr(), B, cfg.num_layers, cfg.R,
            cfg.S, cfg.A, int(cfg.tanh_embed), cfg.silence_bin,
            build.current_stream(dev))
    return y, ring, y_state


def make_persistent_generator(cfg: WaveNetConfig, batch: int,
                              mode: str = "sample", dump: bool = False,
                              stream_weights: bool = False,
                              stream_quant: bool = False,
                              ragged: bool = False):
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
    the plain loop, CUDA launches K1 (K2, K3, K5).
    """
    if mode not in scan_generate.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if stream_weights or stream_quant:
        raise NotImplementedError("stream_weights / stream_quant are kernel "
                                  "K4 of ROADMAP.md, still to port")
    if ragged and (mode != "sample" or dump):
        raise ValueError("ragged=True (K5) runs mode='sample' without dump "
                         "only, as the TPU kernel's ragged variant")
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    B = batch
    shapes = params_lib.canonical_shapes(L, R, cfg.S, A)
    scheds: Dict[torch.device, torch.Tensor] = {}  # the FIFO layout per card

    def check(params, cond_pre, sel, ring, y_state):
        dev = cond_pre.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        T = cond_pre.shape[0]
        check_t = build.check_tensor
        check_t(cond_pre, "cond_pre", torch.float32, (T, L, B, 2 * R), dev)
        check_t(sel, "sel", torch.float32, (T, B), dev)
        check_t(ring, "ring", torch.float32, (cfg.ring_size, B, R), dev)
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
        if dev.type == "cpu":
            return generate_plain(cfg, params, t0, cond_pre, sel, ring,
                                  y_state, n_valid, mode, dump, int(seed))
        return _launch_kernel(cfg, params, scheds[dev], t0, cond_pre, sel,
                              ring, y_state, n_valid, mode, dump, int(seed))

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
        if dev.type == "cpu":
            return generate_plain(cfg, params, t0_row, cond_pre, sel, ring,
                                  y_state, n_valid_row)
        return _launch_ragged(cfg, params, scheds[dev], t0_row, cond_pre,
                              sel, ring, y_state, n_valid_row)

    return generate_ragged if ragged else generate
