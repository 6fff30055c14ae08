"""The persistent generator: the whole generation of a call in one kernel
launch (K1, `csrc/persistent.cu`), with its plain PyTorch version.

The port's counterpart of `nv_wavenet_tpu/ops/persistent.py`
(`make_persistent_generator`), modes "sample" and "argmax", with the
optional last-step activation dump.  A CUDA tensor launches K1; a CPU tensor
runs the plain loop of `ops/scan_generate.py`.  Nothing falls back from one
to the other.

Differences from the TPU kernel, all value-preserving:
  * no chunk padding and no grid: the kernel loops over `n_valid` steps
    itself, so a call may have any length;
  * the FIFO ring is the plain [ring_size, B, R] layout of
    `WaveNetConfig.ring_offsets` (the TPU's lane-packed ring is a 128-lane
    tiling artifact);
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


def init_ring(cfg: WaveNetConfig, batch: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Zero FIFO state [ring_size, batch, R]: 'no past activations', as the
    golden model treats t < d_l."""
    return torch.zeros((cfg.ring_size, batch, cfg.R), dtype=dtype,
                       device=device)


def generate_plain(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   t0: int, cond_pre: torch.Tensor, sel: torch.Tensor,
                   ring: torch.Tensor, y_state: torch.Tensor, n_valid: int,
                   mode: str = "sample", dump: bool = False):
    """The plain version of K1, on any device: the loop of
    `scan_generate.run_steps`, with the kernel's outputs (see
    `make_persistent_generator`)."""
    y, aux = scan_generate.run_steps(params, cfg, t0, cond_pre, sel, ring,
                                     y_state, n_valid, mode, dump)
    out = (y, ring, y_state)
    if dump:
        if aux is None:
            aux = _empty_dumps(cfg, cond_pre.shape[2], cond_pre.device)
        out += tuple(aux[k] for k in _DUMP_KEYS)
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


def _launch_kernel(cfg: WaveNetConfig, params: Dict[str, torch.Tensor],
                   sched: torch.Tensor, t0: int, cond_pre: torch.Tensor,
                   sel: torch.Tensor, ring: torch.Tensor,
                   y_state: torch.Tensor, n_valid: int, mode: str, dump: bool):
    T, _, B, _ = cond_pre.shape
    dev = cond_pre.device
    y = torch.zeros((T, B), dtype=torch.int32, device=dev)
    dumps = _empty_dumps(cfg, B, dev) if dump else None
    d_ptrs = ([dumps[k].data_ptr() for k in _DUMP_KEYS] if dump
              else [None] * len(_DUMP_KEYS))
    if n_valid:
        PERSISTENT_KERNEL(
            *(params[k].data_ptr() for k in ("embed", "dil_w", "rs_w", "rs_b",
                                              "out_w", "out_b", "end_w",
                                              "end_b")),
            cond_pre.data_ptr(), sel.data_ptr(), sched.data_ptr(),
            ring.data_ptr(), y_state.data_ptr(), y.data_ptr(), *d_ptrs,
            t0, n_valid, B, cfg.num_layers, cfg.R, cfg.S, cfg.A,
            int(cfg.tanh_embed), cfg.silence_bin, _MODE_IDS[mode],
            build.current_stream(dev))
    out = (y, ring, y_state)
    if dump:
        out += tuple(dumps[k] for k in _DUMP_KEYS)
    return out


def make_persistent_generator(cfg: WaveNetConfig, batch: int,
                              mode: str = "sample", dump: bool = False,
                              stream_weights: bool = False,
                              stream_quant: bool = False,
                              ragged: bool = False):
    """Build `generate(params, t0, cond_pre, sel, ring, y_state, n_valid=None)`.

    params: canonical float32 tensors (`models/params.canonical_to_torch`);
    t0: absolute index of the call's first sample (FIFO addressing, so
    chunked calls equal one call); cond_pre: [T, L, B, 2R] conditioning with
    dil_b already added; sel: [T, B] uniforms; ring: [ring_size, B, R] from
    `init_ring`; y_state: [2, B] int32 (y_prev, y_cur); n_valid: the number
    of leading steps to run (default T) - later steps leave the state
    untouched and emit 0.

    Returns y [T, B] int32, ring, y_state (the same tensors, updated in
    place), plus xt [L,B,R], skip [L,B,S], zs, za, p [B,A] of the last run
    step when dump=True.  All tensors on one device: CPU runs the plain
    loop, CUDA launches K1.
    """
    if mode == "forced":
        raise NotImplementedError("mode='forced' is kernel K2 of ROADMAP.md, "
                                  "still to port")
    if mode == "prng":
        raise NotImplementedError("mode='prng' is kernel K3 of ROADMAP.md, "
                                  "still to port")
    if mode not in _MODE_IDS:
        raise ValueError(f"unknown mode {mode!r}")
    if stream_weights or stream_quant:
        raise NotImplementedError("stream_weights / stream_quant are kernel "
                                  "K4 of ROADMAP.md, still to port")
    if ragged:
        raise NotImplementedError("ragged=True is kernel K5 of ROADMAP.md, "
                                  "still to port")
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    B = batch
    shapes = params_lib.canonical_shapes(L, R, cfg.S, A)
    scheds: Dict[torch.device, torch.Tensor] = {}  # K1's FIFO layout per card

    def generate(params: Dict[str, torch.Tensor], t0: int,
                 cond_pre: torch.Tensor, sel: torch.Tensor,
                 ring: torch.Tensor, y_state: torch.Tensor,
                 n_valid: int | None = None):
        dev = cond_pre.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        T = cond_pre.shape[0]
        n_valid = T if n_valid is None else int(n_valid)
        if not 0 <= n_valid <= T:
            raise ValueError(f"n_valid={n_valid} outside [0, T={T}]")
        t0 = int(t0)
        if t0 < 0:
            raise ValueError(f"t0={t0} must be >= 0")
        check = build.check_tensor
        check(cond_pre, "cond_pre", torch.float32, (T, L, B, 2 * R), dev)
        check(sel, "sel", torch.float32, (T, B), dev)
        check(ring, "ring", torch.float32, (cfg.ring_size, B, R), dev)
        check(y_state, "y_state", torch.int32, (2, B), dev)
        for k, shape in shapes.items():
            check(params[k], k, torch.float32, shape, dev)
        if dev.type == "cpu":
            return generate_plain(cfg, params, t0, cond_pre, sel, ring,
                                  y_state, n_valid, mode, dump)
        if dev not in scheds:
            scheds[dev] = fifo_schedule(cfg, dev)
        return _launch_kernel(cfg, params, scheds[dev], t0, cond_pre, sel,
                              ring, y_state, n_valid, mode, dump)

    return generate
