"""WaveNetInfer: the inference engine with API parity to the reference's
`nvWavenetInfer` class, on PyTorch and CUDA.

The port's counterpart of `nv_wavenet_tpu/engine/wavenet_infer.py`, for the
main path: the weight setters, `set_inputs`, `run` / `run_partial` /
`run_device` / `run_chunks`, and the activation getters of dump mode.

  * The engine runs on the card: `device=None` means "cuda", and on a host
    without CUDA that raises (it never falls back to the CPU).  Tests pass
    `device="cpu"`, which runs the plain PyTorch loop.
  * Implementations: AUTO, SINGLE_BLOCK, DUAL_BLOCK and PERSISTENT all map
    to kernel K1 (`ops/persistent.py`).  MANYBLOCK (weights streamed per
    layer, kernel K4) is still to port and raises NotImplementedError.
  * Conditioning is uploaded to the device once, in `set_inputs`; the
    dil_b-prefolded copy `cond_pre = cond + dil_b` is built there lazily,
    once per (inputs, weights).
  * `chunk_size` is the most samples one kernel launch generates; longer
    runs are split into launches that carry the FIFO state, exactly as one
    launch would.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import persistent


class Impl(enum.Enum):
    """Implementation selector (API parity with the reference)."""
    AUTO = 0
    SINGLE_BLOCK = 1
    DUAL_BLOCK = 2
    PERSISTENT = 3
    MANYBLOCK = 4


def _selector_stream(seed: int, t0, T: int, B: int,
                     pidx: int = 0) -> np.ndarray:
    """Default selectors [T, B]: a counter-based uniform stream (splitmix64
    finalizer) keyed on (seed, ABSOLUTE sample index, batch row, process),
    bit-identical to the JAX package's.  `t0` is a scalar or a per-row [B]
    vector of absolute clocks."""
    t0a = np.asarray(t0, np.uint64)
    t = np.arange(T, dtype=np.uint64)[:, None] + t0a[None, :] \
        if t0a.ndim == 1 else np.arange(t0a, t0a + np.uint64(T),
                                        dtype=np.uint64)[:, None]
    b = np.arange(B, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        x = (np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
             + t * np.uint64(0x9E3779B97F4A7C15)
             + b * np.uint64(0xC2B2AE3D27D4EB4F)
             + np.uint64(pidx) * np.uint64(0x165667B19E3779F9))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    # top 24 bits -> uniform [0, 1) float32
    return ((x >> np.uint64(40)).astype(np.float32)
            * np.float32(2.0 ** -24))


def resolve_device(device) -> torch.device:
    """`None` means the card.  Asking for CUDA on a host without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("nv_wavenet_tpu_torch runs on a CUDA device and "
                           "none is available; pass device='cpu' to run the "
                           "plain PyTorch path explicitly")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _Readback:
    """An asynchronous device-to-host copy of y [T, B], queued on the
    current stream behind the kernel that produced it."""

    def __init__(self, y_dev: torch.Tensor):
        if y_dev.device.type == "cpu":
            self._host, self._event = y_dev, None
            return
        self._host = torch.empty(y_dev.shape, dtype=y_dev.dtype,
                                 pin_memory=True)
        self._host.copy_(y_dev, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class WaveNetInfer:
    def __init__(self,
                 num_layers: int,
                 max_dilation: int,
                 R: int = 64,
                 S: int = 256,
                 A: int = 256,
                 max_batch: int = 1,
                 implementation: Impl = Impl.AUTO,
                 tanh_embed: bool = True,
                 chunk_size: int = 64,
                 device=None):
        if implementation == Impl.MANYBLOCK:
            raise NotImplementedError(
                "Impl.MANYBLOCK streams weights per layer: kernel K4 of "
                "ROADMAP.md, still to port")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.device = resolve_device(device)
        self.cfg = WaveNetConfig(num_layers=num_layers, R=R, S=S, A=A,
                                 max_dilation=max_dilation,
                                 tanh_embed=tanh_embed)
        self.max_batch = max_batch
        self.implementation = implementation
        self.chunk_size = chunk_size
        self.sampling_seed = 0
        L = num_layers
        # canonical params assembled incrementally by the setters (host)
        self._np_params: Dict[str, np.ndarray] = {
            k: np.zeros(s, np.float32)
            for k, s in params_lib.canonical_shapes(L, R, S, A).items()}
        self._params: Optional[Dict[str, torch.Tensor]] = None  # device copy
        self._cond: Optional[torch.Tensor] = None
        self._cond_pre: Optional[torch.Tensor] = None
        self._selectors: Optional[torch.Tensor] = None
        self._ring: Optional[torch.Tensor] = None
        self._y_state: Optional[torch.Tensor] = None
        self._dumps: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # weight upload (reference setter parity)
    # ------------------------------------------------------------------

    def _invalidate(self):
        self._params = None
        self._cond_pre = None

    def set_embeddings(self, embed_prev, embed_cur):
        """embed_prev/embed_cur: [R, A] (column per symbol)."""
        self._np_params["embed"] = np.concatenate(
            [np.asarray(embed_prev, np.float32).T,
             np.asarray(embed_cur, np.float32).T], axis=0)
        self._invalidate()

    def set_layer_weights(self, layer, Wprev, Wcur, Bh, Wres, Bres, Wskip, Bskip):
        """Reference math shapes: Wprev/Wcur [2R, R], Bh [2R], Wres [R, R],
        Bres [R], Wskip [S, R], Bskip [S]."""
        R = self.cfg.R
        p = self._np_params
        p["dil_w"][layer] = np.concatenate(
            [np.asarray(Wprev, np.float32).T, np.asarray(Wcur, np.float32).T],
            axis=0)
        p["dil_b"][layer] = np.asarray(Bh, np.float32)
        p["rs_w"][layer, :, :R] = np.asarray(Wres, np.float32).T
        p["rs_w"][layer, :, R:] = np.asarray(Wskip, np.float32).T
        p["rs_b"][layer, :R] = np.asarray(Bres, np.float32)
        p["rs_b"][layer, R:] = np.asarray(Bskip, np.float32)
        self._invalidate()

    def set_out_weights(self, Wzs, Bzs, Wza, Bza):
        """Wzs [A, S], Wza [A, A]."""
        p = self._np_params
        p["out_w"] = np.asarray(Wzs, np.float32).T.copy()
        p["out_b"] = np.asarray(Bzs, np.float32).copy()
        p["end_w"] = np.asarray(Wza, np.float32).T.copy()
        p["end_b"] = np.asarray(Bza, np.float32).copy()
        self._invalidate()

    def set_reference_weights(self, ref: Dict):
        """Upload a whole reference-shaped weight dict at once."""
        self.set_embeddings(ref["embed_prev"], ref["embed_cur"])
        for l in range(self.cfg.num_layers):
            self.set_layer_weights(l, ref["Wprev"][l], ref["Wcur"][l],
                                   ref["Bh"][l], ref["Wres"][l], ref["Bres"][l],
                                   ref["Wskip"][l], ref["Bskip"][l])
        self.set_out_weights(ref["Wzs"], ref["Bzs"], ref["Wza"], ref["Bza"])

    def set_canonical_params(self, params: Dict):
        """Upload params already in canonical layout."""
        params_lib.validate_canonical(params, self.cfg)
        self._np_params = {k: np.asarray(v, np.float32).copy()
                           for k, v in params.items()}
        self._invalidate()

    def _device_params(self) -> Dict[str, torch.Tensor]:
        if self._params is None:
            self._params = params_lib.canonical_to_torch(self._np_params,
                                                         self.device)
        return self._params

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def set_inputs(self, cond, selectors=None, seed: Optional[int] = None):
        """cond: [T, L, B, 2R] conditioning; selectors: [T, B] uniforms in
        [0, 1).  numpy arrays or tensors (a tensor already on the engine's
        device is used as it is).  With selectors=None they come from the
        default stream `_selector_stream` keyed on `seed` (default: the
        engine's `sampling_seed`).  Resets the generation state."""
        T, L, B, C = cond.shape
        if L != self.cfg.num_layers or C != 2 * self.cfg.R:
            raise ValueError(f"cond shape {tuple(cond.shape)} does not match "
                             f"config (L={self.cfg.num_layers}, "
                             f"2R={2 * self.cfg.R})")
        if B > self.max_batch:
            raise ValueError(f"batch {B} exceeds max_batch {self.max_batch}")
        if selectors is None:
            selectors = _selector_stream(
                self.sampling_seed if seed is None else seed, 0, T, B)
        if tuple(selectors.shape) != (T, B):
            raise ValueError(f"selectors shape {tuple(selectors.shape)} != "
                             f"{(T, B)}")
        self._cond = torch.as_tensor(cond, dtype=torch.float32,
                                     device=self.device).contiguous()
        self._selectors = torch.as_tensor(selectors, dtype=torch.float32,
                                          device=self.device).contiguous()
        self._cond_pre = None
        self._reset_state(B)

    def _reset_state(self, batch: int):
        self._ring = persistent.init_ring(self.cfg, batch, self.device)
        self._y_state = torch.full((2, batch), self.cfg.silence_bin,
                                   dtype=torch.int32, device=self.device)

    def _prefolded_cond(self) -> torch.Tensor:
        """cond + dil_b, built once per (inputs, weights) on the device: an
        exactly-rounded elementwise add, the same values the JAX engine
        prefolds."""
        if self._cond_pre is None:
            dil_b = self._device_params()["dil_b"]
            self._cond_pre = self._cond + dil_b[None, :, None, :]
        return self._cond_pre

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def run(self, num_samples: int, batch_size: int, mode: str = "sample",
            dump_activations: bool = False) -> np.ndarray:
        """Generate `num_samples` for `batch_size` utterances.
        Returns y: [batch, num_samples] int32 mu-law bins."""
        return self.run_partial(0, num_samples, batch_size, mode,
                                dump_activations)

    def _run_partial_device(self, init_sample: int, num_samples: int,
                            batch_size: int, mode: str,
                            dump_activations: bool) -> torch.Tensor:
        """Generate [init_sample, init_sample + num_samples) and return the
        device y [T, B] without reading it back."""
        if self._cond is None:
            raise RuntimeError("set_inputs must be called first")
        B = batch_size
        if B > self._cond.shape[2]:
            raise ValueError(f"batch_size {B} exceeds the batch of "
                             f"set_inputs ({self._cond.shape[2]})")
        if init_sample + num_samples > self._cond.shape[0]:
            raise ValueError("set_inputs cond is shorter than requested run")
        if init_sample == 0:
            self._reset_state(B)
        elif self._y_state.shape[1] != B:
            raise ValueError(f"batch_size {B} differs from the carried "
                             f"state's batch {self._y_state.shape[1]}")
        params = self._device_params()
        cond_pre = self._prefolded_cond()
        gen = persistent.make_persistent_generator(self.cfg, B, mode=mode,
                                                   dump=dump_activations)
        ys = []
        for t0 in range(init_sample, init_sample + num_samples,
                        self.chunk_size):
            n = min(self.chunk_size, init_sample + num_samples - t0)
            sl = slice(t0, t0 + n)
            cp = cond_pre[sl] if B == cond_pre.shape[2] \
                else cond_pre[sl, :, :B].contiguous()
            sel = self._selectors[sl, :B].contiguous()
            out = gen(params, t0, cp, sel, self._ring, self._y_state)
            ys.append(out[0])
            if dump_activations:
                self._dumps = dict(zip(("xt", "skip", "zs", "za", "p"),
                                       out[3:]))
        if not ys:
            return torch.zeros((0, B), dtype=torch.int32, device=self.device)
        return ys[0] if len(ys) == 1 else torch.cat(ys)

    def run_device(self, num_samples: int, batch_size: int,
                   mode: str = "sample") -> torch.Tensor:
        """Like `run` but returns the DEVICE tensor [T, B] without reading
        it back."""
        return self._run_partial_device(0, num_samples, batch_size, mode, False)

    def run_partial(self, init_sample: int, num_samples: int, batch_size: int,
                    mode: str = "sample", dump_activations: bool = False
                    ) -> np.ndarray:
        """Generate [init_sample, init_sample+num_samples); carried state
        makes chunked calls equal one full run."""
        y = self._run_partial_device(init_sample, num_samples, batch_size,
                                     mode, dump_activations)
        return y.T.cpu().numpy()

    def run_chunks(self, chunk_size: int, consume: Callable, num_samples: int,
                   batch_size: int, mode: str = "sample",
                   dump_activations: bool = False) -> np.ndarray:
        """Chunked generation with a host callback per chunk, which receives
        (y_chunk [B, n], sample_offset, n).  Each chunk's read-back is queued
        right behind its kernel and chunk i+1 is launched before chunk i is
        consumed, so the copy and the callback overlap the next chunk's
        generation."""
        ys = []
        pending = []  # (readback, offset, n)
        off = 0
        while off < num_samples:
            n = min(chunk_size, num_samples - off)
            y_dev = self._run_partial_device(off, n, batch_size, mode,
                                             dump_activations)
            pending.append((_Readback(y_dev), off, n))
            off += n
            while len(pending) > 1:
                ys.append(self._consume(consume, *pending.pop(0)))
        for p in pending:
            ys.append(self._consume(consume, *p))
        return np.concatenate(ys, axis=1)

    @staticmethod
    def _consume(consume: Callable, readback: "_Readback", off: int,
                 n: int) -> np.ndarray:
        y_host = readback.wait().T
        consume(y_host, off, n)
        return y_host

    # ------------------------------------------------------------------
    # activation getters (dump mode)
    # ------------------------------------------------------------------

    def _dump(self, key) -> np.ndarray:
        if self._dumps is None:
            raise RuntimeError("run with dump_activations=True before "
                               "reading activations")
        return self._dumps[key].cpu().numpy()

    def get_xt_out(self, layer: int) -> np.ndarray:
        return self._dump("xt")[layer]

    def get_skip_out(self, layer: int) -> np.ndarray:
        return self._dump("skip")[layer]

    def get_zs(self) -> np.ndarray:
        return self._dump("zs")

    def get_za(self) -> np.ndarray:
        return self._dump("za")

    def get_p(self) -> np.ndarray:
        return self._dump("p")
