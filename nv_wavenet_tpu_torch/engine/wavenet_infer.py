"""WaveNetInfer: the inference engine with API parity to the reference's
`nvWavenetInfer` class, on PyTorch and CUDA.

The port's counterpart of `nv_wavenet_tpu/engine/wavenet_infer.py`: the
weight setters, `set_inputs`, `run` / `run_partial` / `run_device` /
`run_chunks`, the activation getters of dump mode, the streaming serving
surface: `begin_stream`, `feed` / `feed_device` (with per-row `lengths`),
`reset_utterances`, `export_state` / `import_state` and the sampling
`temperature`, teacher-forced scoring: `score` / `score_device`, and
speculative exact decode: `run_speculative`.

  * The engine runs on the card: `device=None` means "cuda", and on a host
    without CUDA that raises (it never falls back to the CPU).  Tests pass
    `device="cpu"`, which runs the plain PyTorch loop.
  * Implementations: AUTO, SINGLE_BLOCK, DUAL_BLOCK and PERSISTENT all map
    to the persistent kernel (`ops/persistent.py`): K1 in modes "sample"
    and "argmax", K2 in mode "forced" (the selectors carry the symbols to
    emit), K3 in mode "prng" (selectors drawn on the card from Philox keyed
    on `sampling_seed` and the absolute clock).  K1 and K5 (the ragged
    feeds) are the staged kernel (`csrc/staged_generate.cu`): every weight
    copied by TMA into shared memory ahead of its use, the dilated prev
    half computed off the step's chain.  K2 and K3 run the same staged
    step (the same source, on K1's own stream, one copy of the weights for
    all of them).  AUTO stays on K1, whose plan
    (`persistent.staged_plan`) holds the flagship, config 4 and every
    geometry the tests run; the JAX engine's AUTO picks MANYBLOCK from a
    VMEM budget, which has no counterpart here (`vmem_budget` is not
    ported).  MANYBLOCK runs K4 in every mode of `run*`, lockstep `feed`
    and the dumps: K1's staged step on a stream that holds dil_w and rs_w
    in the storage's own bytes (`csrc/staged_generate.cu`).
    `persistent.generation_route` names the kernel before any launch: a
    geometry the staged plan cannot hold (A = 2048, R = 512, an odd R in
    bf16) runs the generic K1/K5 (`csrc/generic_generate.cu`), K2/K3 on
    the first K4 (`csrc/stream_generate.cu`; the generic kernel where its
    plan raises too) or, under MANYBLOCK, K4 on the first K4 (whose copy
    schedule `stream_group_size` and `stream_prefetch` set; they change no
    value and schedule nothing on the staged K4), with a note printed once
    at construction; a geometry neither K4 holds raises there.  Ragged or
    desynced feeds need K5 and raise under MANYBLOCK, as in the JAX
    engine.
  * Weight storage: `weight_dtype=torch.bfloat16` stores all nine
    parameters as bf16; `stream_quant="int8"` stores dil_w and rs_w as int8
    with per-column scales, and takes effect under MANYBLOCK only, as in
    the JAX engine.  Every path that does not read the stored form (the
    plain loop, K1/K2/K3/K5, the dil_b prefold and the scorer) computes
    with its fp32 values, `persistent.value_view`, so a score -> feed
    handoff stays exact under int8 too (the JAX engine's scorer keeps the
    fp32 stacks there: fault R9 of ROADMAP.md).
  * Precision, on every kernel and the plain path (`scan_generate.
    PRECISIONS`): `fast_math=True` rounds both operands of every product to
    bf16 (the TPU's single-pass DEFAULT precision; products and sums stay
    fp32, the exact math stays exact, x and the ring stay fp32);
    `compute_dtype=torch.bfloat16` does that and stores x rounded and the
    FIFO ring as bf16 (the snapshot's `ring` stays float32 numpy, which
    holds bf16 values exactly).  Both are governed by the TV contract, not
    bit-exact against fp32; within one precision K4 equals K1 and the bf16
    scorer equals K2 bit for bit on the card, and chunked, ragged, migrated
    and handed-over streams continue exactly.
  * The collapsed-chain latency tier: `fuse_chain=True` sends lockstep
    `run*` and `feed` dispatches to kernel K6 (`ops/fused_chain.py`, the
    residual stream folded into the weights once per weight upload or
    temperature), governed by the TV contract, not bit-exact.
    `priority="latency"` turns on fuse_chain and fast_math;
    `priority="exact"` or None leaves every knob as passed.  Dumps, ragged
    or desynced feeds (K5) and MANYBLOCK (K4) leave K6 for the kernels of
    K1's step in the engine's precision; a dump drops the fast_math that
    priority set.  A geometry K6 cannot run (`fused_chain.fused_plan`)
    sends every dispatch to those kernels too, with a note printed once,
    as the JAX engine does.
  * `score` / `score_device` run the time-parallel scorer
    (`ops/score_parallel.py`: kernels K7, K0a, K0c) over a window of given
    symbols and leave the state generation would leave.  It computes in
    compute_dtype and in fp32 under fast_math, as in the JAX engine, so a
    score -> feed handoff is exact on the fp32 and the bf16 tier.
  * `run_speculative` (`ops/speculative.py`) drafts windows with K6
    (fast_math, raw conditioning), verifies each with the scorer and
    commits the exact prefix, so its samples equal `run()`'s bit for bit
    on the deterministic tiers (fp32 and bf16 weights; int8 stacks under
    MANYBLOCK, verified with their values).  With `adaptive=True` a short
    probe and `spec_cost_model` (H100 measurements) pick the window,
    half of it, or `run()`'s own kernel (K1, K4 under MANYBLOCK) for the
    rest; `spec_branch` and `spec_rounds` say what ran.
  * Conditioning is uploaded to the device once, in `set_inputs`; the
    dil_b-prefolded copy `cond_pre = cond + dil_b` is built there lazily,
    once per (inputs, weights).
  * `chunk_size` is the most samples one `run` launch generates; longer
    runs are split into launches that carry the FIFO state, exactly as one
    launch would.  A feed is one launch whatever its length.
  * Streams keep one absolute clock per batch row (`_stream_t_row`), the
    one source of truth for FIFO phase and default selectors.  A feed whose
    rows share a clock and a length runs lockstep on K1 (K4 under
    MANYBLOCK, K6 under fuse_chain); per-row `lengths` or desynced clocks
    (after a ragged feed or `reset_utterances`) run on K5, and feeds return
    to the lockstep kernel once the clocks realign.
  * `mesh=` (`parallel/mesh.data_mesh`) shards the utterance batch over a
    'data' axis of devices, as the JAX engine's mesh does: the weights are
    uploaded once to each distinct device (with every per-upload cache:
    the storage's values, K1's staged stream, K4's stacks, K6's fold), each
    shard generates its own rows with its own launch on its own stream
    (`mesh.make_sharded_persistent_generator`), and nothing communicates.
    Planning (`staged_plan`, `cluster_plan`, `stream_plan`, the route) runs
    on the per-shard batch; `max_batch` and every batch must divide by the
    axis.  `run*`, lockstep `feed`, the dumps, `score`, `export_state` /
    `import_state` and `reset_utterances` work as without a mesh; ragged
    feeds and `run_speculative` raise, as in the JAX engine.  Under several
    processes (`mesh.initialize_multihost`) `set_inputs`, `feed` and
    `score` take this process's rows and return them, batch_size arguments
    stay global, default selectors are keyed on the process index, and a
    snapshot holds this process's rows.  Mode "prng" keys shard k on
    `mesh.shard_key(sampling_seed, k)`.  `reset_utterances` under a mesh
    keeps the rows' shared clock (the JAX engine's; a lockstep kernel
    shares one clock, and ragged feeds raise there).
"""

from __future__ import annotations

import enum
import operator
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import (fused_chain, persistent,
                                      scan_generate, score_parallel,
                                      speculative)
from nv_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nv_wavenet_tpu_torch.utils import tracing


# what a fallback route runs (`persistent.generation_route`)
_ROUTE_NOTES = {"generic": "K1/K5 run the generic kernel "
                           "(csrc/generic_generate.cu), K2/K3 the first K4 "
                           "(csrc/stream_generate.cu)",
                "wide": "K1 runs card-wide (csrc/wide_generate.cu), K5 and "
                        "the dumps the generic kernel, K2/K3 the first K4",
                "stream": "MANYBLOCK runs the first K4 "
                          "(csrc/stream_generate.cu)"}


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


def _check_temperature(temperature) -> float:
    t = float(temperature)
    if not (t > 0 and np.isfinite(t)):
        raise ValueError(f"temperature must be finite and > 0, got "
                         f"{temperature}")
    return t


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
                 weight_dtype=torch.float32,
                 stream_group_size: int = 8,
                 stream_prefetch: bool = False,
                 stream_quant: Optional[str] = None,
                 temperature: float = 1.0,
                 fast_math: bool = False,
                 fuse_chain: bool = False,
                 fuse_pack: bool = False,
                 priority: Optional[str] = None,
                 compute_dtype=torch.float32,
                 device=None,
                 mesh=None):
        """`fuse_chain`: lockstep generation on the collapsed-chain kernel
        K6; `fuse_pack`: its gate blocks at R rows instead of 128
        (`fused_chain._row_stride`; the same values); `fast_math`: bf16
        operands in every product; `compute_dtype`: torch.float32 or
        torch.bfloat16 (bf16 operands, x stored rounded, a bf16 ring);
        `priority`: None or "exact" (every knob as passed) or "latency"
        (fuse_chain and fast_math, the latter dropped on dumps).  A
        geometry K6 cannot run leaves fuse_chain to the other kernels, with
        a note printed once.  `mesh`: a `parallel/mesh.DataMesh` to shard
        the batch over (see the module docstring); the engine's device is
        then the mesh's first, where results are gathered."""
        if priority not in (None, "exact", "latency"):
            raise ValueError(f"unknown priority {priority!r}: expected None, "
                             f"'exact' or 'latency'")
        scan_generate.precision(compute_dtype)   # raises for another dtype
        self.compute_dtype = compute_dtype
        self.priority = priority
        # fast_math that priority turned on (a dump drops it); an explicit
        # fast_math is the caller's and stays
        self._fast_math_from_priority = priority == "latency" and not fast_math
        if priority == "latency":
            fuse_chain = fast_math = True
        self.fast_math = bool(fast_math)
        self.fuse_chain = bool(fuse_chain)
        self.fuse_pack = bool(fuse_pack)
        if stream_quant not in (None, "int8"):
            raise ValueError(f"stream_quant must be None or 'int8', got "
                             f"{stream_quant!r}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        # sampling temperature: softmax(za / T) as a weight transform, end_w
        # and end_b scaled by float32(1/T) at upload, so every path samples
        # from the tempered logits with no per-step cost; T=1 is a no-op
        self.temperature = _check_temperature(temperature)
        # batch sharding over a 'data' mesh: weights replicated, rows split
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape["data"]
            if max_batch % n:
                raise ValueError(f"max_batch {max_batch} not divisible by "
                                 f"data axis {n}")
            if device is None:
                device = mesh.devices[0]
            elif torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
        self.device = resolve_device(device)
        self.cfg = WaveNetConfig(num_layers=num_layers, R=R, S=S, A=A,
                                 max_dilation=max_dilation,
                                 tanh_embed=tanh_embed)
        self.max_batch = max_batch
        self.implementation = implementation
        self.chunk_size = chunk_size
        self.sampling_seed = 0
        # weight storage and K4's copy schedule (ops/persistent.py); int8
        # applies to the streamed stacks, so only under MANYBLOCK
        self.weight_dtype = weight_dtype
        self.stream_group_size = stream_group_size
        self.stream_prefetch = bool(stream_prefetch)
        self.stream_quant = stream_quant
        self._stream = implementation == Impl.MANYBLOCK
        self._quant = stream_quant == "int8" and self._stream
        persistent.check_storage(weight_dtype, stream_quant == "int8")
        # the kernels of K1's step this geometry runs, named before any
        # launch (`persistent.generation_route`): where the staged plan
        # cannot hold it, K1/K5 run the generic kernel and K4 the first K4,
        # with a note printed once; a geometry neither K4 holds raises here
        for prec in sorted({self._precision(False), self._precision(True)}):
            route = persistent.generation_route(
                self.cfg, self._per_device(max_batch), prec,
                stream_weights=self._stream,
                storage=persistent.stream_storage(weight_dtype, self._quant,
                                                  prec),
                stream_group_size=stream_group_size)
            if route.note is not None:
                print(f"note: {_ROUTE_NOTES[route.kernel]} in precision "
                      f"{prec!r} ({route.note})", flush=True)
        # a geometry K6 cannot run sends fuse_chain's dispatches to the
        # other kernels, fast_math intact (the JAX engine's VMEM fallback)
        self._fuse_fits = self.fuse_chain
        if self.fuse_chain:
            try:
                fused_chain.fused_plan(self.cfg, self.fuse_pack)
            except ValueError as err:
                self._fuse_fits = False
                print(f"note: fuse_chain disabled ({err}); using the exact "
                      f"kernels' step", flush=True)
        L = num_layers
        # canonical params assembled incrementally by the setters (host)
        self._np_params: Dict[str, np.ndarray] = {
            k: np.zeros(s, np.float32)
            for k, s in params_lib.canonical_shapes(L, R, S, A).items()}
        # per device: the params, their storage's values, K6's folded weights
        self._params: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._values: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._fused_prep: Dict[torch.device, tuple] = {}
        self._spec_prep: Optional[tuple] = None    # the draft's fold
        # speculative decode: the adaptive tier's cost model (V0_us, V1_us,
        # E0_us), and what the last run_speculative did
        self.spec_cost_model = speculative.DEFAULT_COST
        self.spec_rounds: Optional[int] = None
        self.spec_branch: Optional[int] = None
        # the inputs and the state: tensors, or under a mesh lists of one
        # tensor a local shard (`mesh.stage`)
        self._cond = None
        self._cond_pre = None
        # a stale cond_pre whose storage the next fold reuses (one device)
        self._cond_pre_spare = None
        self._selectors = None
        self._ring = None
        self._y_state = None
        self._dumps: Optional[Dict[str, torch.Tensor]] = None
        # generators by (batch, mode, dump, ragged): each holds its FIFO
        # layout on the card, so a feed uploads nothing but its inputs;
        # scorers by batch
        self._gens: Dict[tuple, Callable] = {}
        self._scorers: Dict[int, Callable] = {}
        # the generators' weight storage on the card, shared by what it
        # holds: K1/K5 and the staged K2/K3 read one stream; under a mesh
        # one such dict a device
        self._stored: Dict[tuple, dict] = {}
        self._mesh_stored: Dict[torch.device, dict] = {}
        # per-row absolute clocks of the open stream [batch] (None: no
        # stream), and the count of feeds, which names each in a trace
        self._stream_t_row: Optional[np.ndarray] = None
        self._feeds = 0

    # ------------------------------------------------------------------
    # weight upload (reference setter parity)
    # ------------------------------------------------------------------

    def _invalidate(self):
        self._stored.clear()
        self._mesh_stored.clear()
        self._params = {}
        self._values = {}
        self._fused_prep = {}
        self._spec_prep = None
        self._drop_prefold()

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

    def _tempered_params(self) -> Dict[str, np.ndarray]:
        """The host params with end_w and end_b scaled by float32(1/T):
        softmax(zs end_w/T + end_b/T) = softmax(za / T)."""
        if self.temperature == 1.0:
            return self._np_params
        inv_t = np.float32(1.0 / self.temperature)
        return {**self._np_params,
                "end_w": self._np_params["end_w"] * inv_t,
                "end_b": self._np_params["end_b"] * inv_t}

    def set_temperature(self, temperature: float):
        """Change the sampling temperature from the next generation on.
        Only end_w and end_b change, so only they re-upload."""
        temperature = _check_temperature(temperature)
        if temperature == self.temperature:
            return
        self.temperature = temperature
        self._values = {}
        self._fused_prep = {}
        self._spec_prep = None
        tempered = self._tempered_params()
        for dev, params in self._params.items():
            for k in ("end_w", "end_b"):
                params[k] = torch.as_tensor(tempered[k],
                                            device=dev).contiguous()

    def _device_params(self, dev=None) -> Dict[str, torch.Tensor]:
        """The canonical fp32 (tempered) params on `dev` (default: the
        engine's device), uploaded once per device: what the generators
        take, each applying its storage itself."""
        dev = self.device if dev is None else dev
        if dev not in self._params:
            self._params[dev] = params_lib.canonical_to_torch(
                self._tempered_params(), dev)
        return self._params[dev]

    def _value_params(self, dev=None) -> Dict[str, torch.Tensor]:
        """The fp32 values of the weight storage on `dev`
        (`persistent.value_view`, temperature applied first): what the
        prefold and the scorer use."""
        dev = self.device if dev is None else dev
        if dev not in self._values:
            self._values[dev] = persistent.value_view(
                self._device_params(dev), self.weight_dtype, self._quant)
        return self._values[dev]

    def _fused_weights(self, dev=None) -> tuple:
        """K6's folded weights on `dev` (`fused_chain.prepare_weights` with
        the dil_b prefold, the engine's storage, fuse_pack, fast_math and
        compute_dtype), made once per weight upload or temperature and
        device: the O(L^2) fold stays off every chunked or streaming
        dispatch."""
        dev = self.device if dev is None else dev
        if dev not in self._fused_prep:
            self._fused_prep[dev] = fused_chain.prepare_weights(
                self._device_params(dev), self.cfg, True, self.weight_dtype,
                self.fuse_pack, self.fast_math, self.compute_dtype)
        return self._fused_prep[dev]

    # ------------------------------------------------------------------
    # the mesh (the JAX engine's _n_proc / _shard / _check_mesh_batch /
    # _per_device)
    # ------------------------------------------------------------------

    def _n_proc(self) -> int:
        """Processes holding the mesh's rows: under several, callers pass
        and read back this process's rows, and batch_size arguments stay
        global."""
        return self.mesh.process_count if self.mesh is not None else 1

    def _pidx(self) -> int:
        """This process's index on the mesh (keys the default selectors)."""
        return self.mesh.process_index if self.mesh is not None else 0

    def _shard(self, x, batch_axis: int, dtype=torch.float32) -> list:
        """This process's rows of x split over the mesh's local shards."""
        return mesh_lib.stage(self.mesh, x, batch_axis, dtype)

    def _check_mesh_batch(self, batch: int):
        """Fail early, with the JAX engine's message, when the batch cannot
        shard evenly."""
        if self.mesh is not None:
            n = self.mesh.shape["data"]
            if batch % n:
                raise ValueError(
                    f"batch_size {batch} not divisible by the mesh 'data' "
                    f"axis ({n} devices); pad the utterance batch to a "
                    f"multiple of {n}")

    def _per_device(self, batch: int) -> int:
        """The rows of one shard: every plan is made for them."""
        return batch // self.mesh.shape["data"] if self.mesh else batch

    def _on_devices(self, fn) -> Dict[torch.device, object]:
        """{device: fn(device)} over the mesh's distinct devices, made on
        each device's current stream before any shard launches."""
        return {d: fn(d) for d in self.mesh.local_devices}

    def _state_batch(self) -> int:
        """The global batch of the carried state."""
        if self.mesh is None:
            return self._y_state.shape[1]
        return sum(y.shape[1] for y in self._y_state) * self._n_proc()

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def set_inputs(self, cond, selectors=None, seed: Optional[int] = None):
        """cond: [T, L, B, 2R] conditioning; selectors: [T, B] uniforms in
        [0, 1).  numpy arrays or tensors (a tensor already on the engine's
        device is used as it is).  With selectors=None they come from the
        default stream `_selector_stream` keyed on `seed` (default: the
        engine's `sampling_seed`).  Resets the generation state.

        Under a mesh of several processes cond and selectors are this
        process's rows (B_local = B / process count), later batch_size
        arguments are global, and default selectors are keyed on the
        process index (`_selector_stream(..., pidx)`, the local row index
        with the process's)."""
        T, L, Bl, C = cond.shape
        if L != self.cfg.num_layers or C != 2 * self.cfg.R:
            raise ValueError(f"cond shape {tuple(cond.shape)} does not match "
                             f"config (L={self.cfg.num_layers}, "
                             f"2R={2 * self.cfg.R})")
        B = Bl * self._n_proc()             # the global utterance batch
        if B > self.max_batch:
            raise ValueError(f"batch {B} exceeds max_batch {self.max_batch}")
        self._check_mesh_batch(B)
        if selectors is None:
            selectors = _selector_stream(
                self.sampling_seed if seed is None else seed, 0, T, Bl,
                self._pidx())
        if tuple(selectors.shape) != (T, Bl):
            raise ValueError(f"selectors shape {tuple(selectors.shape)} != "
                             f"{(T, Bl)}")
        if self.mesh is not None:
            self._cond = self._shard(cond, 2)
            self._selectors = self._shard(selectors, 1)
        else:
            self._cond = torch.as_tensor(cond, dtype=torch.float32,
                                         device=self.device).contiguous()
            self._selectors = torch.as_tensor(
                selectors, dtype=torch.float32,
                device=self.device).contiguous()
        self._drop_prefold()
        self._reset_state(B)

    def _inputs_shape(self) -> tuple:
        """(T, the global batch) of the inputs of `set_inputs`."""
        if self.mesh is None:
            return self._cond.shape[0], self._cond.shape[2]
        return (self._cond[0].shape[0],
                sum(c.shape[2] for c in self._cond) * self._n_proc())

    @property
    def _ring_dtype(self) -> torch.dtype:
        """The FIFO ring's dtype: bf16 under compute_dtype=bfloat16."""
        return scan_generate.ring_dtype(self._precision(False))

    def _reset_state(self, batch: int):
        """Silence for `batch` rows (global; each shard gets its own under a
        mesh); an open stream ends (its clocks described the state this
        replaces)."""
        def fresh(dev, b):
            return (persistent.init_ring(self.cfg, b, dev, self._ring_dtype),
                    torch.full((2, b), self.cfg.silence_bin,
                               dtype=torch.int32, device=dev))
        if self.mesh is None:
            self._ring, self._y_state = fresh(self.device, batch)
        else:
            b = self._per_device(batch)
            states = mesh_lib.run_shards(
                self.mesh, lambda shard: fresh(shard.device, b))
            self._ring = [r for r, _ in states]
            self._y_state = [y for _, y in states]
        self._stream_t_row = None

    def _drop_prefold(self):
        """Mark cond + dil_b stale.  On one device its storage is kept for
        the next fold: a buffer of the inputs' size (32 GB at the wide
        vocoder's 16 x 16,384 samples) freed and allocated anew may not find
        room again once smaller tensors have split its freed block."""
        if self._cond_pre is not None and self.mesh is None:
            self._cond_pre_spare = self._cond_pre
        self._cond_pre = None

    def _prefolded_cond(self):
        """cond + dil_b, built once per (inputs, weights) on the device (on
        each shard's under a mesh), into the stale one's storage where the
        shapes agree: an exactly-rounded elementwise add, the same values
        the JAX engine prefolds."""
        if self._cond_pre is None:
            spare, self._cond_pre_spare = self._cond_pre_spare, None
            if spare is not None and spare.shape != self._cond.shape:
                spare = None
            self._cond_pre = self._fold_dil_b(self._cond, spare)
        return self._cond_pre

    def _fold_dil_b(self, cond, out=None):
        """cond + dil_b of the storage's values, on cond's device(s) (into
        `out` when given, one device)."""
        if self.mesh is None:
            dil_b = self._value_params()["dil_b"]
            if out is not None:
                return torch.add(cond, dil_b[None, :, None, :], out=out)
            return cond + dil_b[None, :, None, :]
        dil_b = self._on_devices(lambda d: self._value_params(d)["dil_b"])
        return mesh_lib.run_shards(
            self.mesh, lambda shard, c: c + dil_b[shard.device][
                None, :, None, :], cond)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def run(self, num_samples: int, batch_size: int, mode: str = "sample",
            dump_activations: bool = False) -> np.ndarray:
        """Generate `num_samples` for `batch_size` utterances.
        Returns y: [batch, num_samples] int32 mu-law bins.  Modes: "sample"
        (the selectors of `set_inputs`), "argmax", "forced" (the selectors
        hold the symbols to emit) and "prng" (selectors drawn on the card,
        keyed on `sampling_seed` and the absolute sample index, so chunking
        does not change them)."""
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
        T_in, B_in = self._inputs_shape()
        if B > B_in or (self.mesh is not None and B != B_in):
            raise ValueError(f"batch_size {B} "
                             f"{'differs from' if self.mesh else 'exceeds'}"
                             f" the batch of set_inputs ({B_in})")
        if init_sample + num_samples > T_in:
            raise ValueError("set_inputs cond is shorter than requested run")
        if init_sample == 0:
            self._reset_state(B)
        elif self._state_batch() != B:
            raise ValueError(f"batch_size {B} differs from the carried "
                             f"state's batch {self._state_batch()}")
        gen, params = self._generator(B, mode, dump_activations)
        cond_pre = self._prefolded_cond()
        ys = []
        for t0 in range(init_sample, init_sample + num_samples,
                        self.chunk_size):
            n = min(self.chunk_size, init_sample + num_samples - t0)
            sl = slice(t0, t0 + n)
            if self.mesh is not None:
                cp = [c[sl] for c in cond_pre]
                sel = [s[sl] for s in self._selectors]
            else:
                cp = cond_pre[sl] if B == cond_pre.shape[2] \
                    else cond_pre[sl, :, :B].contiguous()
                sel = self._selectors[sl, :B].contiguous()
            out = gen(params, t0, cp, sel, self._ring, self._y_state,
                      seed=self.sampling_seed)
            ys.append(out[0])
            if dump_activations:
                self._dumps = dict(zip(("xt", "skip", "zs", "za", "p"),
                                       out[3:8]))
        if not ys:
            return torch.zeros((0, B // self._n_proc()), dtype=torch.int32,
                               device=self.device)
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

    def _effective_fast_math(self, dump: bool) -> bool:
        """fast_math for this dispatch: a dump drops the fast_math that
        priority="latency" turned on, so the getters read the exact kernel;
        an explicit fast_math stays."""
        return self.fast_math and not (dump and self._fast_math_from_priority)

    def _precision(self, dump: bool) -> str:
        """The precision of a dispatch (`scan_generate.PRECISIONS`)."""
        return scan_generate.precision(self.compute_dtype,
                                       self._effective_fast_math(dump))

    def _generator(self, batch: int, mode: str, dump: bool = False,
                   ragged: bool = False):
        """(generator, the weights it takes) for this dispatch: K6 and its
        folded weights under fuse_chain for a lockstep run or feed that is
        no dump and not MANYBLOCK, on a geometry K6 runs; else the kernels
        of K1's step (K1/K2/K3, K5 when ragged, K4 under MANYBLOCK) and the
        canonical params.  Either in the dispatch's precision."""
        fused = self._fuse_fits and not (dump or ragged or self._stream)
        fast = self._effective_fast_math(dump)
        key = (batch, mode, dump, ragged, self._precision(dump))
        if self.mesh is not None:
            if key not in self._gens:
                self._gens[key] = mesh_lib.make_sharded_persistent_generator(
                    self.cfg, self.mesh, self._per_device(batch), mode=mode,
                    weight_dtype=self.weight_dtype,
                    compute_dtype=self.compute_dtype, fast_math=fast,
                    dump=dump, stream_weights=self._stream,
                    stream_group_size=self.stream_group_size,
                    stream_prefetch=self.stream_prefetch,
                    stream_quant=self._quant, fuse_chain=fused,
                    fuse_pack=self.fuse_pack, shared=self._mesh_stored)
            return self._gens[key], self._on_devices(
                self._fused_weights if fused else self._device_params)
        if key not in self._gens:
            self._gens[key] = (
                fused_chain.make_fused_generator(
                    self.cfg, batch, mode=mode,
                    weight_dtype=self.weight_dtype, fast_math=fast,
                    prefold_cond=True, pack_gates=self.fuse_pack,
                    compute_dtype=self.compute_dtype)
                if fused else persistent.make_persistent_generator(
                    self.cfg, batch, mode=mode, dump=dump,
                    weight_dtype=self.weight_dtype,
                    stream_weights=self._stream,
                    stream_group_size=self.stream_group_size,
                    stream_prefetch=self.stream_prefetch,
                    stream_quant=self._quant, ragged=ragged,
                    compute_dtype=self.compute_dtype, fast_math=fast,
                    shared=self._stored))
        return (self._gens[key],
                self._fused_weights() if fused else self._device_params())

    # ------------------------------------------------------------------
    # speculative exact decode
    # ------------------------------------------------------------------

    def run_speculative(self, num_samples: int, batch_size: int,
                        window: int = 256, adaptive: bool = True
                        ) -> np.ndarray:
        """Sample by speculative exact decode (`ops/speculative.py`): draft
        `window` steps on K6 (fast_math), verify them in one pass of the
        exact scorer, commit the agreeing prefix and the exact correction.
        Returns y [batch, num_samples] int32, equal to `run(num_samples,
        batch_size)` (mode "sample", the selectors of `set_inputs`) bit for
        bit: the draft changes only the speed.

        Defined for the deterministic tiers (fp32 weights, bf16 weights,
        int8 stacks under MANYBLOCK); raises ValueError for fast_math,
        fuse_chain, priority="latency" and compute_dtype=bfloat16 engines,
        whose `run()` is governed by the TV contract, for a geometry K6
        cannot run (`fused_chain.fused_plan`), before `set_inputs` and for
        a request longer than it holds.

        adaptive=True: a probe of 4 * min(64, window) steps measures the
        committed run length and `spec_cost_model` (V0_us, V1_us, E0_us; a
        round ~V0 + V1 window, an exact step E0) picks the rest's branch:
        0 window, 1 window / 2, 2 `run()`'s kernel; -1 when the request is
        too short to probe.  `spec_branch` holds it afterwards (None after
        adaptive=False) and `spec_rounds` the draft-verify rounds.  The
        default cost model is measured on an H100 at the flagship, b=1
        (`speculative.DEFAULT_COST`), where the exact kernel wins.  The
        whole batch commits at the first disagreement of any row, so batch
        1 is where drafting can pay."""
        y, self.spec_rounds = self._run_speculative_device(
            num_samples, batch_size, window, adaptive)
        return y.T.cpu().numpy()

    def _run_speculative_device(self, num_samples: int, batch_size: int,
                                window: int = 256, adaptive: bool = False):
        """`run_speculative` without the read-back: (device y [T, B],
        rounds)."""
        if self._cond is None:
            raise ValueError("set_inputs must be called first")
        if self.mesh is not None:
            raise ValueError(
                "speculative decode: single-process engines only (its "
                "lockstep commit is a per-batch scalar loop; at multi-chip "
                "batch the exact kernel wins anyway)")
        if (self.fast_math or self.fuse_chain
                or self.compute_dtype != torch.float32):
            raise ValueError(
                "run_speculative requires a deterministic engine decode path "
                "(no fast_math / fuse_chain / priority='latency' / bf16 "
                "compute): its output bit-matches run(), which is defined "
                "only for the exact and the bf16-weights tiers")
        fused_chain.fused_plan(self.cfg)   # the draft is K6: raises here
        B = batch_size
        if B > self._cond.shape[2]:
            raise ValueError(f"batch_size {B} exceeds the batch of "
                             f"set_inputs ({self._cond.shape[2]})")
        if num_samples > self._cond.shape[0]:
            raise ValueError(f"set_inputs holds {self._cond.shape[0]} steps "
                             f"of conditioning; cannot generate "
                             f"{num_samples}")
        self._reset_state(B)
        key = ("spec", B, window, adaptive,
               tuple(self.spec_cost_model) if adaptive else None)
        if key not in self._gens:
            # the exact branch is run()'s own dispatch (K1, K4 under
            # MANYBLOCK) on the engine's ring and y_state, which the
            # speculative generator hands back after the probe
            self._gens[key] = (
                speculative.make_adaptive_generator(
                    self.cfg, B, window,
                    lambda t0, cond, sel, ring, ys: self._run_partial_device(
                        t0, cond.shape[0], B, "sample", False),
                    cost=self.spec_cost_model)
                if adaptive else
                speculative.make_speculative_generator(self.cfg, B, window))
        if self._spec_prep is None:
            # the draft's fold of the stored weights' values, raw cond
            self._spec_prep = fused_chain.prepare_weights(
                self._value_params(), self.cfg, False, fast_math=True)
        cond = self._cond[:num_samples, :, :B]
        sel = self._selectors[:num_samples, :B]
        out = self._gens[key](self._value_params(), self._spec_prep, 0,
                              cond, sel, self._ring, self._y_state)
        self.spec_branch = out[4] if adaptive else None
        return out[0], out[3]

    # ------------------------------------------------------------------
    # streaming serving surface
    # ------------------------------------------------------------------

    def begin_stream(self, batch_size: int):
        """Start incremental generation: conditioning arrives chunk by chunk
        through `feed`, as a TTS frontend produces it, instead of all at
        once through `set_inputs`.  The state resets to silence and every
        row's clock to 0."""
        if not 1 <= batch_size <= self.max_batch:
            raise ValueError(f"batch_size {batch_size} outside [1, "
                             f"max_batch={self.max_batch}]")
        self._check_mesh_batch(batch_size)
        self._reset_state(batch_size)
        # this process's rows' clocks (all of them with one process)
        self._stream_t_row = np.zeros(batch_size // self._n_proc(), np.int64)

    @property
    def _stream_t(self) -> Optional[int]:
        """The largest row clock, for the surfaces that know one stream
        position (the snapshot's `stream_t`); None when no stream is open."""
        if self._stream_t_row is None:
            return None
        return int(self._stream_t_row.max())

    def feed(self, cond_chunk, selectors_chunk=None, mode: str = "sample",
             lengths=None) -> np.ndarray:
        """Generate the next len(cond_chunk) samples of the stream; returns
        y [batch, n] int32.  Chunk lengths may vary from call to call: the
        carried state makes any chunking equal one run over the concatenated
        conditioning.  Default selectors come from the stream of
        `_selector_stream` keyed on each row's ABSOLUTE clock, so they do
        not depend on the chunking and equal those of `set_inputs(cond)` +
        `run()` over the same window.

        `lengths` [batch] gives each row its own number of valid steps this
        call (0 allowed): row b consumes cond_chunk[:lengths[b], :, b],
        advances its own clock, and its samples y[b, :lengths[b]] equal
        those of the row generated alone; the rest of its row is 0.  Such
        ragged feeds run mode "sample" only.  Lockstep feeds take every
        mode of `run`; mode "prng" draws from the row clock, so its samples
        do not depend on the chunking either."""
        return self.feed_device(cond_chunk, selectors_chunk, mode,
                                lengths).T.cpu().numpy()

    def feed_device(self, cond_chunk, selectors_chunk=None,
                    mode: str = "sample", lengths=None) -> torch.Tensor:
        """`feed` without the read-back: returns the device y [n, batch].
        `cond_chunk` [n, L, batch, 2R] may already be on the card; a host
        array is staged through pinned memory.  Per feed, on the card: one
        dil_b prefold and one kernel launch (K1 lockstep, K4 under
        MANYBLOCK, K6 under fuse_chain, K5 ragged), with no host
        synchronisation before the launch; a ragged feed's row clocks and
        lengths go in K5's launch parameters, and K5 writes y's steps past
        each row's length itself, so no copy or fill comes before it."""
        if self._stream_t_row is None:
            raise RuntimeError("call begin_stream(batch_size) first")
        self._feeds += 1
        with tracing.span("feed_device", self._feeds):
            return self._feed(cond_chunk, selectors_chunk, mode, lengths)

    def _feed(self, cond_chunk, selectors_chunk, mode: str,
              lengths) -> torch.Tensor:
        B = len(self._stream_t_row)        # this process's rows
        T = cond_chunk.shape[0]
        if tuple(cond_chunk.shape[1:]) != (self.cfg.num_layers, B,
                                           2 * self.cfg.R):
            raise ValueError(f"cond_chunk shape {tuple(cond_chunk.shape)} "
                             f"does not match (n, L={self.cfg.num_layers}, "
                             f"batch={B}, 2R={2 * self.cfg.R})")
        if T == 0:
            return torch.zeros((0, B), dtype=torch.int32, device=self.device)
        clocks = self._stream_t_row
        aligned = bool(np.all(clocks == clocks[0]))
        if lengths is not None or not aligned:
            la = (np.full(B, T, np.int64) if lengths is None
                  else np.asarray(lengths))
            if not (aligned and la.shape == (B,) and np.all(la == T)):
                return self._feed_ragged(cond_chunk, selectors_chunk, mode, la)
        t0 = int(clocks[0])
        with tracing.span("feed.stage"):
            if selectors_chunk is None:
                selectors_chunk = (
                    _selector_stream(self.sampling_seed, t0, T, B,
                                     self._pidx())
                    if mode == "sample" else np.zeros((T, B), np.float32))
            cond, sel = (self._stage(cond_chunk, 2),
                         self._stage(selectors_chunk, 1))
        with tracing.span("feed.prefold"):
            cond = self._fold_dil_b(cond)
        with tracing.span("feed.launch"):
            gen, params = self._generator(B * self._n_proc(), mode)
            y = gen(params, t0, cond, sel, self._ring, self._y_state,
                    seed=self.sampling_seed)[0]
        self._stream_t_row = clocks + T
        return y

    def _feed_ragged(self, cond, sel, mode: str,
                     lengths: np.ndarray) -> torch.Tensor:
        """Per-row ragged feed on K5: row b runs lengths[b] steps from its
        own clock (the TPU kernel's ragged variant, which the JAX engine
        wraps in per-row ring rotations; K5 takes the clocks directly)."""
        if self.mesh is not None:
            raise ValueError(
                "ragged feeds: single-process engines only (shard desynced "
                "streams across engine instances; in-batch rows shard on "
                "one chip)")
        if mode != "sample":
            raise ValueError("ragged feeds (per-row lengths or desynced row "
                             "clocks) run mode='sample' only")
        if self._stream:
            raise ValueError("ragged feeds (per-row lengths or desynced row "
                             "clocks) run on K5, with the weights read in "
                             "place; this engine streams them (MANYBLOCK)")
        B, T = len(self._stream_t_row), cond.shape[0]
        if not (lengths.shape == (B,)
                and np.issubdtype(lengths.dtype, np.integer)
                and lengths.min() >= 0 and lengths.max() <= T):
            raise ValueError(f"ragged feed lengths {lengths.tolist()} must "
                             f"be [batch={B}] integers with 0 <= n <= cond "
                             f"length {T}")
        if lengths.max() == 0:
            return torch.zeros((0, B), dtype=torch.int32, device=self.device)
        clocks = self._stream_t_row
        with tracing.span("feed.stage"):
            if sel is None:
                sel = _selector_stream(self.sampling_seed, clocks, T, B)
            cond, sel = self._stage(cond, 2), self._stage(sel, 1)
        with tracing.span("feed.prefold"):
            cond = self._fold_dil_b(cond)
        with tracing.span("feed.launch"):
            gen, params = self._generator(B, "sample", ragged=True)
            y = gen(params, torch.from_numpy(clocks.copy()), cond, sel,
                    self._ring, self._y_state,
                    torch.from_numpy(lengths.astype(np.int32)))[0]
        self._stream_t_row = clocks + lengths
        return y

    def score_device(self, cond_chunk, y_chunk) -> torch.Tensor:
        """Teacher-forced scoring of a KNOWN window, continuing the stream:
        returns the device per-step distributions p_seq [T, B, A] and
        advances the state (ring, y_state, every row clock by T) exactly as
        if the engine had generated y_chunk [T, B], so scoring and
        generation interleave freely (a score -> feed handoff is exact).
        Computed by the time-parallel scorer (`ops/score_parallel.py`),
        whose p, ring and y_state equal the forced kernel K2's bit for bit
        on the card.  Under a temperature p is the tempered distribution,
        as `feed` samples it.  Needs `begin_stream` and rows at one clock
        (the scorer shares one clock across the batch).  Under a mesh each
        shard scores its own rows (the scorer is batch-parallel) and p_seq
        holds this process's rows."""
        if self._stream_t_row is None:
            raise RuntimeError("call begin_stream(batch_size) first")
        clocks = self._stream_t_row
        if not np.all(clocks == clocks[0]):
            raise ValueError(f"score_device: the row clocks {clocks.tolist()}"
                             f" differ (ragged feeds or slot handover); the "
                             f"scorer shares one clock across the batch")
        B = len(clocks)
        T = cond_chunk.shape[0]
        if tuple(cond_chunk.shape[1:]) != (self.cfg.num_layers, B,
                                           2 * self.cfg.R):
            raise ValueError(f"score_device: cond_chunk shape "
                             f"{tuple(cond_chunk.shape)} does not match (n, "
                             f"L={self.cfg.num_layers}, batch={B}, "
                             f"2R={2 * self.cfg.R})")
        if tuple(y_chunk.shape) != (T, B):
            raise ValueError(f"score_device: y_chunk shape "
                             f"{tuple(y_chunk.shape)} != {(T, B)}")
        b = self._per_device(B * self._n_proc())
        if b not in self._scorers:
            self._scorers[b] = score_parallel.make_parallel_scorer(
                self.cfg, b, compute_dtype=self.compute_dtype,
                prefold_cond=True)
        scorer, t0 = self._scorers[b], int(clocks[0])
        if self.mesh is None:
            y = torch.as_tensor(y_chunk, device=self.device).to(torch.int32)
            p_seq = scorer(self._value_params(), t0,
                           self._stage_cond_pre(cond_chunk), y, self._ring,
                           self._y_state)[0]
        else:
            vals = self._on_devices(self._value_params)
            p_seq = mesh_lib.gather(mesh_lib.run_shards(
                self.mesh, lambda shard, c, y, r, ys: scorer(
                    vals[shard.device], t0, c, y, r, ys)[0],
                self._stage_cond_pre(cond_chunk),
                self._shard(y_chunk, 1, torch.int32), self._ring,
                self._y_state), 1)
        self._stream_t_row = clocks + T
        return p_seq

    def score(self, cond_chunk, y_chunk) -> np.ndarray:
        """`score_device` with the read-back and batch-major symbols:
        y_chunk [B, T] int -> p_seq [B, T, A] numpy."""
        y = torch.as_tensor(y_chunk).T
        return self.score_device(cond_chunk, y).permute(1, 0, 2).cpu().numpy()

    def _stage(self, x, batch_axis: int):
        """A float32 chunk on the engine's device (under a mesh, its rows
        split on `batch_axis` over the shards' devices, `mesh.stage`).  A
        host array goes through pinned memory with a non-blocking copy, so
        staging a feed never waits for the card."""
        if self.mesh is not None:
            return self._shard(x, batch_axis)
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(self.device, torch.float32).contiguous()
        host = torch.as_tensor(x, dtype=torch.float32).contiguous()
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _stage_cond_pre(self, cond):
        """cond + dil_b on the device(s), the values `_prefolded_cond`
        gives."""
        return self._fold_dil_b(self._stage(cond, 2))

    def reset_utterances(self, rows):
        """Hand the slots `rows` to new utterances while the other rows go
        on generating (continuous batching).  Each row's FIFOs are zeroed,
        its y_state set to silence and its clock to 0: a fresh engine's
        start, so with injected selectors its next samples equal those of
        the utterance generated alone.  Default selectors are keyed on the
        row's clock, so a reset row draws the clock-0 stream of its row.

        Under a mesh `rows` are global batch indices (each process resets
        those it holds, so every process makes the same call) and the rows
        keep the batch's shared clock, as in the JAX engine: the lockstep
        kernel shares one clock and ragged feeds raise under a mesh, so a
        reset row draws the default selectors of the shared clock."""
        if self._ring is None:
            raise RuntimeError("no generation state yet")
        n = self._state_batch()
        rows = [operator.index(r) for r in rows]
        if not rows or not all(0 <= r < n for r in rows):
            raise ValueError(f"rows {rows} out of range for batch {n}")
        if self.mesh is not None:
            b = self._per_device(n)

            def reset(shard, ring, y_state):
                for r in rows:
                    if shard.index * b <= r < (shard.index + 1) * b:
                        ring[:, r - shard.index * b].zero_()
                        y_state[:, r - shard.index * b].fill_(
                            self.cfg.silence_bin)
            mesh_lib.run_shards(self.mesh, reset, self._ring, self._y_state)
            return
        for r in rows:
            self._ring[:, r].zero_()
            self._y_state[:, r].fill_(self.cfg.silence_bin)
        if self._stream_t_row is not None:
            self._stream_t_row[rows] = 0

    def export_state(self) -> Dict[str, np.ndarray]:
        """Snapshot the generation state as host numpy, for session
        migration and recovery: `ring` [ring_size, B, R] float32 in the
        port's plain layout (each row's FIFO slots at its absolute phase; a
        bf16 ring's values, exactly), `y_state`
        [2, B], `stream_t_row` [B] int64 (each row's clock), `stream_t` (the
        largest clock, -1 when no stream is open) and `stream_batch`.  The
        JAX package's snapshot holds a lane-packed ring and its scan path's
        state, and no per-row clocks.  Under a mesh it holds this process's
        rows in order (with one process, the whole batch, in the layout
        of an engine without a mesh)."""
        if self._ring is None:
            raise RuntimeError("no generation state yet")
        if self.mesh is None:
            ring = np.array(self._ring.to(torch.float32).cpu())
            y_state = np.array(self._y_state.cpu())
        else:
            ring = mesh_lib.fetch_local(
                self.mesh, [r.to(torch.float32) for r in self._ring], 1)
            y_state = mesh_lib.fetch_local(self.mesh, self._y_state, 1)
        B = y_state.shape[1]
        streaming = self._stream_t_row is not None
        return {
            "ring": ring,
            "y_state": y_state,
            "stream_t_row": (self._stream_t_row.copy() if streaming
                             else np.zeros(B, np.int64)),
            "stream_t": np.asarray(self._stream_t if streaming else -1,
                                   np.int64),
            "stream_batch": np.asarray(B if streaming else 0, np.int64),
        }

    def import_state(self, state: Dict[str, np.ndarray]):
        """Restore a snapshot of `export_state`, possibly taken by another
        engine or process with the same config and weights: the next `feed`
        or `run_partial` continues exactly where the exporter left off,
        every row at its own clock.  The ring takes this engine's dtype
        (bf16 under compute_dtype=bfloat16, rounding a float32 snapshot's
        values, as the JAX engine casts it).  Under a mesh the snapshot is
        this process's rows, split over its shards."""
        ring = np.asarray(state["ring"], np.float32)
        y_state = np.asarray(state["y_state"], np.int32)
        B = y_state.shape[-1]
        if (y_state.shape != (2, B) or B * self._n_proc() > self.max_batch
                or ring.shape != (self.cfg.ring_size, B, self.cfg.R)):
            raise ValueError(f"snapshot ring {ring.shape} / y_state "
                             f"{y_state.shape} do not match the config "
                             f"(ring_size={self.cfg.ring_size}, "
                             f"R={self.cfg.R}, max_batch={self.max_batch})")
        streaming = int(state["stream_t"]) >= 0
        if streaming:
            clocks = np.asarray(state["stream_t_row"], np.int64)
            if (clocks.shape != (B,) or clocks.min() < 0
                    or int(state["stream_batch"]) != B):
                raise ValueError(f"snapshot stream_t_row {clocks.tolist()} "
                                 f"does not fit its batch {B}")
        if self.mesh is not None:
            self._check_mesh_batch(B * self._n_proc())
            self._ring = self._shard(ring, 1, self._ring_dtype)
            self._y_state = self._shard(y_state, 1, torch.int32)
        else:
            self._ring = torch.from_numpy(ring.copy()).to(self.device,
                                                          self._ring_dtype)
            self._y_state = torch.from_numpy(y_state.copy()).to(self.device)
        self._stream_t_row = clocks.copy() if streaming else None

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
