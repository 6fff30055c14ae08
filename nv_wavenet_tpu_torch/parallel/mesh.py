"""Multi-device scaling for the port: a data mesh of torch devices,
batch-sharded generation, and multi-process bring-up.

The port's counterpart of `nv_wavenet_tpu/parallel/mesh.py` (the
reference's `pytorch/distributed.py`):

  * generation is batch-data-parallel: the weights are replicated on every
    device of the mesh, the utterance batch is split along its 'data' axis,
    and nothing communicates inside the sample loop.  Each shard runs the
    whole network on its own rows (K1, K4, K6, the dumps, forced p_seq)
    with its own launch, on its own CUDA stream, inside
    `torch.cuda.device(shard.device)`: the kernels configure and launch on
    the runtime's current device, not the tensors' (`cudaFuncSetAttribute`,
    K7's per-device caches), so a shard on card 1 launched while card 0 is
    current would fail or configure the wrong card.
  * a mesh entry may repeat a device (`[torch.device("cpu")] * 4`,
    `[cuda:0, cuda:0]`): the counterpart of XLA's virtual host devices, so
    the tests shard on the CPU and one card runs two shards, each launch on
    its own stream.
  * several processes (one per card, `initialize_multihost`) each hold their
    own rows: `stage` splits this process's rows over its shards and
    `fetch_local` reads them back in shard order; nothing is gathered across
    processes, so either backend serves (NCCL across cards, gloo for
    processes that share one card; `initialize_multihost` chooses).
"""

from __future__ import annotations

import collections
import contextlib
import json
import socket
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import fused_chain, persistent, scan_generate

# the Weyl step of the shards' prng keys: 0x9E3779B9 of the JAX package
# (`mesh.py:195-206`) widened to the port's 64-bit seeds
SHARD_KEY_STEP = 0x9E3779B97F4A7C15


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, device="cuda") -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, rendezvous at `coordinator_address` ("host:port", rank
    0's; no environment variable is read).  On the card each rank takes
    the next card of its host, in rank order among the host's ranks, and
    the group runs on NCCL; on gloo where a host holds more ranks than
    cards (NCCL refuses two ranks on one card), as on the CPU.  Every rank
    sees every host's rank and card counts through the rendezvous, so all
    choose the same backend."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0)
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        store.set(f"nvw_host/{process_id}",
                  json.dumps([socket.gethostname(), cards]))
        hosts = [json.loads(store.get(f"nvw_host/{r}"))
                 for r in range(num_processes)]
        mine = [r for r, h in enumerate(hosts) if h[0] == hosts[process_id][0]]
        torch.cuda.set_device(mine.index(process_id) % cards)
        ranks_on = collections.Counter(h[0] for h in hosts)
        if all(ranks_on[name] <= n for name, n in hosts):
            backend = "nccl"
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)


def _process() -> tuple:
    """(process count, this process's index): torch.distributed's world,
    or (1, 0) when no process group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Shard(NamedTuple):
    """One entry of a mesh's 'data' axis in this process: its index on the
    global axis, its device and its stream (None on the CPU)."""
    index: int
    device: torch.device
    stream: object


class DataMesh:
    """A 1-D mesh of torch devices along the axis 'data'.

    `devices` are this process's entries (a device may repeat); `shape
    ["data"]` is the global axis, this process's entries times the process
    count (every process holds as many).  Each entry is a `Shard` with its
    own CUDA stream on its device (`streams` gives them, for a check)."""

    def __init__(self, devices: Sequence, streams: Optional[Sequence] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda" and d.index is None:
                raise ValueError(f"{d}: name the card's index (cuda:0)")
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {d}")
        self.process_count, self.process_index = _process()
        n = len(self.devices)
        if streams is None:
            streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                       else None for d in self.devices]
        self.shards = tuple(Shard(self.process_index * n + k, d, s)
                            for k, (d, s) in enumerate(zip(self.devices,
                                                           streams)))
        self.shape = {"data": n * self.process_count}

    @property
    def local_devices(self) -> tuple:
        """The distinct devices of this process's shards, in order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return (f"DataMesh(data={self.shape['data']}, devices="
                f"{[str(d) for d in self.devices]}, process "
                f"{self.process_index} of {self.process_count})")


def data_mesh(n: Optional[int] = None, devices=None) -> DataMesh:
    """The first `n` of `devices` (default: all) as a 'data' mesh.  The
    default devices are every card this process sees, or, when
    torch.distributed is initialised (one process per card), this
    process's current card.  Raises without a card unless devices are
    given: the entry points run on the card unless asked for the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device; pass devices= "
                               "(for example [torch.device('cpu')] * 4) to "
                               "shard on the CPU explicitly")
        if _process()[0] > 1:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"n={n} outside [1, {len(devices)} devices]")
    return DataMesh(devices[:n])


def shard_key(seed: int, index: int) -> int:
    """The prng key of the shard at `index` on the 'data' axis for the
    engine's `seed`: seed + index * 0x9E3779B97F4A7C15 modulo 2^64.  Shard 0
    keeps the seed.  The step is odd, so the shards of one seed never share
    a key; and Philox takes the key apart from its counter (absolute
    sample index, row), so two keys give unrelated streams, never copies
    shifted in time (the JAX package's `seed + t` reseed shifts, fault R8,
    which is why its per-shard stride must outrun any sample count)."""
    return (int(seed) + int(index) * SHARD_KEY_STEP) & 0xFFFFFFFFFFFFFFFF


def _device_scope(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


@contextlib.contextmanager
def shard_scope(shard: Shard):
    """Make `shard`'s device the runtime's current device and its stream the
    current stream there (nothing on the CPU)."""
    if shard.device.type != "cuda":
        yield
        return
    with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
        yield


def run_shards(mesh: DataMesh, fn, *per_shard: Sequence) -> list:
    """[fn(shard, *args_k) for each local shard k], every call inside
    `shard_scope`, each shard's stream first waiting for the work queued
    on its device's current stream (which made its inputs) and that stream
    then waiting for the shard's: every launch is queued before anything
    reads a result, and what the caller does next on the current streams
    sees the shards' results.  A shard that fails raises."""
    outs = []
    for k, shard in enumerate(mesh.shards):
        if shard.device.type == "cuda":
            shard.stream.wait_stream(torch.cuda.current_stream(shard.device))
        with shard_scope(shard):
            outs.append(fn(shard, *(a[k] for a in per_shard)))
    for shard in mesh.shards:
        if shard.device.type == "cuda":
            torch.cuda.current_stream(shard.device).wait_stream(shard.stream)
    return outs


def _split(mesh: DataMesh, x, batch_axis: int) -> list:
    n = len(mesh.shards)
    B = x.shape[batch_axis]
    if B % n:
        raise ValueError(f"batch {B} not divisible by the mesh's {n} local "
                         f"shards (the 'data' axis has {mesh.shape['data']})")
    return list(torch.as_tensor(x).split(B // n, dim=batch_axis))


def stage(mesh: DataMesh, x_local, batch_axis: int, dtype=None) -> list:
    """Place host data (or a tensor) into the sharded layout: a list of one
    contiguous tensor per local shard, split along `batch_axis`, each on its
    shard's device (copied on its stream).  x_local is this process's rows
    (with one process, the whole batch).  dtype: cast on the way.  The
    parts are copies: a shard's state never aliases the caller's array."""
    parts = _split(mesh, x_local, batch_axis)

    def put(shard, part):
        if part.device.type == "cpu" and shard.device.type == "cuda":
            # pinned, non-blocking: staging waits for no launch queued
            # on the shard's stream
            return part.to(dtype=dtype).contiguous().pin_memory().to(
                shard.device, non_blocking=True)
        return part.to(shard.device, dtype, copy=True).contiguous()
    return run_shards(mesh, put, parts)


def fetch_local(mesh: DataMesh, parts: Sequence[torch.Tensor],
                batch_axis: int) -> np.ndarray:
    """Host copy of this process's rows of a sharded array (one tensor per
    local shard, as `stage` makes), concatenated in shard order along
    `batch_axis`.  Nothing is gathered from other processes."""
    host = run_shards(mesh, lambda shard, t: t.cpu(), parts)
    return torch.cat(host, dim=batch_axis).numpy()


def gather(parts: Sequence[torch.Tensor], batch_axis: int) -> torch.Tensor:
    """The local shards' tensors concatenated along `batch_axis` on the
    first one's device (call after `run_shards`, whose streams it
    follows)."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=batch_axis)


def replicate(mesh: DataMesh, params) -> Dict[torch.device, object]:
    """{device: params on it} for each distinct local device: a dict of
    tensors (canonical params) or a tuple (K6's prepared weights)."""
    def to(dev):
        if isinstance(params, dict):
            return {k: v.to(dev).contiguous() for k, v in params.items()}
        return tuple(v.to(dev).contiguous() for v in params)
    return {d: to(d) for d in mesh.local_devices}


def sharded_generate_plain(params: Dict[str, torch.Tensor],
                           cfg: WaveNetConfig, mesh: DataMesh, cond,
                           selectors, mode: str = "sample"):
    """Batch-sharded generation with the plain loop
    (`scan_generate.run_steps`) on every shard: weights replicated, the
    batch split along 'data', nothing communicated.  cond [T, L, B, 2R]
    raw (dil_b is added per shard, as `scan_generate.generate` adds it);
    selectors [T, B].  Returns (state, y [B, T] int32): the final
    `scan_generate.GenState` and y of this process's rows, on the first
    shard's device."""
    T = cond.shape[0]
    by_dev = replicate(mesh, params)
    conds, sels = stage(mesh, cond, 2, torch.float32), stage(
        mesh, selectors, 1, torch.float32)

    def run(shard, c, s):
        p = by_dev[shard.device]
        b = c.shape[2]
        st = scan_generate.init_state(cfg, b, shard.device)
        ys = torch.stack([st.y_prev, st.y_cur])
        y, _, _ = scan_generate.run_steps(
            p, cfg, 0, c + p["dil_b"][None, :, None, :], s, st.ring, ys, T,
            mode)
        return y, st.ring, ys
    outs = run_shards(mesh, run, conds, sels)
    ring = gather([o[1] for o in outs], 1)
    ys = gather([o[2] for o in outs], 1)
    state = scan_generate.GenState(ring, ys[0], ys[1], T)
    return state, gather([o[0] for o in outs], 1).T


def make_sharded_persistent_generator(cfg: WaveNetConfig, mesh: DataMesh,
                                      batch_per_device: int,
                                      mode: str = "sample",
                                      weight_dtype=torch.float32,
                                      compute_dtype=torch.float32,
                                      fast_math: bool = False,
                                      dump: bool = False,
                                      stream_weights: bool = False,
                                      stream_group_size: int = 8,
                                      stream_prefetch: bool = False,
                                      stream_quant: bool = False,
                                      fuse_chain: bool = False,
                                      fuse_pack: bool = False,
                                      shared: Optional[Dict] = None):
    """The generator of `persistent.make_persistent_generator` (or, with
    fuse_chain and neither stream_weights nor dump, K6's of
    `fused_chain.make_fused_generator`, prefolded conditioning) run on every
    shard of `mesh` over its own `batch_per_device` rows.

    Returns `generate(params, t0, cond_pre, sel, ring, y_state, n_valid=None,
    seed=0)`: params {device: params} (`replicate`; under fuse_chain K6's
    prepared weights, folded once per upload by the caller, never here);
    cond_pre, sel, ring and y_state lists of one tensor per local shard
    (`stage`), ring and y_state updated in place.  Each shard's launch is
    queued on its own stream inside its device (`run_shards`) before any
    result is read.  Returns (y [T, B_local] int32, ring, y_state) with y
    the shards' rows concatenated on the first shard's device, plus the
    dumps (xt, skip [L, B_local, .], zs, za, p [B_local, A]) when dump and
    p_seq [T, B_local, A] in mode "forced", each concatenated on its batch
    axis (the JAX package's out_specs).  Mode "prng" keys shard k's draws on
    `shard_key(seed, k)`.

    One generator is built for each distinct device, so its per-upload
    caches (the storage view, K1's staged stream, K4's stacks, K6's cluster
    stream) are held once per device; `shared` ({device: dict}) keeps them
    across several generators as the engine's `shared=` does.  `.route` is
    the route every shard runs; `.generators` the per-device generators."""
    fused = fuse_chain and not stream_weights and not dump
    if shared is None:
        shared = {}
    gens = {}
    for dev in mesh.local_devices:
        if fused:
            gens[dev] = fused_chain.make_fused_generator(
                cfg, batch_per_device, mode=mode, weight_dtype=weight_dtype,
                fast_math=fast_math, prefold_cond=True, pack_gates=fuse_pack,
                compute_dtype=compute_dtype)
        else:
            gens[dev] = persistent.make_persistent_generator(
                cfg, batch_per_device, mode=mode, dump=dump,
                weight_dtype=weight_dtype, stream_weights=stream_weights,
                stream_group_size=stream_group_size,
                stream_prefetch=stream_prefetch, stream_quant=stream_quant,
                compute_dtype=compute_dtype, fast_math=fast_math,
                shared=shared.setdefault(dev, {}))

    def generate(params, t0: int, cond_pre, sel, ring, y_state,
                 n_valid: Optional[int] = None, seed: int = 0):
        for name, a in (("cond_pre", cond_pre), ("sel", sel), ("ring", ring),
                        ("y_state", y_state)):
            if len(a) != len(mesh.shards):
                raise ValueError(f"{name}: {len(a)} parts for "
                                 f"{len(mesh.shards)} local shards")

        # per-device caches first, on each device's current stream, which
        # every shard's stream then waits for: shards of one device share
        # them, so none may be built on one shard's stream
        for dev, gen in gens.items():
            with _device_scope(dev):
                gen.prepare(params[dev], dev)

        def launch(shard, c, s, r, ys):
            return gens[shard.device](params[shard.device], t0, c, s, r, ys,
                                      n_valid, shard_key(seed, shard.index))
        outs = run_shards(mesh, launch, cond_pre, sel, ring, y_state)
        res = (gather([o[0] for o in outs], 1), list(ring), list(y_state))
        # dumps: xt, skip [L, B, .] on axis 1, zs, za, p [B, A] on axis 0;
        # p_seq [T, B, A] on axis 1
        axes = ((1, 1, 0, 0, 0) if dump else ()) + (
            (1,) if mode == "forced" else ())
        return res + tuple(gather([o[3 + i] for o in outs], ax)
                           for i, ax in enumerate(axes))

    generate.route = next(iter(gens.values())).route
    generate.generators = gens
    return generate
