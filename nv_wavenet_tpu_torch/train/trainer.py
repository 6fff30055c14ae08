"""Training stack: teacher-forced WaveNet training, data, tensor and
sequence parallel over processes, checkpoints, and the metrics sink.

The port's counterpart of `nv_wavenet_tpu/train/trainer.py` (the reference
trainer, `pytorch/train.py` + `pytorch/distributed.py`):

  * CE loss over A mu-law classes with the one-sample output shift
    (`train.py:43-60`), Adam with optax's defaults (`train.py:100`),
  * parallelism is the JAX package's data x model x seq mesh
    (`make_mesh`, `shard_train_state`, `make_sharded_train_step`,
    `train(mesh=)`), one process a mesh position, taken whenever a process
    group of more than one rank is up (`parallel.mesh.initialize_multihost`;
    without a mesh, data parallelism alone, `make_mesh(world)`): tensor
    parallelism over 'model' and sequence parallelism over 'seq' through
    the collectives of `train/sharding.py`, `DistributedDataParallel` over
    each rank's data x seq group.  A step equals one process's step on the
    data ranks' whole batch,
  * checkpoint/resume (model + optimizer + iteration, `train.py:62-81,
    149-154`) in the port's own format: `torch.save` under `it_<n>/`; a
    sharded run gathers its shards (a collective every rank calls) and
    rank 0 writes one full checkpoint that a one-process model loads,
  * `precision` ("highest" / "default", `models.wavenet.precision_scope`)
    holds for the whole step, forward and backward: TF32 off in "highest"
    (cuDNN convolutions run TF32 by default, which would break the train
    <-> infer contract), on in "default"; both flags restored after it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nv_wavenet_tpu_torch.engine.wavenet_infer import resolve_device
from nv_wavenet_tpu_torch.models.wavenet import WaveNetTrain, precision_scope
from nv_wavenet_tpu_torch.train import sharding
from nv_wavenet_tpu_torch.train.sharding import TrainMesh
from nv_wavenet_tpu_torch.utils import tracing

CHECKPOINT_FILE = "checkpoint.pt"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    batch_size: int = 4
    seed: int = 1234
    iters_per_checkpoint: int = 1000
    # the reference's `with_tensorboard` flag (`train.py:83`): per-iteration
    # scalars also go to <ckpt_dir>/metrics.jsonl
    with_tensorboard: bool = False


@dataclasses.dataclass
class TrainState:
    """What a step changes: the model (wrapped in DDP where its data x seq
    group has more than one rank), its optimizer, the generator that
    initialised it, and the count of steps taken; `mesh`, the mesh the
    model is sharded for (None in one process)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    mesh: Optional[TrainMesh] = None

    @property
    def module(self) -> WaveNetTrain:
        """The bare model (DDP's `module` where it wraps one)."""
        return getattr(self.model, "module", self.model)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Mean CE over A classes; logits [B, T, A], targets [B, T] int
    (`pytorch/train.py:43-60`)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def create_model(wavenet_config: Dict[str, Any]) -> WaveNetTrain:
    """The model from a config dict with the reference's key names
    (`pytorch/config.json` wavenet_config)."""
    return WaveNetTrain(
        n_in_channels=wavenet_config.get("n_in_channels", 256),
        n_layers=wavenet_config.get("n_layers", 16),
        max_dilation=wavenet_config.get("max_dilation", 128),
        n_residual_channels=wavenet_config.get("n_residual_channels", 64),
        n_skip_channels=wavenet_config.get("n_skip_channels", 256),
        n_out_channels=wavenet_config.get("n_out_channels", 256),
        n_cond_channels=wavenet_config.get("n_cond_channels", 80),
        upsamp_window=wavenet_config.get("upsamp_window", 800),
        upsamp_stride=wavenet_config.get("upsamp_stride", 200),
        precision=wavenet_config.get("precision", "highest"),
    )


def _world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_train_state(model: WaveNetTrain, train_cfg: TrainConfig,
                       device=None, mesh: Optional[TrainMesh] = None
                       ) -> TrainState:
    """The model initialised from a generator seeded with train_cfg.seed,
    on `device` (None: the card), and torch's Adam with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8).  On a `mesh` every rank draws the full
    model from the seed and keeps this model rank's shards
    (`sharding.shard_module`); the model is wrapped in
    DistributedDataParallel over the rank's data x seq group (a replicated
    parameter's gradient summed over seq and averaged over data, a sharded
    one reduced over its own shard's peers only).  Under a process group
    of more than one rank and no mesh, the mesh is `make_mesh(world)`:
    data parallelism alone."""
    world = _world()[1]
    if mesh is None and world > 1:
        mesh = make_mesh(world)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(train_cfg.seed)
    model.reset_parameters(gen)
    if mesh is not None:
        sharding.shard_module(model, mesh)
    model.to(device)
    wrapped: torch.nn.Module = model
    if mesh is not None and len(mesh.ranks["data_seq"]) > 1:
        wrapped = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, process_group=mesh.groups["data_seq"])
    opt = torch.optim.Adam(model.parameters(), lr=train_cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(wrapped, opt, gen, mesh=mesh)


def make_mesh(data: int, model: int = 1, seq: int = 1,
              net: Optional[WaveNetTrain] = None,
              segment_length: Optional[int] = None) -> TrainMesh:
    """The training mesh over the process group's data * model * seq ranks
    ('data' outermost, `sharding.TrainMesh`); every rank calls it.  With
    `net` (and `segment_length`) it first raises where the mesh cannot
    shard them: 2RL or S not divisible by `model`, T not by `seq`, or
    T/seq < max_dilation (a halo spanning two ranks)."""
    if net is not None:
        sharding.check_shapes(net, model, seq, segment_length)
    return TrainMesh(data, model, seq)


def shard_train_state(model: WaveNetTrain, train_cfg: TrainConfig,
                      mesh: TrainMesh, device=None) -> TrainState:
    """`create_train_state` on `mesh` (the JAX package's name)."""
    return create_train_state(model, train_cfg, device, mesh)


def train_step(state: TrainState, mel: torch.Tensor, audio: torch.Tensor
               ) -> torch.Tensor:
    """One step on a batch on the model's device: forward, CE loss,
    backward, Adam, all under the model's precision.  Returns the loss as
    a device scalar.

    On a mesh (`state.mesh`) the batch is this rank's data rank's rows
    (every model and seq peer the same); the step keeps its seq window
    (`sharding.batch_partition`), runs forward and backward through the
    collectives, and returns the batch's mean loss, equal on every rank,
    as the reference reports it (`train.py:139-141`).  Each rank's loss is
    the mean over its b x T/seq positions (equal counts on every rank; the
    t = 0 zero logit on seq rank 0), so DDP's average over the data x seq
    group is the whole batch's gradient."""
    with tracing.span("train.step", state.step):
        mesh = state.mesh
        if mesh is not None:
            mel, audio = sharding.batch_partition(mesh, mel, audio)
        with precision_scope(state.module.precision):
            with tracing.span("train.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            with tracing.span("train.forward"):
                loss = cross_entropy_loss(state.model(mel, audio, mesh=mesh),
                                          audio)
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.optimizer"):
                state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        return loss if mesh is None else mesh.mean(loss)


def make_sharded_train_step(mesh: TrainMesh):
    """`train_step` for states sharded on `mesh` (the JAX package's
    name): it raises on a state of another mesh."""
    def step(state: TrainState, mel: torch.Tensor, audio: torch.Tensor
             ) -> torch.Tensor:
        if state.mesh is not mesh:
            raise ValueError(f"the state is sharded for {state.mesh}, the "
                             f"step for {mesh}")
        return train_step(state, mel, audio)
    return step


# ---------------------------------------------------------------------------
# checkpoints, `train.py:62-81` parity
# ---------------------------------------------------------------------------

def full_state_dict(state: TrainState,
                    local: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The full tensors of `local` (default: the model's state dict; or its
    gradients, keyed by parameter name) from every model rank's shards: a
    collective over the model group on a mesh, which every rank calls."""
    if local is None:
        local = state.module.state_dict()
    if state.mesh is None:
        return dict(local)
    return sharding.collect_state_dict(state.mesh, local)


def _map_moments(state: TrainState, opt: Dict[str, Any], fn) -> Dict:
    """The optimizer state dict `opt` with Adam's moments mapped by `fn`,
    which takes and returns {parameter name: tensor} (the keys
    `sharding.param_partition` reads), one moment at a time."""
    names = [n for n, _ in state.module.named_parameters()]
    out = {"state": {i: dict(st) for i, st in opt["state"].items()},
           "param_groups": opt["param_groups"]}
    keys = sorted({k for st in opt["state"].values()
                   for k, v in st.items() if torch.is_tensor(v) and v.dim()})
    for key in keys:
        mapped = fn({names[i]: st[key] for i, st in out["state"].items()})
        for i, st in out["state"].items():
            st[key] = mapped[names[i]]
    return out


def save_checkpoint(ckpt_dir: str, state: TrainState, iteration: int) -> str:
    """model, optimizer and iteration to <ckpt_dir>/it_<iteration>/; the
    file's path.  Every rank calls it (on a mesh the shards are gathered, a
    collective); rank 0 alone writes the full checkpoint."""
    path = os.path.join(ckpt_dir, f"it_{iteration}", CHECKPOINT_FILE)
    model_sd = full_state_dict(state)
    opt_sd = state.optimizer.state_dict()
    if state.mesh is not None:
        opt_sd = _map_moments(state, opt_sd,
                              lambda m: full_state_dict(state, m))
    if _world()[0] == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": model_sd, "optimizer": opt_sd,
                    "iteration": int(iteration)}, path)
    return path


def latest_iteration(ckpt_dir: str) -> int:
    its = sorted(int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
                 if d.startswith("it_") and d.split("_", 1)[1].isdigit())
    if not its:
        raise FileNotFoundError(f"no it_* checkpoints under {ckpt_dir}")
    return its[-1]


def load_checkpoint(ckpt_dir: str, iteration: Optional[int],
                    state: TrainState) -> Tuple[TrainState, int]:
    """Restore model, optimizer and iteration into `state` (onto its
    device) from <ckpt_dir>/it_<iteration>/, the latest where iteration is
    None; returns (state, iteration).  On a mesh every rank reads the full
    checkpoint and keeps its shards."""
    if iteration is None:
        iteration = latest_iteration(ckpt_dir)
    path = os.path.join(ckpt_dir, f"it_{iteration}", CHECKPOINT_FILE)
    device = next(state.module.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    load_full_state(state, ckpt["model"], ckpt["optimizer"])
    state.step = int(ckpt["iteration"])
    return state, state.step


def load_full_state(state: TrainState, model_sd: Dict[str, torch.Tensor],
                    optimizer_sd: Optional[Dict[str, Any]] = None) -> None:
    """Load a full model (and optimizer) state dict into `state`, this
    rank's shards of it on a mesh."""
    mesh = state.mesh
    if mesh is not None:
        def shard(sd):
            return sharding.shard_state_dict(sd, mesh.model,
                                             mesh.model_rank)
        model_sd = shard(model_sd)
        if optimizer_sd is not None:
            optimizer_sd = _map_moments(state, optimizer_sd, shard)
    state.module.load_state_dict(model_sd)
    if optimizer_sd is not None:
        state.optimizer.load_state_dict(optimizer_sd)


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def train(model: WaveNetTrain, train_cfg: TrainConfig,
          batches: Iterator[Tuple[Any, Any]], num_iters: int,
          ckpt_dir: Optional[str] = None, log_every: int = 1,
          resume_dir: Optional[str] = None,
          resume_iteration: Optional[int] = None,
          device=None, mesh: Optional[TrainMesh] = None
          ) -> Tuple[TrainState, List[float]]:
    """Run steps [start, num_iters) on `device` (None: the card); returns
    (final state, loss history).  Resuming restores model, optimizer and
    iteration (the latest checkpoint where resume_iteration is None) and
    continues from there (`train.py:62-71,102-107,127`).  On a `mesh`
    (`make_mesh`; under a process group and no mesh, `make_mesh(world)`)
    each batch is this rank's data rank's rows.
    Rank 0 alone prints, writes metrics and writes checkpoints; every rank
    calls the save, a collective on a mesh."""
    device = resolve_device(device)
    state = create_train_state(model, train_cfg, device, mesh)
    start_iter = 0
    if resume_dir:
        state, start_iter = load_checkpoint(resume_dir, resume_iteration,
                                            state)
        print(f"resumed from {resume_dir} at iteration {start_iter}",
              flush=True)
    is_chief = _world()[0] == 0
    metrics = None
    if train_cfg.with_tensorboard and is_chief:
        mdir = ckpt_dir or "."
        os.makedirs(mdir, exist_ok=True)
        metrics = open(os.path.join(mdir, "metrics.jsonl"), "a", buffering=1)
    # losses stay device scalars and are read at log cadence: a read every
    # step would wait for the card every step
    losses: List[torch.Tensor] = []
    t_start = time.time()
    dev_batches = _device_prefetch(batches, device)
    try:
        for it in range(start_iter, num_iters):
            mel, audio = next(dev_batches)
            loss = train_step(state, mel, audio)
            losses.append(loss)
            if it % log_every == 0:
                loss_f = float(loss)
                if is_chief:
                    print(f"{it}:\t{loss_f:.9f}", flush=True)
                if metrics is not None:
                    metrics.write(json.dumps(
                        {"iteration": it, "loss": loss_f,
                         "elapsed_s": round(time.time() - t_start, 3)})
                        + "\n")
            if ckpt_dir and (it + 1) % train_cfg.iters_per_checkpoint == 0:
                save_checkpoint(ckpt_dir, state, it + 1)
    finally:
        dev_batches.close()
        if metrics is not None:
            metrics.close()
    return state, [float(l) for l in losses]


def _device_prefetch(batches: Iterator, device, depth: int = 2):
    """A background thread featurises the coming batches and stages them on
    `device` (through pinned memory on the card) while the current step
    runs: the counterpart of the reference's `DataLoader(num_workers=1,
    pin_memory=True)` (`train.py:109-117`).  Yields tuples of tensors; an
    exception in the worker is raised in the consumer.  The worker counts
    its batches and the ns it spent featurising them (`data.featurized`,
    `data.featurize_ns`)."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(batch):
        out = []
        for a in batch:
            t = torch.as_tensor(a)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def worker():
        try:
            it = iter(batches)
            for i in itertools.count():
                t0 = time.perf_counter_ns()
                with tracing.span("data.featurize", i):
                    batch = next(it, None)
                if batch is None:
                    break
                tracing.count("data.featurize_ns",
                              time.perf_counter_ns() - t0)
                tracing.count("data.featurized", 1)
                with tracing.span("data.stage", i):
                    batch = stage(batch)
                if not put(batch):
                    return
        except BaseException as e:   # raised again in the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for i in itertools.count():
            with tracing.span("data.wait", i):
                item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5)
