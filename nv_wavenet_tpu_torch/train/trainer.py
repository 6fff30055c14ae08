"""Training stack: teacher-forced WaveNet training, data parallel over
processes, checkpoints, and the metrics sink.

The port's counterpart of `nv_wavenet_tpu/train/trainer.py` (the reference
trainer, `pytorch/train.py` + `pytorch/distributed.py`):

  * CE loss over A mu-law classes with the one-sample output shift
    (`train.py:43-60`), Adam with optax's defaults (`train.py:100`),
  * data parallelism is `DistributedDataParallel` over `torch.distributed`
    (gloo on the CPU, NCCL on the card), taken when a process group of more
    than one rank is up (`parallel.mesh.initialize_multihost`): each rank
    trains on its own batch shard and the gradients are averaged, so a
    step equals one process's step on the whole batch.  The JAX package's
    'model' and 'seq' mesh axes (tensor and sequence parallelism) have no
    counterpart yet (ROADMAP.md, section 1),
  * checkpoint/resume (model + optimizer + iteration, `train.py:62-81,
    149-154`) in the port's own format: `torch.save` under `it_<n>/`,
  * `precision` ("highest" / "default", `models.wavenet.precision_scope`)
    holds for the whole step, forward and backward: TF32 off in "highest"
    (cuDNN convolutions run TF32 by default, which would break the train
    <-> infer contract), on in "default"; both flags restored after it.
"""

from __future__ import annotations

import dataclasses
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
    """What a step changes: the model (wrapped in DDP under a process group
    of more than one rank), its optimizer, the generator that initialised
    it, and the count of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

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
                       device=None) -> TrainState:
    """The model initialised from a generator seeded with train_cfg.seed,
    on `device` (None: the card), and torch's Adam with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8).  Under a process group of more than one
    rank the model is wrapped in DistributedDataParallel; every rank draws
    the same initial parameters from the seed."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(train_cfg.seed)
    model.reset_parameters(gen)
    model.to(device)
    wrapped: torch.nn.Module = model
    if _world()[1] > 1:
        wrapped = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None)
    opt = torch.optim.Adam(model.parameters(), lr=train_cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(wrapped, opt, gen)


def train_step(state: TrainState, mel: torch.Tensor, audio: torch.Tensor
               ) -> torch.Tensor:
    """One step on a batch on the model's device: forward, CE loss,
    backward (the gradient averaged over ranks under DDP), Adam, all under
    the model's precision.  Returns the loss as a device scalar, averaged
    over ranks as the reference reports it (`train.py:139-141`): the loss
    of the whole batch."""
    with precision_scope(state.module.precision):
        state.optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(state.model(mel, audio), audio)
        loss.backward()
        state.optimizer.step()
    state.step += 1
    loss = loss.detach()
    world = _world()[1]
    if world > 1:
        dist.all_reduce(loss)
        loss = loss / world
    return loss


# ---------------------------------------------------------------------------
# checkpoints, `train.py:62-81` parity
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState, iteration: int) -> str:
    """model, optimizer and iteration to <ckpt_dir>/it_<iteration>/; the
    file's path."""
    path = os.path.join(ckpt_dir, f"it_{iteration}")
    os.makedirs(path, exist_ok=True)
    path = os.path.join(path, CHECKPOINT_FILE)
    torch.save({"model": state.module.state_dict(),
                "optimizer": state.optimizer.state_dict(),
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
    None; returns (state, iteration)."""
    if iteration is None:
        iteration = latest_iteration(ckpt_dir)
    path = os.path.join(ckpt_dir, f"it_{iteration}", CHECKPOINT_FILE)
    device = next(state.module.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.module.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["iteration"])
    return state, state.step


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def train(model: WaveNetTrain, train_cfg: TrainConfig,
          batches: Iterator[Tuple[Any, Any]], num_iters: int,
          ckpt_dir: Optional[str] = None, log_every: int = 1,
          resume_dir: Optional[str] = None,
          resume_iteration: Optional[int] = None,
          device=None) -> Tuple[TrainState, List[float]]:
    """Run steps [start, num_iters) on `device` (None: the card); returns
    (final state, loss history).  Resuming restores model, optimizer and
    iteration (the latest checkpoint where resume_iteration is None) and
    continues from there (`train.py:62-71,102-107,127`).
    Rank 0 alone prints, writes metrics and saves checkpoints (DDP keeps
    every rank's parameters equal)."""
    device = resolve_device(device)
    state = create_train_state(model, train_cfg, device)
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
            if (ckpt_dir and is_chief
                    and (it + 1) % train_cfg.iters_per_checkpoint == 0):
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
    exception in the worker is raised in the consumer."""
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
            for batch in batches:
                if not put(stage(batch)):
                    return
        except BaseException as e:   # raised again in the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5)
