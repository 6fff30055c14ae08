"""Config-driven training CLI (`nvw-torch-train`):

    python -m nv_wavenet_tpu_torch.train.cli -c configs/config.json

The port's counterpart of `nv_wavenet_tpu/train/cli.py` (the reference's
`python train.py -c config.json`, `pytorch/train.py:158-193`), with the same
config sections and keys (`pytorch/config.json`): train_config,
data_config, dist_config, wavenet_config.  It trains on the card unless
`--device cpu` is given.

Schedules: `num_iters` (the infinite random sampler, each rank its own
stream) takes precedence over `epochs` (dataset passes: a shuffle per
epoch, the clip list sharded over ranks, drop_last batching, the epoch
offset on resume).  Resume: train_config.checkpoint_path (a checkpoint
directory) and checkpoint_iteration (the latest where it is null).

dist_config: a data_parallel x model_parallel x seq_parallel mesh
(`trainer.make_mesh`) over several processes, joined by `torch.distributed`
from the config alone (`coordinator_address` "host:port", `num_processes`,
each rank's `process_id` or the `--process_id` flag;
`parallel.mesh.initialize_multihost`, which joins on NCCL on the card and
on gloo on the CPU or where processes share a card).  The product of the
three must equal the number of processes.  batch_size is per data rank:
every model and seq peer of a data rank draws the same batch.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-n", "--num_iters", type=int, default=None,
                    help="override train_config.num_iters")
    ap.add_argument("--process_id", type=int, default=None,
                    help="this process's rank (overrides "
                         "dist_config.process_id)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, the plain path")
    args = ap.parse_args(argv)

    with open(args.config) as f:
        cfg = json.load(f)
    train_c = cfg["train_config"]
    data_c = cfg["data_config"]
    dist_c = cfg.get("dist_config", {})
    wavenet_c = cfg["wavenet_config"]

    dp = dist_c.get("data_parallel", 1)
    mp = dist_c.get("model_parallel", 1)
    sp = dist_c.get("seq_parallel", 1)

    import torch

    from nv_wavenet_tpu_torch.engine.wavenet_infer import resolve_device
    from nv_wavenet_tpu_torch.parallel.mesh import initialize_multihost
    from nv_wavenet_tpu_torch.train import trainer
    from nv_wavenet_tpu_torch.train.data import (Mel2Samp,
                                                 data_config_from_json,
                                                 load_wav, synthetic_clips)

    device = resolve_device(args.device)
    rank, world = 0, 1
    if dist_c.get("coordinator_address"):
        rank = args.process_id
        if rank is None:
            rank = dist_c.get("process_id")
        if rank is None:
            raise ValueError("dist_config.coordinator_address needs each "
                             "rank's process_id (or --process_id)")
        world = dist_c.get("num_processes", dp * mp * sp)
    if dp * mp * sp != world:
        raise ValueError(
            f"data_parallel={dp} x model_parallel={mp} x seq_parallel={sp} "
            f"= {dp * mp * sp} needs as many processes (dist_config."
            f"coordinator_address and num_processes), got {world}")
    if dist_c.get("coordinator_address"):
        initialize_multihost(dist_c["coordinator_address"], world, rank,
                             device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())

    data_cfg = data_config_from_json(data_c)
    if data_c.get("synthetic") or not data_c.get("training_files"):
        clips = synthetic_clips(n_clips=4, length=4 * data_cfg.segment_length)
    else:
        with open(data_c["training_files"]) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        clips = [load_wav(p)[0] for p in paths]

    ds = Mel2Samp(clips, data_cfg, seed=train_c.get("seed", 1234))
    model = trainer.create_model(wavenet_c)
    mesh = None
    if world > 1:
        mesh = trainer.make_mesh(dp, mp, sp, net=model,
                                 segment_length=data_cfg.segment_length)
    # the data pipeline is sharded over the data ranks alone
    d = mesh.data_rank if mesh is not None else 0
    tcfg = trainer.TrainConfig(
        learning_rate=train_c.get("learning_rate", 1e-3),
        batch_size=train_c.get("batch_size", 4),
        seed=train_c.get("seed", 1234),
        iters_per_checkpoint=train_c.get("iters_per_checkpoint", 1000),
        with_tensorboard=train_c.get("with_tensorboard", False),
    )
    resume_dir = train_c.get("checkpoint_path") or None
    resume_it = train_c.get("checkpoint_iteration")   # None: the latest

    num_iters = args.num_iters or train_c.get("num_iters")
    if num_iters is not None:
        if train_c.get("epochs"):
            print("note: num_iters set; epochs ignored "
                  "(iteration-driven schedule)", flush=True)
        batches = ds.batches(tcfg.batch_size, rank=d, world_size=dp)
    else:
        epochs = train_c.get("epochs", 1)
        spe = ds.steps_per_epoch(tcfg.batch_size, dp)
        if spe < 1:
            raise ValueError(f"dataset too small: {len(ds.clips)} clips < "
                             f"batch_size {tcfg.batch_size} x {dp} data "
                             f"rank(s)")
        num_iters = epochs * spe
        if resume_dir and resume_it is None:
            resume_it = trainer.latest_iteration(resume_dir)
        start_epoch = (resume_it // spe) if resume_dir else 0
        batches = ds.epoch_batches(tcfg.batch_size, epochs, rank=d,
                                   world_size=dp, start_epoch=start_epoch)
        print(f"epoch schedule: {epochs} epochs x {spe} steps "
              f"(world={world})", flush=True)

    out_dir = train_c.get("output_directory") or None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        out_dir = os.path.abspath(out_dir)
    t0 = time.time()
    state, losses = trainer.train(model, tcfg, batches, num_iters=num_iters,
                                  ckpt_dir=out_dir,
                                  log_every=train_c.get("log_every", 1),
                                  resume_dir=resume_dir,
                                  resume_iteration=resume_it, device=device,
                                  mesh=mesh)
    dt = time.time() - t0
    ran = len(losses)   # fewer than num_iters when resuming mid-schedule
    if rank == 0:
        if ran:
            sps = ran * tcfg.batch_size * dp * data_cfg.segment_length / dt
            print(f"final loss: {losses[-1]:.6f}  ({ran} iters in {dt:.1f}s "
                  f"on {device}, {ran / dt:.2f} it/s, {sps / 1e6:.3f} M "
                  f"audio samples/s)", flush=True)
        else:
            print(f"nothing to do: resumed at iteration >= num_iters="
                  f"{num_iters}", flush=True)
    return state, losses


if __name__ == "__main__":
    main()
