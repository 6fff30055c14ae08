#!/usr/bin/env python3
"""Tensor and sequence parallel training across the cards of one machine,
one process a card, joined on NCCL: configs/config.json's model (16
layers, R=64, S=256, A=256, max_dilation 128; a batch of 4 x 16,000
samples from its data pipeline, "highest") on every data x model x seq
mesh of the cards' count, against the one-process step on card 0.

For each mesh: one step from the seed on the same batch through
`trainer.make_mesh` / `shard_train_state` / `train_step`, held as
`chip_smoke.py` phase 32e holds it (the loss within 1e-5 of the
one-process step's, every gathered gradient within rtol 1e-4 and atol
1e-5 of it, the parameters after Adam within 2.1 lr, the collective
checkpoint loaded into a one-process model bit for bit); then `--steps`
steps timed.  The one-process step is timed before and after the meshes.
On NCCL the backward's model-group all-reduces (`sharding.copy_to_model`)
run while DDP's bucket all-reduces over the data x seq group are in
flight, on another communicator: a mesh with both axes above 1 is the
case where that ordering would hang.

    python3 -m nv_wavenet_tpu_torch.tools.train_mesh_probe
        [--meshes 2x2x1,1x2x2] [--steps 5]

Needs two cards or more: with fewer, or where a mesh disagrees with the
one-process step, it exits non-zero.  Prints each card's name and power
limit and one JSON line per mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

from nv_wavenet_tpu_torch.train import sharding, trainer
from nv_wavenet_tpu_torch.train.data import (Mel2Samp, data_config_from_json,
                                             synthetic_clips)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "config.json")
WORK = os.path.join(REPO, "build", "train_mesh_probe")
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
WORKER_TIMEOUT = 240


def cards() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def config() -> tuple:
    with open(CONFIG) as f:
        cfg = json.load(f)
    return cfg["wavenet_config"], cfg["train_config"], cfg["data_config"]


def meshes_of(n: int, net, segment: int) -> list:
    """Every (data, model, seq) with data * model * seq = n that shards
    `net` and a segment of `segment` samples (`sharding.check_shapes`)."""
    out = []
    for m in range(1, n + 1):
        for s in range(1, n // m + 1):
            if n % (m * s):
                continue
            try:
                sharding.check_shapes(net, m, s, segment)
            except ValueError:
                continue
            out.append((n // (m * s), m, s))
    return out


def excess(got: dict, ref: dict) -> float:
    """The largest |got - ref| - GRAD_RTOL |ref| over every tensor (a
    gradient within rtol and atol of ref reads <= atol)."""
    return max(float(((got[k].double() - r.double()).abs()
                      - GRAD_RTOL * r.double().abs()).max())
               for k, r in ref.items())


def timed_ms(state, mel, audio, steps: int) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(state, mel, audio)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / steps


def worker(rank: int, world: int, port: str, meshes: list,
           steps: int) -> int:
    """One rank: each mesh's held step (rank 0 saves the gathered gradients
    and parameters), its collective checkpoint and `steps` steps timed."""
    import torch.distributed as dist
    from nv_wavenet_tpu_torch.parallel.mesh import initialize_multihost
    initialize_multihost(f"127.0.0.1:{port}", world, rank, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    wc, tc, _ = config()
    tcfg = trainer.TrainConfig(learning_rate=tc["learning_rate"],
                               seed=tc["seed"])
    batch = torch.load(os.path.join(WORK, "batch.pt"))
    report = {"rank": rank, "backend": dist.get_backend(), "meshes": {}}
    for axes in meshes:
        tag = "x".join(map(str, axes))
        net = trainer.create_model(wc)
        mesh = trainer.make_mesh(*axes, net=net,
                                 segment_length=batch["audio"].shape[1])
        state = trainer.shard_train_state(net, tcfg, mesh, dev)
        b = batch["audio"].shape[0] // mesh.data
        mel, audio = (batch[k][mesh.data_rank * b:(mesh.data_rank + 1) * b]
                      .to(dev) for k in ("mel", "audio"))
        loss = float(trainer.train_step(state, mel, audio))
        grads = trainer.full_state_dict(
            state, {k: p.grad for k, p in state.module.named_parameters()})
        params = trainer.full_state_dict(state)
        trainer.save_checkpoint(os.path.join(WORK, f"ckpt_{tag}"), state, 1)
        if rank == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                        "params": {k: v.cpu() for k, v in params.items()}},
                       os.path.join(WORK, f"{tag}.pt"))
        dist.barrier()
        report["meshes"][tag] = {"loss": loss,
                                 "ms_per_step": timed_ms(state, mel, audio,
                                                         steps)}
        del state, grads, params
        torch.cuda.empty_cache()
    print(json.dumps({"train_mesh_worker": report}), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default=None,
                    help="comma-separated DxMxS (default: every mesh of "
                         "the cards' count that shards the model)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "MESHES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, port, meshes = args.worker
        return worker(int(rank), int(world), port,
                      [tuple(map(int, m.split("x")))
                       for m in meshes.split(",")], args.steps)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"train_mesh_probe: {n} CUDA device(s); needs two or more",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = cards()
    for c in names:
        print(c, flush=True)
    wc, tc, dc = config()
    data_cfg = data_config_from_json(dc)
    if args.meshes:
        meshes = [tuple(map(int, m.split("x")))
                  for m in args.meshes.split(",")]
    else:
        meshes = meshes_of(n, trainer.create_model(wc),
                           data_cfg.segment_length)
    if any(d * m * s != n for d, m, s in meshes):
        raise ValueError(f"every mesh must hold the {n} cards: {meshes}")
    os.makedirs(WORK, exist_ok=True)
    ds = Mel2Samp(synthetic_clips(n_clips=4,
                                  length=4 * data_cfg.segment_length),
                  data_cfg, seed=tc["seed"])
    mel_np, audio_np = next(ds.batches(tc["batch_size"]))
    torch.save({"mel": torch.from_numpy(mel_np),
                "audio": torch.from_numpy(audio_np)},
               os.path.join(WORK, "batch.pt"))

    # the one-process step on card 0: the reference, timed
    dev = torch.device("cuda", 0)
    mel, audio = (torch.from_numpy(a).to(dev) for a in (mel_np, audio_np))
    tcfg = trainer.TrainConfig(learning_rate=tc["learning_rate"],
                               seed=tc["seed"])
    one = trainer.create_train_state(trainer.create_model(wc), tcfg, dev)
    loss1 = float(trainer.train_step(one, mel, audio))
    grads1 = {k: p.grad.to("cpu", copy=True)
              for k, p in one.module.named_parameters()}
    after1 = {k: v.to("cpu", copy=True)
              for k, v in one.module.state_dict().items()}
    one_ms = [timed_ms(one, mel, audio, args.steps)]

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    tags = ",".join("x".join(map(str, m)) for m in meshes)
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nv_wavenet_tpu_torch.tools.train_mesh_probe",
         "--steps", str(args.steps), "--worker", str(r), str(n), port, tags],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    workers_s = time.perf_counter() - t
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"train_mesh_probe: worker {r} exited {p.returncode}:\n"
                  f"{text[-4000:]}", file=sys.stderr)
            return 1
    reports = [json.loads(next(ln for ln in text.splitlines()
                               if ln.startswith('{"train_mesh_worker"')))[
        "train_mesh_worker"] for text in outs]
    one_ms.append(timed_ms(one, mel, audio, args.steps))

    ok = True
    lr = tc["learning_rate"]
    for axes in meshes:
        tag = "x".join(map(str, axes))
        res = torch.load(os.path.join(WORK, f"{tag}.pt"))
        fresh = trainer.create_train_state(
            trainer.create_model(wc),
            trainer.TrainConfig(seed=tc["seed"] + 1), dev)
        fresh, it = trainer.load_checkpoint(os.path.join(WORK, f"ckpt_{tag}"),
                                            None, fresh)
        got = fresh.module.state_dict()
        bits = sum(int((got[k].cpu().view(torch.int32)
                        != v.view(torch.int32)).sum())
                   for k, v in res["params"].items())
        ms = [w["meshes"][tag]["ms_per_step"] for w in reports]
        r = {"mesh": tag, "backend": reports[0]["backend"],
             "loss_err": max(abs(w["meshes"][tag]["loss"] - loss1)
                             for w in reports),
             "grad_excess_max": excess(res["grads"], grads1),
             "param_max_abs_err": max(float((res["params"][k] - v).abs()
                                            .max())
                                      for k, v in after1.items()),
             "checkpoint_iteration": it, "checkpoint_bit_mismatches": bits,
             "ms_per_step_ranks": ms, "one_process_ms": one_ms,
             "speedup": (sum(one_ms) / len(one_ms)) / max(ms),
             "card": names[0]}
        r["ok"] = bool(r["loss_err"] <= LOSS_TOL
                       and r["grad_excess_max"] <= GRAD_ATOL
                       and r["param_max_abs_err"] <= 2.1 * lr
                       and it == 1 and bits == 0 and len(got) == len(after1))
        ok &= r["ok"]
        print(json.dumps({"train_mesh": r}), flush=True)
        del fresh
    print(json.dumps({"train_mesh_probe": {
        "ok": ok, "cards": n, "meshes": tags, "workers_s": workers_s}}),
        flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
