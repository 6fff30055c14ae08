#!/usr/bin/env python3
"""Batch inference CLI (`nvw-torch-inference`): checkpoint + mel features ->
wav files, on the card unless `--device cpu` is given.

The port's counterpart of `nv_wavenet_tpu/tools/inference.py` (the
reference's `pytorch/inference.py:64-88`): load a checkpoint of
`nvw-torch-train`, export its weights into the engine
(`models.wavenet.export_canonical`), compute the conditioning with the
model's upsampler and cond layer (`get_cond_input`, on the device), run the
autoregressive engine (`WaveNetInfer`; kernel K1 on the card in the default
mode), mu-law decode and write wavs at the config's sampling rate.

    python3 -m nv_wavenet_tpu_torch.tools.inference -c <ckpt_dir> \\
        [-i iteration] -f mel_list.txt -o out_dir [-b batch] \\
        [-m auto|persistent|manyblock|fused|fast] [-s sample|argmax]

mel_list.txt: one .npy mel file per line ([frames, n_mel];
`tools/mel2samp.py` makes them from wavs).  Without -i the latest
checkpoint is taken.  With --demo it generates from a freshly initialised
model on synthetic mels (no checkpoint needed).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from nv_wavenet_tpu_torch.engine.wavenet_infer import (Impl, WaveNetInfer,
                                                       resolve_device)
from nv_wavenet_tpu_torch.models import wavenet as wavenet_lib
from nv_wavenet_tpu_torch.train import trainer
from nv_wavenet_tpu_torch.train.data import (data_config_from_json,
                                             mel_spectrogram, synthetic_clips,
                                             write_wav)
from nv_wavenet_tpu_torch.utils.mu_law import mu_law_decode_np

# -m: the engine's implementation and its knobs
MODES = {"auto": dict(implementation=Impl.AUTO),
         "persistent": dict(implementation=Impl.PERSISTENT),
         "manyblock": dict(implementation=Impl.MANYBLOCK),
         "fused": dict(implementation=Impl.PERSISTENT, fuse_chain=True),
         "fast": dict(implementation=Impl.PERSISTENT, priority="latency")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--files", help="text file listing mel .npy paths")
    ap.add_argument("-c", "--checkpoint_dir")
    ap.add_argument("-i", "--iteration", type=int, default=None)
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("-b", "--batch_size", type=int, default=1)
    ap.add_argument("-m", "--mode", default="auto", choices=sorted(MODES))
    ap.add_argument("-s", "--sampling", default="sample",
                    choices=["sample", "argmax"])
    ap.add_argument("-t", "--temperature", type=float, default=1.0,
                    help="sampling temperature (softmax(za/T), applied as a "
                         "weight transform; 1.0 = exact)")
    ap.add_argument("--config", default="configs/config.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, the plain path")
    ap.add_argument("--demo", action="store_true",
                    help="untrained model + synthetic mels")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with open(args.config) as f:
        cfg_json = json.load(f)
    model = trainer.create_model(cfg_json["wavenet_config"])
    data_cfg = data_config_from_json(cfg_json["data_config"])
    if args.demo:
        clips = synthetic_clips(n_clips=args.batch_size, length=16000,
                                sr=data_cfg.sampling_rate)
        mels = [mel_spectrogram(c, data_cfg) for c in clips]
    else:
        if not args.files:
            ap.error("-f is required unless --demo")
        with open(args.files) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        mels = [np.load(p) for p in paths]

    if args.checkpoint_dir:
        state = trainer.create_train_state(model, trainer.TrainConfig(),
                                           device)
        trainer.load_checkpoint(args.checkpoint_dir, args.iteration, state)
    model.to(device).eval()
    canon = wavenet_lib.export_canonical(model)
    cfg = wavenet_lib.config_of(model)

    os.makedirs(args.output_dir, exist_ok=True)
    engines = {}   # one engine a batch size, reused across groups
    written = []
    for lo in range(0, len(mels), args.batch_size):
        group = mels[lo:lo + args.batch_size]
        tmin = min(m.shape[0] for m in group)
        if any(m.shape[0] != tmin for m in group):
            print(f"WARNING: batch group {lo // args.batch_size} mixes mel "
                  f"lengths {[m.shape[0] for m in group]}; truncating all to "
                  f"{tmin} frames (sort mel_list by length to avoid this)",
                  flush=True)
        mel_b = torch.from_numpy(np.stack([m[:tmin] for m in group]).astype(
            np.float32)).to(device)
        with torch.no_grad():
            cond = model.get_cond_input(mel_b)          # [T, L, B, 2R]
        T, B = cond.shape[0], cond.shape[2]
        if B not in engines:
            eng = WaveNetInfer(num_layers=cfg.num_layers,
                               max_dilation=cfg.max_dilation, R=cfg.R,
                               S=cfg.S, A=cfg.A, max_batch=B,
                               tanh_embed=cfg.tanh_embed, chunk_size=256,
                               temperature=args.temperature, device=device,
                               **MODES[args.mode])
            eng.set_canonical_params(canon)
            engines[B] = eng
        eng = engines[B]
        eng.set_inputs(cond, selectors=None, seed=lo)
        t0 = time.time()
        y = eng.run(T, B, mode=args.sampling)
        dt = time.time() - t0
        print(f"batch {lo // args.batch_size}: {T} samples x {B} utt in "
              f"{dt:.2f}s ({T / dt / 1e3:.1f} kHz/utt on {device})",
              flush=True)
        for j in range(B):
            path = os.path.join(args.output_dir, f"audio_{lo + j}.wav")
            write_wav(path, mu_law_decode_np(y[j], cfg.A),
                      data_cfg.sampling_rate)
            written.append(path)
            print("wrote", path, flush=True)
    return written


if __name__ == "__main__":
    main()
