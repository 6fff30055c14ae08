#!/usr/bin/env python3
"""Precompute mel features from wavs for inference (`nvw-torch-mel2samp`):
the port's counterpart of `nv_wavenet_tpu/tools/mel2samp.py` (the
reference's `mel2samp_onehot.py` CLI mode, `pytorch/mel2samp_onehot.py:
97-136`), writing .npy [frames, n_mel] files.

    python3 -m nv_wavenet_tpu_torch.tools.mel2samp -f wav_list.txt \\
        -o out_dir -c configs/config.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nv_wavenet_tpu_torch.train.data import (data_config_from_json, load_wav,
                                             mel_spectrogram)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--files", required=True,
                    help="text file listing wav paths, one a line")
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("-c", "--config", default="configs/config.json")
    args = ap.parse_args(argv)

    with open(args.config) as f:
        cfg = data_config_from_json(json.load(f)["data_config"])
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.files) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    for p in paths:
        audio, sr = load_wav(p)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{p}: sampling rate {sr} != "
                             f"{cfg.sampling_rate}")
        mel = mel_spectrogram(audio, cfg)
        out = os.path.join(args.output_dir,
                           os.path.splitext(os.path.basename(p))[0] + ".npy")
        np.save(out, mel)
        print(f"{p} -> {out} {mel.shape}", flush=True)


if __name__ == "__main__":
    main()
