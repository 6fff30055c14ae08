"""A benchmark root at tiny sizes for the CPU tests: BENCHMARK.json with
one cell of each traffic kind, their configs and traffic files, and the
metric readers of the real benchmark."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GEN = {"name": "tiny-gen", "num_layers": 4, "max_dilation": 4, "R": 8,
       "S": 16, "A": 256, "precision": "fp32", "implementation": "AUTO",
       "assumed": {}, "reduced": []}
OFFLINE = {"kind": "offline", "batch": 3, "samples": 24, "chunk": 8,
           "cond_bank": 2, "selector_bank": 3, "cond_range": 0.5,
           "warmup_requests": 1, "check_requests": 2, "trace_seconds": 0.05,
           "limits": {"widest_sel_gap": 1e-4}}
SERVE = {"kind": "serve", "slots": 3, "tick_min": 2, "tick_max": 6,
         "p_stall": 0.125, "utt_min": 8, "utt_max": 20, "cond_range": 0.5,
         "warmup_ticks": 2, "check_utterances": 3, "trace_seconds": 0.05,
         "limits": {"widest_sel_gap": 1e-4}}
TRAIN_CFG = {
    "name": "tiny-train",
    "train_config": {"learning_rate": 1e-3, "batch_size": 2, "seed": 1},
    "data_config": {"segment_length": 400, "mu_quantization": 32,
                    "filter_length": 64, "hop_length": 16, "win_length": 64,
                    "sampling_rate": 16000, "n_mel_channels": 8,
                    "mel_fmin": 0.0, "mel_fmax": 8000.0},
    "wavenet_config": {"n_in_channels": 32, "n_layers": 3,
                       "max_dilation": 2, "n_residual_channels": 4,
                       "n_skip_channels": 8, "n_out_channels": 32,
                       "n_cond_channels": 8, "upsamp_window": 32,
                       "upsamp_stride": 16},
    "assumed": {}, "reduced": []}
TRAIN = {"kind": "train", "data_parallel": 1, "clips": 4,
         "clip_samples": 800, "checked_steps": 3, "warmup_steps": 1,
         "stop_every": 2, "trace_seconds": 0.05,
         "limits": {"loss1_gap": 1e-5, "grad1_gap": 1e-4,
                    "change_gap": 1e-3}}


def make_root(path: str) -> str:
    """A root under `path` holding the real benchmark's BENCHMARK.json with
    every cell retargeted at a tiny config and traffic of its kind, on one
    card."""
    os.makedirs(os.path.join(path, "benchmark"), exist_ok=True)
    # readers are loaded from the root's files; the code from the package
    shutil.copytree(os.path.join(REPO, "benchmark", "metrics"),
                    os.path.join(path, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    for d in ("configs", "traffic"):
        os.makedirs(os.path.join(path, "benchmark", d), exist_ok=True)
    b = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    files = {"tiny-gen": GEN, "tiny-train": TRAIN_CFG}
    for name, cfg in files.items():
        with open(os.path.join(path, "benchmark", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
    b["configs"] = [{"name": n, "source": "tiny",
                     "file": f"benchmark/configs/{n}.json", "reduced": [],
                     "why": "tiny"} for n in files]
    traffic = {"offline": OFFLINE, "serve": SERVE, "train": TRAIN}
    for w in b["workloads"]:
        kind = json.load(open(os.path.join(
            REPO, "benchmark", "traffic", w["traffic"] + ".json")))["kind"]
        w["config"] = "tiny-train" if kind == "train" else "tiny-gen"
        w["chips"] = 1
        t = dict(traffic[kind])
        with open(os.path.join(path, "benchmark", "traffic",
                               w["traffic"] + ".json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return path
