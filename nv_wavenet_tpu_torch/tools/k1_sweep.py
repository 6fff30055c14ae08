"""Time kernel K1, and kernel K4 in each weight storage beside it, on the card
across depth and batch at the flagship widths (R=64, S=256, A=256,
max_dilation 512, sample mode): a diagnostic of where the generation
kernels' time goes, beside the single flagship point that chip_smoke.py
times.

    python3 -m nv_wavenet_tpu_torch.tools.k1_sweep

Prints one JSON line per (kernel, L, B) point with the mean device time of
one launch of STEPS samples (CUDA events, after a warm-up launch), then one
line per kernel and batch with the least-squares split of a step into a
per-layer cost and a fixed cost (embedding, output stack and sampler), then
the card's name and power limit.  K1 reads every weight from L2 along each
row's chain of dependent loads; K4 (stream_weights=True, fp32, bf16 or int8
stacks) copies dil_w and rs_w into shared memory ahead of its products.
Both run one CTA per batch row, so the time per step stays flat in B until
the rows outnumber what the SMs hold at once.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import persistent

DEPTHS = (1, 10, 20)
BATCHES = (1, 16, 64, 132, 264)
STEPS = 256   # samples per launch: one run_chunks chunk of the main path
REPS = 3      # timed launches per point, after one warm-up launch
# kernel name -> make_persistent_generator keywords
KERNELS = {
    "K1": {},
    "K4 fp32": dict(stream_weights=True),
    "K4 bf16": dict(stream_weights=True, weight_dtype=torch.bfloat16),
    "K4 int8": dict(stream_weights=True, stream_quant=True),
}


def time_launch(cfg: WaveNetConfig, B: int, gen_kw: dict) -> float:
    dev = torch.device("cuda")
    params = params_lib.canonical_to_torch(
        params_lib.to_canonical(
            params_lib.random_reference_weights(cfg, seed=1), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cond_pre = torch.rand((STEPS, cfg.num_layers, B, 2 * cfg.R), generator=g,
                          device=dev) - 0.5
    sel = torch.rand((STEPS, B), generator=g, device=dev)
    gen = persistent.make_persistent_generator(cfg, B, **gen_kw)
    times = []
    for _ in range(REPS + 1):
        ring = persistent.init_ring(cfg, B, dev)
        y_state = torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                             device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gen(params, 0, cond_pre, sel, ring, y_state)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times[1:]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep measures kernels K1 and K4 on a CUDA card;"
                         " none is available")
    us = {}
    for name, gen_kw in KERNELS.items():
        for B in BATCHES:
            for L in DEPTHS:
                cfg = WaveNetConfig(num_layers=L, R=64, S=256, A=256,
                                    max_dilation=512)
                ms = time_launch(cfg, B, gen_kw)
                us[name, B, L] = ms / STEPS * 1e3
                print(json.dumps({"kernel": name, "L": L, "B": B,
                                  "steps": STEPS, "ms": ms,
                                  "us_per_step": us[name, B, L],
                                  "khz_per_utt": 1e3 / us[name, B, L],
                                  "samples_per_s": B * 1e6 / us[name, B, L]}),
                      flush=True)
    for name in KERNELS:
        for B in BATCHES:
            per_layer, fixed = np.polyfit(
                DEPTHS, [us[name, B, L] for L in DEPTHS], 1)
            print(json.dumps({"kernel": name, "B": B,
                              "us_per_layer": float(per_layer),
                              "us_fixed": float(fixed)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
