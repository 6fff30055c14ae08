"""Time kernel K1, kernel K4 in each weight storage and kernel K6 (the
collapsed chain, fp32 and fast_math) beside it, on the card across depth
and batch at the flagship widths (R=64, S=256, A=256, max_dilation 512,
sample mode): a diagnostic of where the generation kernels' time goes,
beside the single flagship point that chip_smoke.py times.

    python3 -m nv_wavenet_tpu_torch.tools.k1_sweep

Prints one JSON line per (kernel, L, B) point with the mean device time of
one launch of STEPS samples (CUDA events, after a warm-up launch), then one
line per kernel and batch with the least-squares split of a step into a
per-layer cost and a fixed cost (embedding, output stack and sampler) -
for K6 also a cost per layer squared, its chain's product over the earlier
gates growing with the layer - then the card's name and power limit.  K1
reads every weight from L2 along each row's chain of dependent loads; K4
(stream_weights=True, fp32, bf16 or int8 stacks) copies dil_w and rs_w into
shared memory ahead of its products; K6 reads its folded weights from L2,
four columns a load.  All run one CTA per batch row, so the time per step
stays flat in B until the rows outnumber what the SMs hold at once.
"""

from __future__ import annotations

import functools
import json
import subprocess

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import fused_chain, persistent

DEPTHS = (1, 5, 10, 15, 20)
BATCHES = (1, 16, 64, 132, 264)
STEPS = 256   # samples per launch: one run_chunks chunk of the main path
REPS = 3      # timed launches per point, after one warm-up launch


def _persistent(**kw):
    """K1/K4: `make_persistent_generator` on the canonical params."""
    def make(cfg, B, params):
        return functools.partial(
            persistent.make_persistent_generator(cfg, B, **kw), params)
    return make


def _fused(fast_math: bool):
    """K6 on the folded weights, prepared once (the engine's dil_b prefold)."""
    def make(cfg, B, params):
        return functools.partial(
            fused_chain.make_fused_generator(cfg, B, fast_math=fast_math,
                                             prefold_cond=True),
            fused_chain.prepare_weights(params, cfg, True,
                                        fast_math=fast_math))
    return make


# kernel name -> generator maker, and the degree of its fit in L
KERNELS = {
    "K1": (_persistent(), 1),
    "K4 fp32": (_persistent(stream_weights=True), 1),
    "K4 bf16": (_persistent(stream_weights=True,
                            weight_dtype=torch.bfloat16), 1),
    "K4 int8": (_persistent(stream_weights=True, stream_quant=True), 1),
    "K6 fp32": (_fused(False), 2),
    "K6 fast_math": (_fused(True), 2),
}


def time_launch(cfg: WaveNetConfig, B: int, make) -> float:
    dev = torch.device("cuda")
    params = params_lib.canonical_to_torch(
        params_lib.to_canonical(
            params_lib.random_reference_weights(cfg, seed=1), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cond_pre = torch.rand((STEPS, cfg.num_layers, B, 2 * cfg.R), generator=g,
                          device=dev) - 0.5
    sel = torch.rand((STEPS, B), generator=g, device=dev)
    gen = make(cfg, B, params)
    times = []
    for _ in range(REPS + 1):
        ring = persistent.init_ring(cfg, B, dev)
        y_state = torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                             device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gen(0, cond_pre, sel, ring, y_state)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times[1:]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_sweep measures kernels K1, K4 and K6 on a CUDA "
                         "card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False   # K6's fold
    us = {}
    for name, (make, _) in KERNELS.items():
        for B in BATCHES:
            for L in DEPTHS:
                cfg = WaveNetConfig(num_layers=L, R=64, S=256, A=256,
                                    max_dilation=512)
                ms = time_launch(cfg, B, make)
                us[name, B, L] = ms / STEPS * 1e3
                print(json.dumps({"kernel": name, "L": L, "B": B,
                                  "steps": STEPS, "ms": ms,
                                  "us_per_step": us[name, B, L],
                                  "khz_per_utt": 1e3 / us[name, B, L],
                                  "samples_per_s": B * 1e6 / us[name, B, L]}),
                      flush=True)
    for name, (_, degree) in KERNELS.items():
        for B in BATCHES:
            coef = np.polyfit(DEPTHS, [us[name, B, L] for L in DEPTHS],
                              degree)[::-1]
            fit = {"us_fixed": float(coef[0]), "us_per_layer": float(coef[1])}
            if degree == 2:
                fit["us_per_layer_sq"] = float(coef[2])
            print(json.dumps({"kernel": name, "B": B, **fit}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
