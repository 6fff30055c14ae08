#!/usr/bin/env python3
"""Batch-sharded generation across the cards of one machine: the flagship
(20 layers, R=64, S=256, A=256, max_dilation 512, random weights from
seed 1) through `WaveNetInfer(mesh=data_mesh(k))` for every k that divides
the batch, against one card.

For each mesh: its integers, ring and y_state against the one-card
engine's bit for bit (default selectors), K1's launches (one a shard a
chunk), and kHz per utterance timed in turns (one card, mesh, mesh, one
card).  Then the batch that fills every card at the per-card rows of the
first run (B x cards over all cards against B on one card, in turns):
samples per second over the batch.  Builds only K1's library.

    python3 -m nv_wavenet_tpu_torch.tools.mesh_probe [-b 16] [-n 4096]

Needs the cards: with none, or where a mesh disagrees with one card, it
exits non-zero.  Prints each card's name and
power limit and one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from nv_wavenet_tpu_torch import config as cfg_lib
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import persistent
from nv_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nv_wavenet_tpu_torch.utils import build

CHUNK = 256


def cards() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--batch", type=int, default=16)
    ap.add_argument("-n", "--samples", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    build.build_all([build.unit("staged_generate.cu")])
    print(f"built K1 in {time.perf_counter() - t:.1f} s", flush=True)
    n_cards = torch.cuda.device_count()
    names = cards()
    print("cards:", "; ".join(names), flush=True)
    cfg = cfg_lib.FLAGSHIP_CONFIG
    ref_w = params_lib.random_reference_weights(cfg, seed=1)
    k1 = persistent.PERSISTENT_KERNELS["exact"]
    dev0 = torch.device("cuda", 0)
    T = args.samples

    def make(B, mesh):
        eng = WaveNetInfer(num_layers=cfg.num_layers,
                           max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                           A=cfg.A, max_batch=B, chunk_size=CHUNK, mesh=mesh,
                           device=None if mesh else dev0)
        eng.set_reference_weights(ref_w)
        return eng

    def cond_of(B):
        gen = torch.Generator(device=dev0)
        gen.manual_seed(7)
        return torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=gen,
                          device=dev0) - 0.5

    def run(eng, cond, B):
        eng.set_inputs(cond)
        torch.cuda.synchronize()
        k1.launches = 0
        t0 = time.perf_counter()
        y = eng.run_chunks(CHUNK, lambda *a: None, T, B)
        torch.cuda.synchronize()
        return y, eng.export_state(), T / (time.perf_counter() - t0) / 1e3, \
            k1.launches

    def held(a, b) -> int:
        return int((a[0] != b[0]).sum()) + sum(
            int((np.asarray(a[1][k]).view(np.int32)
                 != np.asarray(b[1][k]).view(np.int32)).sum())
            for k in ("ring", "y_state"))

    B = args.batch
    cond = cond_of(B)
    one = make(B, None)
    ref = run(one, cond, B)
    meshes = [("2 shards on cuda:0", mesh_lib.data_mesh(2, [dev0, dev0]))]
    meshes += [(f"{k} cards", mesh_lib.data_mesh(k))
               for k in range(2, n_cards + 1) if B % k == 0]
    bad = 0
    for label, mesh in meshes:
        eng = make(B, mesh)
        first = run(eng, cond, B)
        bad += held(first, ref)
        khz = {"one card": [], "mesh": []}
        for name in ("one card", "mesh", "mesh", "one card"):
            khz[name].append(run(one if name == "one card" else eng, cond,
                                 B)[2])
        print(json.dumps({"mesh_probe": {
            "mesh": label, "batch": B, "samples": T,
            "bit_mismatches": held(first, ref),
            "k1_launches": {"one card": ref[3], "mesh": first[3]},
            "khz_per_utt_in_turns": khz, "cards": names}}), flush=True)
    if n_cards > 1:
        # every card holding the first run's B rows, in turns with one
        # card at B: samples per second over the batch
        Bw = B * n_cards
        wide = make(Bw, mesh_lib.data_mesh(n_cards))
        cond_w = cond_of(Bw)
        run(wide, cond_w, Bw)
        rate = {"one card": [], "every card": []}
        for name in ("one card", "every card", "every card", "one card"):
            r = (run(one, cond, B) if name == "one card"
                 else run(wide, cond_w, Bw))
            rate[name].append((Bw if name == "every card" else B)
                              * r[2] * 1e3)
        print(json.dumps({"mesh_probe": {
            "mesh": f"{n_cards} cards, {B} rows each", "batch": Bw,
            "samples": T, "samples_per_s_in_turns": rate,
            "cards": names}}), flush=True)
    if bad:
        print(f"mesh_probe: {bad} values differ from one card",
              file=sys.stderr)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
