"""Time K1 card-wide (`csrc/wide_generate.cu`) of this tree against another
tree's, in turns, in one process, on the card.

    python3 -m nv_wavenet_tpu_torch.tools.wide_ab OTHER_ROOT [--rounds 2]
        [--reps 3]

OTHER_ROOT is another checkout of this repo (for example the parent commit,
`git archive` unpacked into a directory that .gitignore lists).  Its
`nv_wavenet_tpu_torch/csrc/wide_generate.cu` is built with this tree's
flags (`utils/build.py`) into a library of its own under this tree's
`build/`, and its entry point is called with this tree's arguments cut to
its own count (an older one lacks the trailing cluster-size pointer; the
clusters are then reported for this tree alone).  Both kernels run on this
tree's plan and weight stream (`wide_plan`, `wide_stream`), so the other
tree's kernel must take the same plan.

At the wide vocoder's published widths (30 layers, R=512, S=A=256, no
embedding tanh; B=16, random weights from a fixed seed, inputs drawn on the
card), each launch runs T=256 steps in mode "sample" from the silence state
and is timed by CUDA events; a turn is `--reps` launches of one kernel,
after one warm-up launch of each, and the turns go other, this, this,
other, `--rounds` times.  Each kernel's warm-up output (y, the ring, y_state)
is hashed: the trees must agree bit for bit (every column sums in k order,
so a barrier moves no bit).  Each turn also reads the kernel's stamps (the
`gen.wide.*` counters): the share of the chains' cycles in the grid
barriers, the split, the clock, and the clusters a launch ran in.  Prints
one JSON line a turn, then a JSON summary with the card's name and power
limit; exits 1 if the trees' outputs differ.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

from nv_wavenet_tpu_torch import config as cfg_lib
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import persistent
from nv_wavenet_tpu_torch.utils import build, tracing
from nv_wavenet_tpu_torch.utils.profiling import card

WIDE = dict(num_layers=30, R=512, S=256, A=256, max_dilation=512,
            tanh_embed=False)
B, T, SEED = 16, 256, 31
TURNS = ("other", "this", "this", "other")
ENTRY = "nvw_wide_generate"


def entry_arity(source: str) -> int:
    """The parameter count of the entry point in a wide_generate.cu's text."""
    head = source.split(f"int {ENTRY}(", 1)[1].split(")", 1)[0]
    return head.count(",") + 1


class OtherKernel:
    """Another tree's K1 card-wide entry point, built from its csrc/ and
    called with this tree's arguments cut to its own count."""

    def __init__(self, root: str):
        csrc = os.path.join(os.path.abspath(root), "nv_wavenet_tpu_torch",
                            "csrc")
        source = os.path.join(csrc, "wide_generate.cu")
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        for name in sorted(os.listdir(csrc)):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(name.encode() + f.read())
        out = os.path.join(build.BUILD_ROOT, "wide_ab", h.hexdigest()[:16])
        path = os.path.join(out, "libwide_generate.so")
        if not os.path.exists(path):
            os.makedirs(out, exist_ok=True)
            subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", path,
                            source], check=True)
        with open(source) as f:
            self.arity = entry_arity(f.read())
        self._fn = getattr(ctypes.CDLL(path), ENTRY)
        self._fn.argtypes = persistent.WIDE_KERNELS["exact"].argtypes[
            :self.arity]
        self._fn.restype = ctypes.c_int

    def __call__(self, *args):
        if self.arity < len(args):   # no cluster size reported
            args[-1].contents.value = 1
        err = self._fn(*args[:self.arity])
        if err:
            raise RuntimeError(f"the other tree's {ENTRY}: CUDA error {err}")


def digest(*ts) -> str:
    """sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("wide_ab measures on a CUDA device and none is "
                           "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {"this": persistent.WIDE_KERNELS["exact"],
               "other": OtherKernel(args.other)}
    cfg = cfg_lib.WaveNetConfig(**WIDE)
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=SEED), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                      device=dev) - 0.5
    sel = torch.rand((T, B), generator=g, device=dev)
    cp = (cond + params["dil_b"][None, :, None, :]).contiguous()
    plan = persistent.wide_plan(cfg, B)
    arr = persistent._plan_array(plan)
    stream_w = persistent.wide_stream(params, cfg, plan)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=dev)
    sync = torch.zeros(1, dtype=torch.int32, device=dev)
    sched = persistent.fifo_schedule(cfg, dev)

    def run(which):
        persistent.WIDE_KERNELS["exact"] = kernels[which]
        ring = persistent.init_ring(cfg, B, dev)
        ys = torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                        device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = persistent._launch_wide(cfg, arr, params, stream_w, scratch,
                                    sync, sched, 0, cp, sel, ring, ys, T,
                                    "sample", build.current_stream(dev))[0]
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), (y, ring, ys)

    this_kernel = persistent.WIDE_KERNELS["exact"]
    try:
        hashes = {w: digest(*run(w)[1]) for w in ("other", "this")}
        turns = []
        for _ in range(args.rounds):
            for which in TURNS:
                before = tracing.counters()
                ms = [run(which)[0] for _ in range(args.reps)]
                after = tracing.counters()
                d = {k: after.get(k, 0) - before.get(k, 0) for k in (
                    *persistent.WIDE_STATS, "gen.wide.barriers",
                    "gen.wide.clusters")}
                cyc = d["gen.wide.cta_cycles"]
                turn = {"tree": which,
                        "step_us": [x * 1e3 / T for x in ms],
                        "wait_pct": 100.0 * d["gen.wide.wait_cycles"] / cyc,
                        "split_pct": {k.split(".")[-1]: round(
                            100.0 * d[k] / cyc, 2)
                            for k in persistent.WIDE_STATS},
                        "barriers_per_step": d["gen.wide.barriers"]
                        / (args.reps * T),
                        "clusters_per_launch": d["gen.wide.clusters"]
                        / args.reps if which == "this" else None,
                        "mhz": cyc / plan.ctas / (args.reps * T)
                        / (statistics.mean(ms) * 1e3 / T)}
                print(json.dumps(turn), flush=True)
                turns.append(turn)
    finally:
        persistent.WIDE_KERNELS["exact"] = this_kernel
    med = {w: statistics.median(x for t in turns if t["tree"] == w
                                for x in t["step_us"])
           for w in ("other", "this")}
    same = hashes["other"] == hashes["this"]
    print(json.dumps({
        "step_us_median": med, "this_over_other": med["this"] / med["other"],
        "wait_pct": {w: [round(t["wait_pct"], 2) for t in turns
                         if t["tree"] == w] for w in ("other", "this")},
        "clusters_per_launch": turns[TURNS.index("this")][
            "clusters_per_launch"],
        "outputs_equal": same, "card": card()}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
