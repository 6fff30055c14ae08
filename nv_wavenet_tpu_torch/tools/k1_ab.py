"""Time the generation kernels K1 and K5 of this checkout and another's in
turns, on the card.

    python3 -m nv_wavenet_tpu_torch.tools.k1_ab OTHER_ROOT

OTHER_ROOT is another checkout of this repo (for example the parent
commit, `git archive` unpacked into a directory that .gitignore lists).
Four processes run in turns: OTHER, this, this, OTHER.  Each imports its
own tree's `nv_wavenet_tpu_torch`, builds that tree's kernels into that
tree's `build/`, and times, through `ops.persistent.make_persistent_generator`
(an entry point both trees have), at the flagship (20 layers, R=64, S=256,
A=256, max_dilation 512, B=16, random weights from seed 1):

- K1, one 256-step launch (mode "sample"), in each precision;
- K5, one 160-step ragged tick with fixed per-row clocks and lengths
  (one row stalled, the others 40-160 steps), in each precision;
- K2 (mode "forced", symbols drawn on the card) and K3 (mode "prng"), one
  256-step launch each, in each precision: kernels both trees hold, their
  p_seq (K2) and y (K3) hashed;
- K4 with fp32 stacks, one 256-step launch: the same kernel in both trees,
  the yardstick of the call.

Each time is the mean of REPS launches by CUDA events after a warm-up.
Inputs are drawn on the card from fixed seeds, so both trees see the same
ones; y, the ring and y_state of each kernel's first launch from a fresh
state are hashed, and the trees must agree (the contract: every column sums
in k order, so a redesign moves no bit).  Each turn prints one JSON line;
the last line is a JSON summary with the times in turn order.  Exits 1 if
the trees' outputs differ or a turn fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

B, T, TICK = 16, 256, 160
REPS = 3
TURNS = ("other", "this", "this", "other")
PRECISIONS = ("exact", "fast", "bf16")
HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def digest(*ts) -> str:
    """sha256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def one_turn(root: str) -> dict:
    """Every measurement on the tree at `root`, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import nv_wavenet_tpu_torch
    if not os.path.abspath(nv_wavenet_tpu_torch.__file__).startswith(
            root + os.sep):
        raise RuntimeError(f"imported {nv_wavenet_tpu_torch.__file__}, not "
                           f"the package under {root}")
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import persistent, scan_generate
    from nv_wavenet_tpu_torch.utils import profiling
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = cfg_lib.FLAGSHIP_CONFIG
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=1), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(400)
    cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                      device=dev) - 0.5
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    sel = torch.rand((T, B), generator=g, device=dev)
    symbols = torch.floor(torch.rand((T, B), generator=g, device=dev)
                          * cfg.A).contiguous()
    rng = np.random.RandomState(401)
    lens = np.where(np.arange(B) == 3, 0, rng.randint(40, TICK + 1, B))
    n_valid_row = torch.from_numpy(lens.astype(np.int32))
    t0_row = torch.from_numpy(rng.randint(0, 4096, B).astype(np.int64))
    tick_cond = cond_pre[:TICK].contiguous()
    tick_sel = sel[:TICK].contiguous()
    kw = {"exact": {}, "fast": {"fast_math": True},
          "bf16": {"compute_dtype": torch.bfloat16}}

    def fresh(prec):
        return (persistent.init_ring(cfg, B, dev,
                                     scan_generate.ring_dtype(prec)),
                torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                           device=dev))

    def timed(fn, prec):
        state = fresh(prec)
        out = fn(state)
        torch.cuda.synchronize()
        first = digest(out[0], out[-1], *state)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(state)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS, first

    res = {"root": root, "card": profiling.card(), "ms": {}, "hashes": {}}
    for prec in PRECISIONS:
        k1 = persistent.make_persistent_generator(cfg, B, **kw[prec])
        k5 = persistent.make_persistent_generator(cfg, B, ragged=True,
                                                  **kw[prec])
        k2 = persistent.make_persistent_generator(cfg, B, mode="forced",
                                                  **kw[prec])
        k3 = persistent.make_persistent_generator(cfg, B, mode="prng",
                                                  **kw[prec])
        for name, fn in (
                (f"K1 {prec}", lambda st: k1(params, 0, cond_pre, sel, *st)),
                (f"K5 {prec}", lambda st: k5(params, t0_row, tick_cond,
                                             tick_sel, *st, n_valid_row)),
                (f"K2 {prec}", lambda st: k2(params, 0, cond_pre, symbols,
                                             *st)),
                (f"K3 {prec}", lambda st: k3(params, 0, cond_pre, sel, *st,
                                             seed=7))):
            res["ms"][name], res["hashes"][name] = timed(fn, prec)
    k4 = persistent.make_persistent_generator(cfg, B, stream_weights=True)
    res["ms"]["K4 fp32"], res["hashes"]["K4 fp32"] = timed(
        lambda st: k4(params, 0, cond_pre, sel, *st), "exact")
    res["k5_live_row_steps"] = int(lens.sum())
    return res


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        print(json.dumps(one_turn(argv[1])), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"other": os.path.abspath(argv[0]), "this": HERE_ROOT}
    turns = []
    for which in TURNS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             roots[which]], capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0 or not proc.stdout.strip():
            print(f"k1_ab: the {which} turn failed (rc {proc.returncode})",
                  file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=which, turn_s=time.perf_counter() - t)
        print(json.dumps(res), flush=True)
        turns.append(res)
    differ = sorted(k for k in turns[0]["hashes"]
                    if len({r["hashes"].get(k) for r in turns}) != 1)
    summary = {"turns": list(TURNS), "card": turns[0]["card"],
               "ms": {k: [r["ms"][k] for r in turns] for k in turns[0]["ms"]},
               "outputs_that_differ": differ}
    print(json.dumps({"k1_ab": summary}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
