"""Readings of a cell's compared numbers over many seeds, for the program
and for its controls and planted faults (`variants.py`): what each limit
in `traffic/<traffic>.json` is set from.

    python3 benchmark/readings.py --workload <cell> --seeds 12 \
        --seconds <s> --variants program bf16 fast [--first-seed n] \
        [--out <file.jsonl>]

A one-card cell runs every seed and variant in this one process (each run
builds its own engine or training state); a cell on several cards runs
`run.py --variant` once a reading.  Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != here]
    sys.path.insert(0, root)
    from benchmark import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--variants", nargs="+", default=["program"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.Spec(root)
    chips = int(spec.cell(args.workload)["chips"])
    out = open(args.out, "a") if args.out else None
    import torch
    for variant in args.variants:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            if chips == 1:
                run, line = harness.run_in_process(
                    spec, args.workload, seed, args.seconds, False,
                    torch.device("cuda", 0), variant)
                rec = {"compared": line["compared"], "correct":
                       line["correct"], "notes": run.notes,
                       "metrics": line["metrics"]}
            else:
                p = subprocess.run(
                    [sys.executable, os.path.join(here, "run.py"),
                     "--workload", args.workload, "--seed", str(seed),
                     "--seconds", str(args.seconds), "--trace", "0",
                     "--variant", variant], capture_output=True, text=True,
                    cwd=root, timeout=900)
                last = (p.stdout.strip().splitlines() or [""])[-1]
                rec = (json.loads(last) if p.returncode == 0 and last
                       else {"error": p.returncode,
                             "stderr": p.stderr[-2000:]})
            rec.update(workload=args.workload, variant=variant, seed=seed,
                       seconds=round(time.perf_counter() - t0, 2))
            text = json.dumps(rec, default=float)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            if chips == 1:
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
