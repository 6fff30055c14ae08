"""The program's own spans and counters in a run: what the per-layer readers
of the program's layers take from it.

The program (nv_wavenet_tpu_torch, `utils/tracing.py`) opens a host range
`nvw:<name>` where its work happens while a profiler runs, and keeps
counters that are always on.  Of a traced run this walks the profile once
(`of(run)`):

  * spans[name]: (start, end, thread) of each `nvw:<name>` range inside
    the traced window (`bench:traced`), in us on the profiler's clock;
  * device_s[name]: device seconds of the ops launched inside those ranges
    from their own thread (each op tied to the runtime call that launched
    it by correlation id, as `tracing.py` ties them);
  * idle_s[name]: seconds inside those ranges with no op on the card, the
    card's clock first aligned to the host's launch calls (`causal`);
  * has_device: whether any op ran on the card inside the window.

A program without those spans or counters (one older than them) gives
empty spans and counters, and the readers read nothing.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s>

runs a one-card cell traced in this process on card 0 (as `run.py` runs it;
without a card it refuses, exit 2), prints its line, then the card's idle
seconds in the traced window by the innermost range (`nvw:` or `bench:`)
that holds them, and the largest shift `causal` gave the card's clock.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
from typing import Dict, List, Optional

if __package__ in (None, ""):
    # as run.py: few host threads, the package `benchmark` from the root,
    # this directory off the path
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "2"
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != _HERE]
    sys.path.insert(0, os.path.dirname(_HERE))

from benchmark.tracing import (SPAN_PREFIX, TRACED, _merge, _on_card,  # noqa
                               _Ranges)

PREFIX = "nvw:"
# the span of the card's clock over which `causal` takes one shift, in us
BIN_US = 50e3


def counters() -> Dict[str, int]:
    """The program's counters; empty where it has none."""
    try:
        from nv_wavenet_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.counters()


def of(run) -> Optional[dict]:
    """The program's spans in a traced run's profile (None untraced)."""
    prof = run.tracer.prof
    if prof is None:
        return None
    if getattr(run, "program_trace", None) is None:
        run.program_trace = walk(list(prof.events()))
    return run.program_trace


def walk(events) -> dict:
    window = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == SPAN_PREFIX + TRACED and not _on_card(e)]
    if not window:
        raise RuntimeError("the trace holds no traced range")
    w0, w1 = window[0]
    spans: Dict[str, List[tuple]] = {}
    bench: List[tuple] = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _on_card(e) or a < w0 or b > w1:
            continue
        if e.name.startswith(PREFIX):
            spans.setdefault(e.name[len(PREFIX):], []).append(
                (a, b, e.thread))
        elif e.name.startswith(SPAN_PREFIX) and e.name[len(
                SPAN_PREFIX):] != TRACED:
            bench.append((e.name, a, b))
    for ivs in spans.values():
        ivs.sort()
    launch = {e.id: (e.time_range.start, e.thread) for e in events
              if not _on_card(e) and e.name.startswith("cu")}
    dev = []
    for e in events:
        if not _on_card(e) or getattr(e, "is_user_annotation", False) \
                or e.name.startswith((SPAN_PREFIX, PREFIX)):
            continue
        dev.append((e.time_range.start, e.time_range.end, launch.get(
            e.id, launch.get(getattr(e, "linked_correlation_id", None)))))
    dev, shift = causal(dev, w0, w1)
    dev = [(a, b, src) for a, b, src in dev if b > w0 and a < w1]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, _ in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = _Ranges(gaps)
    device_s, idle_s = {}, {}
    for name, ivs in spans.items():
        by_thread: Dict[object, list] = {}
        for a, b, th in ivs:
            by_thread.setdefault(th, []).append((a, b))
        ranges = {th: _Ranges(v) for th, v in by_thread.items()}
        device_s[name] = sum(
            (b - a) / 1e6 for a, b, src in dev
            if src is not None and src[1] in ranges
            and ranges[src[1]].holds(src[0]))
        idle_s[name] = sum(idle.overlap(a, b) for a, b, _ in ivs) / 1e6
    return {"spans": spans, "device_s": device_s, "idle_s": idle_s,
            "has_device": bool(dev), "gaps": gaps, "clock_shift_us": shift,
            "ranges": [(PREFIX + n, a, b) for n, ivs in spans.items()
                       for a, b, _ in ivs] + bench}


def causal(dev, w0: float, w1: float):
    """The card's ops (start, end, launching call) with the card's clock
    moved later, bin by bin (`BIN_US`) over the window, by the least amount
    that starts every op at or after the start of the runtime call that
    launched it: Kineto puts the card's events on the host's clock by a
    conversion that can drift (traced serving runs on an H100 read K5
    starting up to 1.9 ms before its own launch call, in some runs and not
    others).  An op's bin is that of its start; a bin with no launching call
    takes its neighbour's shift.  Returns (the ops, the largest shift in
    us)."""
    n = int((w1 - w0) // BIN_US) + 1

    def bin_of(t):
        return min(n - 1, max(0, int((t - w0) // BIN_US)))
    least: List[Optional[float]] = [None] * n
    for a, _, src in dev:
        if src is not None:
            i = bin_of(a)
            least[i] = min(a - src[0], least[i] if least[i] is not None
                           else 0.0)
    seen = [i for i in range(n) if least[i] is not None]
    if not seen:
        return dev, 0.0
    shift = [0.0] * n
    for i in range(n):
        near = min(seen, key=lambda j: abs(j - i))
        shift[i] = -least[near]
    out = [(a + shift[bin_of(a)], b + shift[bin_of(a)], src)
           for a, b, src in dev]
    return out, max(shift)


def span_ms(run, name: str) -> Optional[float]:
    """The median host ms of the traced `nvw:<name>` ranges; None where
    there are none."""
    t = of(run)
    ivs = t["spans"].get(name) if t else None
    if not ivs:
        return None
    return statistics.median((b - a) / 1e3 for a, b, _ in ivs)


def device_ms_per(run, name: str, per: str) -> Optional[float]:
    """Device ms of the ops launched inside `nvw:<name>`, over the traced
    `nvw:<per>` ranges; None without a card or without those ranges."""
    t = of(run)
    if not t or not t["has_device"] or name not in t["spans"] \
            or not t["spans"].get(per):
        return None
    return t["device_s"][name] / len(t["spans"][per]) * 1e3


def idle_ms_per(run, name: str) -> Optional[float]:
    """The card's idle ms inside the traced `nvw:<name>` ranges, a range;
    None without a card or without those ranges."""
    t = of(run)
    if not t or not t["has_device"] or not t["spans"].get(name):
        return None
    return t["idle_s"][name] / len(t["spans"][name]) * 1e3


def idle_by_innermost(t: dict) -> Dict[str, float]:
    """The card's idle seconds in the traced window by the innermost range
    (the shortest, `nvw:` or `bench:`) that holds them; "none" outside
    every range."""
    ranges = sorted(t["ranges"], key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    longest = max((b - a for _, a, b in ranges), default=0.0)
    cuts = sorted({x for _, a, b in ranges for x in (a, b)})
    out: Dict[str, float] = {}
    for g0, g1 in t["gaps"]:
        i, j = bisect.bisect_right(cuts, g0), bisect.bisect_left(cuts, g1)
        pts = [g0] + cuts[i:j] + [g1]
        for p0, p1 in zip(pts, pts[1:]):
            m = (p0 + p1) / 2
            best, k = None, bisect.bisect_right(starts, m) - 1
            while k >= 0 and m - starts[k] <= longest:
                name, a, b = ranges[k]
                if b >= m and (best is None or b - a < best[1]):
                    best = (name, b - a)
                k -= 1
            key = best[0] if best else "none"
            out[key] = out.get(key, 0.0) + (p1 - p0) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = harness.Spec()
    if int(spec.cell(args.workload)["chips"]) != 1:
        raise SystemExit("a one-card cell only")
    if not torch.cuda.is_available():
        print("this cell needs 1 CUDA device(s); found 0", file=sys.stderr)
        return 2
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    run, line = harness.run_in_process(spec, args.workload, args.seed,
                                       args.seconds, True,
                                       torch.device("cuda", 0))
    print(json.dumps(line), flush=True)
    t = of(run)
    if not t["has_device"]:
        raise RuntimeError("no op ran on the card in the traced window")
    print(json.dumps({"idle_by_innermost_s": idle_by_innermost(t),
                      "window_s": run.trace_summary["window_s"],
                      "clock_shift_us": t["clock_shift_us"],
                      "spans": {k: len(v) for k, v in t["spans"].items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
