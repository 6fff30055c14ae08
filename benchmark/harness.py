"""The benchmark's run: one cell, one seed, one window, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in the file the configs list names, its traffic in
`traffic/<traffic>.json`, whose `kind` names the code of
that kind of traffic, `mixes/<kind>.py`, and each metric's reader in
`metrics/<metric>.py`.  A mix has `setup(run) -> state`,
`window(run, state)`, `release(run, state)` and `check(run, state)`;
a reader has `read(run) -> float or None`.

A cell on several cards starts one process a card from this one command
(ranks 1.. run this file with `--rank` and `--port`); rank 0 runs the
check and prints the line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from benchmark import variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names that may not be loaded: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "nv_wavenet_tpu")
WORKER_TAG = "BENCH_WORKER "


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files its names lead to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.root, "benchmark", "traffic",
                                      name + ".json"))

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, or list none and (per-layer)
        move an end-to-end metric the cell reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names
                                 else [])]


def load_file(path: str, name: str):
    """A module from a file (a metric's file name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    return load_file(os.path.join(root, "benchmark", "metrics", name + ".py"),
                     "benchmark_metric_" + name.replace(".", "_"))


def mix(kind: str):
    return importlib.import_module(f"benchmark.mixes.{kind}")


class Run:
    """One run's inputs, and what its window and check record."""

    def __init__(self, spec: Spec, cell: str, seed: int, seconds: float,
                 trace: bool, rank: int = 0, world: int = 1, device=None,
                 engine_kw: Optional[dict] = None):
        self.spec, self.cell_name = spec, cell
        self.cell = spec.cell(cell)
        self.cfg = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.rank, self.world = rank, world
        self.device = device
        # program options a control run changes (never set by run.py)
        self.engine_kw = dict(engine_kw or {})
        self.spans: Dict[str, List[float]] = {}
        self.counts: Dict[str, float] = {}
        self.notes: Dict[str, object] = {}
        self.compared: Dict[str, dict] = {}
        self.window_s = 0.0
        self.t0 = 0.0          # the host clock as the window opened
        self.unit_ends: List[float] = []   # the host clock after each unit
        self.setup_s = 0.0
        self.attempted = self.failed = 0
        self.trace_summary: Optional[dict] = None
        self.worker_results: List[dict] = []
        self.lengths = None
        from benchmark.tracing import Tracer
        self.tracer = Tracer(trace, self.traffic.get("trace_seconds",
                                                      seconds))

    def open_window(self) -> None:
        self.tracer.start()
        self.t0 = time.perf_counter()

    def unit_done(self) -> float:
        """Record a unit of work (a request, a feed, a step) as done;
        returns the window's seconds so far."""
        now = time.perf_counter()
        self.unit_ends.append(now)
        self.tracer.poll(now - self.t0)
        return now - self.t0

    def close_window(self) -> None:
        self.tracer.stop()
        self.window_s = time.perf_counter() - self.t0

    def untraced(self):
        """(index of the first unit, seconds) of the part of the window that
        a host-clock per-layer metric reads: the whole window untraced; in
        a traced run the units after the profiler stopped (its overhead and
        its stop's processing left out), None where none ran."""
        if not self.trace:
            return 0, self.window_s
        u, resumed = self.tracer.units, self.tracer.resumed
        if resumed is None or u >= len(self.unit_ends):
            return None
        return u, self.t0 + self.window_s - resumed

    def compare(self, name: str, value: float, limit: float,
                at_least: bool = False) -> None:
        ok = value >= limit if at_least else value <= limit
        self.compared[name] = {"value": value, "limit": limit,
                               "at_least": at_least, "ok": bool(ok)}

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(c["ok"] for c in
                                           self.compared.values())


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def device_of(device) -> tuple:
    """(platform, kind) of the line's `device`."""
    import torch
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return device.type, device.type


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(args, world: int, port: int, tmp: str) -> list:
    procs = []
    for r in range(1, world):
        out = open(os.path.join(tmp, f"rank{r}.out"), "w")
        cmd = [sys.executable, os.path.join(HERE, "run.py"),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port),
               "--variant", args.variant]
        procs.append((subprocess.Popen(cmd, stdout=out, cwd=ROOT), out,
                      os.path.join(tmp, f"rank{r}.out")))
    return procs


def collect_workers(procs, timeout: float) -> List[dict]:
    results, errors = [], []
    deadline = time.monotonic() + timeout
    for p, out, path in procs:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        out.close()
        with open(path) as f:
            lines = [ln[len(WORKER_TAG):] for ln in f.read().splitlines()
                     if ln.startswith(WORKER_TAG)]
        if rc != 0 or not lines:
            errors.append(f"{path}: exit {rc}")
        else:
            results.append(json.loads(lines[-1]))
    if errors:
        raise RuntimeError("worker ranks failed: " + "; ".join(errors))
    return results


def stop_workers(procs) -> None:
    for p, out, _ in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        out.close()


def execute(run: Run):
    """Set-up, window, the memory peak and the release of the program's
    state in one process.  Returns (the process's readings for the line,
    what the mix keeps for the check)."""
    import torch
    mod = mix(run.traffic["kind"])
    st = mod.setup(run)
    run.tracer.warm()
    run.setup_s = time.perf_counter() - run.t_start
    mod.window(run, st)
    run.trace_summary = run.tracer.summary()
    memory = (torch.cuda.max_memory_allocated(run.device)
              if run.device.type == "cuda" else 0)
    found = forbidden_modules()
    result = {"memory_peak_bytes": int(memory), "forbidden": found,
              "trace": run.trace_summary}
    if hasattr(mod, "readings"):
        result["readings"] = mod.readings(st)
    mod.release(run, st)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return result, st


def line(run: Run, own: dict, workers: List[dict]) -> dict:
    """The result line of rank 0."""
    every = [own] + workers
    found = sorted({n for r in every for n in r["forbidden"]}
                   | set(forbidden_modules()))
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    metrics = {}
    for m in run.spec.metrics_of(run.cell_name, run.trace):
        v = reader(m["name"], run.spec.root).read(run)
        if v is None:
            # a per-layer reader finds nothing where its layer did not run
            if not run.trace:
                raise RuntimeError(f"metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    platform, kind = device_of(run.device)
    device = {"platform": platform, "kind": kind,
              "count": run.world,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in every),
              "power_limit": run.notes.get("power_limit")}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace:
        traces = [r["trace"] for r in every]
        # both averaged over the cards: each rank traces its own window
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        out["breakdown"] = traces[0]["breakdown"]
    out["compared"] = {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in run.compared.items()}
    return out


def run_in_process(spec: Spec, cell: str, seed: int, seconds: float,
                   trace: bool, device, variant: str = "program"):
    """One process's whole run of a one-card cell on `device` (the CPU
    runs the program's plain path), with `variant` (`variants.py`)
    planted: (the Run, its line)."""
    run = Run(spec, cell, seed, seconds, trace, device=device,
              engine_kw=variants.engine_kw(variant))
    run.t_start = time.perf_counter()
    with variants.faults(variant):
        own, st = execute(run)
    mix(run.traffic["kind"]).check(run, st)
    return run, line(run, own, [])


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    # a control or a planted fault (`variants.py`), for readings and tests
    ap.add_argument("--variant", default="program", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = Spec()
    world = int(spec.cell(args.workload)["chips"])
    import torch
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"this cell needs {world} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    procs, tmp = [], None
    port = args.port
    try:
        if world > 1 and args.rank == 0:
            tmp = tempfile.TemporaryDirectory(prefix="bench_ranks_")
            port = free_port()
            procs = start_workers(args, world, port, tmp.name)
        if world > 1:
            from nv_wavenet_tpu_torch.parallel.mesh import \
                initialize_multihost
            initialize_multihost(f"localhost:{port}", world, args.rank,
                                 "cuda")
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cuda", 0)
        run = Run(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), args.rank, world, device,
                  variants.engine_kw(args.variant))
        run.t_start = t_start
        run.notes["power_limit"] = power_limit() if args.rank == 0 else None
        with variants.faults(args.variant):
            own, st = execute(run)
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
        if args.rank:
            print(WORKER_TAG + json.dumps(own), flush=True)
            return 0 if not own["forbidden"] else 3
        if procs:
            run.worker_results = collect_workers(procs, 300)
            procs = []
        mix(run.traffic["kind"]).check(run, st)
        out = line(run, own, run.worker_results)
    finally:
        stop_workers(procs)
        if tmp is not None:
            tmp.cleanup()
    for k, c in run.compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}"
              f"{' (at least)' if c['at_least'] else ''}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
