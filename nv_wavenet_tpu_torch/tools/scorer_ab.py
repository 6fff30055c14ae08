"""Time the scorer's kernels of this checkout and another's in turns, on
the card.

    python3 -m nv_wavenet_tpu_torch.tools.scorer_ab OTHER_ROOT

OTHER_ROOT is another checkout of this repo (for example the parent
commit, `git archive` unpacked into a directory that .gitignore lists).
Four processes run in turns: OTHER, this, this, OTHER.  Each imports its
own tree's `nv_wavenet_tpu_torch`, builds that tree's kernels into that
tree's `build/`, and times, through entry points both trees have:

- K7's product, `ops.ordered_matmul.ordered_matmul`, at the scorer's
  products (K, N) = (64, 128), (64, 320) and (256, 256), with 131072 rows
  (the flagship's 16 x 8192 window) and 4096 (a verify);
- K0c, `ops.exact_math.softmax_canonical`, at za [4096, 256] and
  [131072, 256];
- K0a, `ops.exact_math.exact_fn`, exp, tanh and sigmoid over 450,020
  floats (the JAX probe's count) and over the scorer's embedding [131072,
  64], by device time (GRAPH_LAUNCHES launches captured in one CUDA graph,
  before any profiler session), beside torch.exp / tanh / sigmoid;
- one scorer pass, `WaveNetInfer.score_device`, at the flagship over the
  16 x 8192 window from silence: its time by CUDA events and its device
  time by kernel group (`scorer_split`).

Inputs are drawn on the card from fixed seeds, so both trees see the same
ones; the bits of every output are hashed and the two trees must agree
(the contract: the products' order and the scorer's p_seq are fixed).
Each turn prints one JSON line; the last line is a JSON summary with the
times in turn order.  Exits 1 if the trees' outputs differ or a turn fails.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

WINDOW_M, VERIFY_M = 16 * 8192, 4096
PRODUCTS = tuple((M, K, N) for M in (WINDOW_M, VERIFY_M)
                 for K, N in ((64, 128), (64, 320), (256, 256)))
SOFTMAX_ROWS = (VERIFY_M, WINDOW_M)
K0A_SHAPES = ((450020,), (WINDOW_M, 64))
K0A_FNS = ("exp", "tanh", "sigmoid")
GRAPH_LAUNCHES = 100
SCORER_B, SCORER_T = 16, 8192
TURNS = ("other", "this", "this", "other")
# profiler sessions tried before giving up: the first sessions of a process
# have come back without a single device event on the H100
PROFILE_TRIES = 3
HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def time_ms(torch, fn, reps: int) -> float:
    """Mean time of one call of fn over reps back-to-back calls, after a
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, n: int = GRAPH_LAUNCHES) -> float:
    """Device time of one call of fn: n calls captured in one CUDA graph,
    replayed once after a warm-up replay, by CUDA events over n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of the kernels of one call of fn (torch.profiler's
    kernel durations over reps calls, after a warm-up call): the launch
    gaps that bind the small shapes left out.  A session that saw no device
    event is taken again, at most PROFILE_TRIES times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
        if total > 0:
            return total / 1e3 / reps
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{PROFILE_TRIES} sessions")


def kernel_group(name: str) -> str:
    """The scorer-split group of a device kernel's (demangled or mangled)
    name: K7's entries by the mode, its last template argument."""
    if "ordered_kernel" in name:
        m = (re.search(r"ordered_kernel<(?:\d+, ){4}(\d)>", name)
             or re.search(r"ordered_kernelI(?:Li\d+E){4}Li(\d)E", name))
        mode = m.group(1) if m else "0"
        return {"1": "K7 gate", "2": "K7 res/skip"}.get(mode, "K7 product")
    if "ordered_matmul_kernel" in name:   # K7 of one tile shape
        return "K7 product"
    if "exact_fn_kernel" in name:
        return "K0a"
    if "softmax_p" in name:
        return "K0c"
    return "torch (elementwise, gathers, copies)"


def scorer_split(torch, trace, eng, cond, y, B: int, path: str) -> dict:
    """One scorer pass (`eng.score_device(cond, y)` from silence, after a
    warm-up pass) traced with `trace` (`utils/tracing.trace`; in a tree
    older than that module, `utils/profiling.trace`): device time
    by kernel group (`kernel_group`), launches and shares; the Chrome trace
    goes to `path`.  A trace without a device event is taken again, and
    after PROFILE_TRIES such traces it raises."""
    eng.begin_stream(B)
    eng.score_device(cond, y)
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        out = {"groups_ms": {}, "launches": {},
               "method": "torch.profiler (device time by kernel)"}
        eng.begin_stream(B)
        with trace(path) as prof:
            eng.score_device(cond, y)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if not str(evt.device_type).endswith("CUDA"):
                continue
            t = getattr(evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0))
            if t <= 0:
                continue
            g = kernel_group(evt.key)
            out["groups_ms"][g] = out["groups_ms"].get(g, 0.0) + t / 1e3
            out["launches"][g] = out["launches"].get(g, 0) + evt.count
        total = sum(out["groups_ms"].values())
        if total > 0:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded no device time in the "
                           f"scorer pass in {PROFILE_TRIES} traces")
    out["total_ms"] = total
    out["shares"] = {g: v / total for g, v in out["groups_ms"].items()}
    return out


def digest(t) -> str:
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def one_turn(root: str) -> dict:
    """Every measurement on the tree at `root`, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import nv_wavenet_tpu_torch
    if not os.path.abspath(nv_wavenet_tpu_torch.__file__).startswith(
            root + os.sep):
        raise RuntimeError(f"imported {nv_wavenet_tpu_torch.__file__}, not "
                           f"the package under {root}")
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import exact_math as em
    from nv_wavenet_tpu_torch.ops import ordered_matmul as om
    from nv_wavenet_tpu_torch.utils import profiling
    try:
        from nv_wavenet_tpu_torch.utils.tracing import trace
    except ImportError:   # a tree older than the tracing module
        trace = profiling.trace
    dev = torch.device("cuda")
    out = {"root": root, "card": profiling.card(), "products": [],
           "softmax": [], "k0a": [], "hashes": {}}

    def gen(seed: int):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    # K0a first: graph replays before any profiler session attaches CUPTI
    for i, shape in enumerate(K0A_SHAPES):
        x = torch.rand(shape, generator=gen(400 + i), device=dev) * 16 - 8
        for name in K0A_FNS:
            label = f"exact_fn {name} {'x'.join(map(str, shape))}"
            out["hashes"][label] = digest(em.exact_fn(name, x))
            out["k0a"].append({
                "fn": name, "shape": list(shape),
                "device_ms": graph_ms(
                    torch, functools.partial(em.exact_fn, name, x)),
                "torch_device_ms": graph_ms(
                    torch, functools.partial(getattr(torch, name), x))})

    for i, (M, K, N) in enumerate(PRODUCTS):
        g = gen(100 + i)
        x = torch.rand((M, K), generator=g, device=dev) - 0.5
        w = torch.rand((K, N), generator=g, device=dev) - 0.5
        out["hashes"][f"ordered_matmul {M}x{K}x{N}"] = digest(
            om.ordered_matmul(x, w))
        f = functools.partial(om.ordered_matmul, x, w)
        dms = device_ms(torch, f)
        out["products"].append({"shape": [M, K, N],
                                "ms": time_ms(torch, f, 20), "device_ms": dms,
                                "tflops": 2 * M * K * N / dms / 1e9})
    for i, rows in enumerate(SOFTMAX_ROWS):
        za = torch.rand((rows, 256), generator=gen(200 + i), device=dev
                        ) * 16 - 8
        out["hashes"][f"softmax_canonical {rows}x256"] = digest(
            em.softmax_canonical(za))
        f = functools.partial(em.softmax_canonical, za)
        out["softmax"].append({"shape": [rows, 256],
                               "ms": time_ms(torch, f, 50),
                               "device_ms": device_ms(torch, f)})

    cfg = cfg_lib.FLAGSHIP_CONFIG
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=SCORER_B, chunk_size=256,
                       device="cuda")
    eng.set_reference_weights(params_lib.random_reference_weights(cfg,
                                                                  seed=1))
    g = gen(300)
    cond = (torch.rand((SCORER_T, cfg.num_layers, SCORER_B, 2 * cfg.R),
                       generator=g, device=dev) - 0.5)
    y = torch.randint(0, cfg.A, (SCORER_T, SCORER_B), generator=g,
                      device=dev, dtype=torch.int32)
    eng.begin_stream(SCORER_B)
    out["hashes"]["score_device p_seq"] = digest(eng.score_device(cond, y))
    times = []
    for _ in range(3):
        eng.begin_stream(SCORER_B)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.score_device(cond, y)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["scorer_ms"] = sum(times) / len(times)
    out["scorer_split"] = scorer_split(
        torch, trace, eng, cond, y, SCORER_B,
        os.path.join(HERE_ROOT, "build", "traces",
                     f"scorer_ab_{os.path.basename(root) or 'root'}.json"))
    return out


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
            print(f"scorer_ab: the {which} turn failed "
                  f"(rc {proc.returncode})", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=which, turn_s=time.perf_counter() - t)
        print(json.dumps(res), flush=True)
        turns.append(res)
    differ = sorted(k for k in turns[0]["hashes"]
                    if len({r["hashes"].get(k) for r in turns}) != 1)
    summary = {
        "turns": list(TURNS), "card": turns[0]["card"],
        "products_ms": {str(p["shape"]): [r["products"][i]["ms"]
                                          for r in turns]
                        for i, p in enumerate(turns[0]["products"])},
        "products_device_ms": {str(p["shape"]): [
            r["products"][i]["device_ms"] for r in turns]
            for i, p in enumerate(turns[0]["products"])},
        "softmax_device_ms": {str(s["shape"]): [
            r["softmax"][i]["device_ms"] for r in turns]
            for i, s in enumerate(turns[0]["softmax"])},
        "k0a_device_ms": {f"{k['fn']} {k['shape']}": [
            r["k0a"][i]["device_ms"] for r in turns]
            for i, k in enumerate(turns[0]["k0a"])},
        "k0a_torch_device_ms": {f"{k['fn']} {k['shape']}": [
            r["k0a"][i]["torch_device_ms"] for r in turns]
            for i, k in enumerate(turns[0]["k0a"])},
        "scorer_ms": [r["scorer_ms"] for r in turns],
        "scorer_device_ms": [r["scorer_split"]["total_ms"] for r in turns],
        "outputs_that_differ": differ}
    print(json.dumps({"scorer_ab": summary}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
