"""Time K6 (the collapsed chain) of this checkout and another's in turns, on
the card, or trace where the cluster K6's step goes.

    python3 -m nv_wavenet_tpu_torch.tools.k6_ab OTHER_ROOT
    python3 -m nv_wavenet_tpu_torch.tools.k6_ab spec OTHER_ROOT
    python3 -m nv_wavenet_tpu_torch.tools.k6_ab trace

OTHER_ROOT is another checkout of this repo (for example the parent
commit, `git archive` unpacked into a directory that .gitignore lists).
Four processes run in turns: OTHER, this, this, OTHER.  Each imports its
own tree's `nv_wavenet_tpu_torch`, builds that tree's kernels into that
tree's `build/`, and times, through `ops.fused_chain.make_fused_generator`
(an entry point both trees have, mode "sample", the dil_b prefold), one
256-step launch at the flagship (20 layers, R=64, S=256, A=256,
max_dilation 512, random weights from seed 1) at B=16 and b=1, in each
precision (exact, fast_math, compute_dtype=bf16), pack_gates off and on;
then at WIDE, the flagship at B=32 and config 4 (40 layers, R=128, S=256,
A=256, max_dilation 128) at B=64, pack_gates off.  Where this tree's
generator takes `route=`, each geometry is also timed on the first K6
(key suffix " first"), so the cluster K6 and the first K6 are compared in
one process.  Each time is the mean of REPS launches by CUDA events after a
warm-up; inputs are drawn on the card from fixed seeds.  K6 is held to its plain
version within tolerance, not bit for bit, so the trees' outputs are not
compared here (chip_smoke.py phases 19-22 hold them).  Each turn prints
one JSON line; the last line is a JSON summary with the times in turn
order and the route each tree's generator names.

`spec` times speculative decode's rounds in the same turns: on an engine
at the flagship (fp32 weights, seed 1), b=1, SPEC_T samples, `run()`'s
step (E0) and `run_speculative` fixed at each window of SPEC_WINDOWS
(microseconds a round, the rounds), with the least-squares line V0 + V1 K
through the rounds; and the draft alone, K6 at b=1 under fast_math over a
K-step launch by CUDA events, with its own line.  A round less its draft
is the verify pass, the commit and the host's read-back.

`trace` builds `csrc/fused_chain.cu` with -DNVW_K6_TRACE (clock64 stamps on
CTA 0's thread 0 at the phases of a launch's second step) into a library
of its own, runs the flagship launch at B=16 and b=1 in exact and fast
through it, and prints where the step's cycles go: the FIFO reads,
x_{t-d} Wprev, the wait for y, the embedding, x_0 Wcur, then per layer the
cluster wait, the chain's product h_{l-1} G_{l-1,l}, the gate with its
exchange, and the off-chain products with the residual write (summed over
the layers), then the output stack's phases and the sampler.  The stamps
cost a store each (a few per layer).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

T, REPS = 256, 3
BATCHES = (16, 1)
# (label, config, B): the wider geometries, pack_gates off
WIDE = (("flagship", None, 32),
        ("config 4", dict(num_layers=40, R=128, S=256, A=256,
                          max_dilation=128), 64))
SPEC_T, SPEC_WINDOWS, SPEC_REPS = 2048, (64, 128, 256), 3
TURNS = ("other", "this", "this", "other")
PRECISIONS = ("exact", "fast", "bf16")
HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _setup(root: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import nv_wavenet_tpu_torch
    if not os.path.abspath(nv_wavenet_tpu_torch.__file__).startswith(
            root + os.sep):
        raise RuntimeError(f"imported {nv_wavenet_tpu_torch.__file__}, not "
                           f"the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def _inputs(torch, cfg, params_lib, B: int):
    dev = torch.device("cuda")
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=1), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(600 + B)
    cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                      device=dev) - 0.5
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    sel = torch.rand((T, B), generator=g, device=dev)
    return params, cond_pre, sel


def _time_ms(torch, gen, w, cond, sel, state) -> float:
    """Mean ms of REPS launches of gen by CUDA events, after a warm-up."""
    gen(w, 0, cond, sel, *state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        gen(w, 0, cond, sel, *state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def one_turn(root: str) -> dict:
    """Every K6 time on the tree at `root`, in this process."""
    torch = _setup(root)
    import inspect
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import fused_chain, persistent
    from nv_wavenet_tpu_torch.ops import scan_generate
    dev = torch.device("cuda")
    flagship = cfg_lib.FLAGSHIP_CONFIG
    kw = {"exact": {}, "fast": {"fast_math": True},
          "bf16": {"compute_dtype": torch.bfloat16}}
    routed = "route" in inspect.signature(
        fused_chain.make_fused_generator).parameters
    cases = [(f"B={B}", flagship, B, pack) for B in BATCHES
             for pack in (False, True)]
    cases += [(f"{label} B={B}", cfg_lib.WaveNetConfig(**g) if g else
               flagship, B, False) for label, g, B in WIDE]
    ms, routes = {}, {}
    for label, cfg, B, pack in cases:
        params, cond_pre, sel = _inputs(torch, cfg, params_lib, B)
        for prec in PRECISIONS:
            w = fused_chain.prepare_weights(params, cfg, True,
                                            pack_gates=pack, **kw[prec])
            gens = {"": fused_chain.make_fused_generator(
                cfg, B, prefold_cond=True, pack_gates=pack, **kw[prec])}
            if routed and gens[""].route.kernel != "first":
                gens[" first"] = fused_chain.make_fused_generator(
                    cfg, B, prefold_cond=True, pack_gates=pack,
                    route=fused_chain.FusedRoute(
                        "first", fused_chain.fused_plan(cfg, pack),
                        "timed beside the cluster K6"), **kw[prec])
            for suffix, gen in gens.items():
                state = (persistent.init_ring(cfg, B, dev,
                                              scan_generate.ring_dtype(prec)),
                         torch.full((2, B), cfg.silence_bin,
                                    dtype=torch.int32, device=dev))
                key = (f"{label} {prec} pack={pack}" if label.startswith("B=")
                       else f"{label} {prec}") + suffix
                ms[key] = _time_ms(torch, gen, w, cond_pre, sel, state)
                route = getattr(gen, "route", None)
                routes[key] = route.kernel if route is not None else "first"
    return {"card": _card(torch), "ms": ms, "routes": routes, "steps": T}


def spec_turn(root: str) -> dict:
    """Speculative decode's rounds and its draft on the tree at `root`."""
    torch = _setup(root)
    import numpy as np
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import fused_chain, persistent
    dev = torch.device("cuda")
    cfg = cfg_lib.FLAGSHIP_CONFIG
    L, R, B = cfg.num_layers, cfg.R, 16
    eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                       S=cfg.S, A=cfg.A, max_batch=B, chunk_size=256,
                       device="cuda")
    eng.set_reference_weights(params_lib.random_reference_weights(cfg,
                                                                  seed=1))
    g = torch.Generator(device=dev)
    g.manual_seed(700)
    cond = torch.rand((SPEC_T, L, B, 2 * R), generator=g, device=dev) - 0.5
    sel = torch.rand((SPEC_T, B), generator=g, device=dev)
    eng.set_inputs(cond, sel)
    eng.run(SPEC_T, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run(SPEC_T, 1)
    torch.cuda.synchronize()
    e0 = (time.perf_counter() - t) / SPEC_T * 1e6
    draft = fused_chain.make_fused_generator(cfg, 1, fast_math=True)
    folded = fused_chain.prepare_weights(eng._value_params(), cfg, False,
                                         fast_math=True)
    cond1 = cond[:, :, :1].contiguous()
    sel1 = sel[:, :1].contiguous()
    rows = []
    for K in SPEC_WINDOWS:
        eng.run_speculative(SPEC_T, 1, window=K, adaptive=False)
        times = []
        for _ in range(SPEC_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.run_speculative(SPEC_T, 1, window=K, adaptive=False)
            times.append(time.perf_counter() - t)
        rounds = eng.spec_rounds
        state = (persistent.init_ring(cfg, 1, dev),
                 torch.full((2, 1), cfg.silence_bin, dtype=torch.int32,
                            device=dev))
        c_k, s_k = cond1[:K].contiguous(), sel1[:K].contiguous()
        draft(folded, 0, c_k, s_k, *state)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SPEC_REPS):
            draft(folded, 0, c_k, s_k, *state)
        end.record()
        torch.cuda.synchronize()
        rows.append({"window": K, "rounds": rounds,
                     "round_us": [x / rounds * 1e6 for x in times],
                     "draft_us": start.elapsed_time(end) / SPEC_REPS * 1e3})
    ks = [r["window"] for r in rows]
    v1, v0 = np.polyfit(ks, [float(np.mean(r["round_us"])) for r in rows], 1)
    d1, d0 = np.polyfit(ks, [r["draft_us"] for r in rows], 1)
    return {"card": _card(torch), "E0_us": e0, "rows": rows,
            "round_fit": {"V0_us": float(v0), "V1_us": float(v1)},
            "draft_fit": {"V0_us": float(d0), "V1_us": float(d1)}}


def _card(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(0)


def trace() -> dict:
    """The cluster K6's step by phase, from a -DNVW_TRACE build."""
    torch = _setup(HERE_ROOT)
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import fused_chain, persistent
    from nv_wavenet_tpu_torch.ops import scan_generate
    from nv_wavenet_tpu_torch.utils import build
    dev = torch.device("cuda")
    cfg = cfg_lib.FLAGSHIP_CONFIG
    L = cfg.num_layers
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    out = {"card": _card(torch), "cases": {}}
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        procs = {prec: subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, f"-DNVW_PREC={pid}",
             "-DNVW_K6_TRACE", "-o",
             os.path.join(tmp, f"libfused_chain_trace_{prec}.so"),
             os.path.join(build.CSRC_DIR, "fused_chain.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for prec, pid in (("exact", 0), ("fast", 1))}
        libs = {}
        for prec, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the trace build:\n{log}")
            libs[prec] = ctypes.CDLL(
                os.path.join(tmp, f"libfused_chain_trace_{prec}.so"))
        for B in BATCHES:
            params, cond_pre, sel = _inputs(torch, cfg, params_lib, B)
            for prec, kw in (("exact", {}), ("fast", {"fast_math": True})):
                key = ("injected", prec)
                traced = fused_chain.FUSED_KERNELS[key]
                fn = getattr(libs[prec], traced.symbol)
                fn.argtypes, fn.restype = traced.argtypes, ctypes.c_int
                reader = libs[prec].nvw_trace_read
                reader.argtypes = [ctypes.c_void_p]
                gen = fused_chain.make_fused_generator(
                    cfg, B, prefold_cond=True, **kw)
                w = fused_chain.prepare_weights(params, cfg, True, **kw)
                state = (persistent.init_ring(cfg, B, dev,
                                              scan_generate.ring_dtype(prec)),
                         torch.full((2, B), cfg.silence_bin,
                                    dtype=torch.int32, device=dev))
                libs[prec].nvw_error_string.argtypes = [ctypes.c_int]
                libs[prec].nvw_error_string.restype = ctypes.c_char_p
                saved = traced._fn, traced._lib
                traced._fn, traced._lib = fn, libs[prec]
                try:
                    gen(w, 0, cond_pre, sel, *state)   # builds the stream
                    torch.cuda.synchronize()
                    stamps = (ctypes.c_longlong * 256)()
                    reader(ctypes.addressof(stamps))   # and zeroes them
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    gen(w, 0, cond_pre, sel, *state)
                    end.record()
                    torch.cuda.synchronize()
                finally:
                    traced._fn, traced._lib = saved
                stamps = (ctypes.c_longlong * 256)()
                if reader(ctypes.addressof(stamps)):
                    raise RuntimeError("nvw_trace_read failed")
                s = list(stamps)
                step_cycles = s[207] - s[0]
                us = start.elapsed_time(end) * 1e3 / T
                phases = {"fifo reads": s[1] - s[0],
                          "x_{t-d} Wprev": s[2] - s[1],
                          "wait for y": s[3] - s[2],
                          "embedding": s[4] - s[3],
                          "x_0 Wcur": s[5] - s[4],
                          "base, layer 0 gate + exchange": s[10] - s[5]}
                chain = {"cluster wait": 0, "chain product": 0,
                         "gate + exchange": 0, "off-chain products": 0}
                last = s[10]
                for l in range(1, L):
                    chain["cluster wait"] += s[8 + 4 * l] - last
                    chain["chain product"] += s[9 + 4 * l] - s[8 + 4 * l]
                    chain["gate + exchange"] += s[10 + 4 * l] - s[9 + 4 * l]
                    chain["off-chain products"] += (s[11 + 4 * l]
                                                    - s[10 + 4 * l])
                    last = s[11 + 4 * l]
                phases.update({f"layers 1..{L - 1}: {k}": v
                               for k, v in chain.items()})
                phases.update({"last wait": s[200] - last,
                               "h_{L-1} Wskip": s[201] - s[200],
                               "skip exchange": s[202] - s[201],
                               "zs product": s[203] - s[202],
                               "zs exchange": s[204] - s[203],
                               "za product": s[205] - s[204],
                               "za exchange": s[206] - s[205],
                               "sampler": s[207] - s[206]})
                phases.update({"copy ring, the issuing lane: issuing": s[220],
                               "copy ring, thread 0: waiting for chunks":
                                   s[221],
                               "copy ring, thread 0: chunk products": s[222],
                               "copy ring, thread 0: barrier after a chunk":
                                   s[223]})
                mhz = step_cycles / us if us else 0.0
                out["cases"][f"B={B} {prec}"] = {
                    "us_per_step_traced_launch": us,
                    "step_cycles": step_cycles,
                    "cycles_per_us": mhz,
                    "phases_us": {k: v / mhz if mhz else None
                                  for k, v in phases.items()},
                    "phases_share": {k: v / step_cycles
                                     for k, v in phases.items()}}
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--turn":
        turn = spec_turn if argv[1] == "spec" else one_turn
        print(json.dumps(turn(argv[2])), flush=True)
        return 0
    if argv == ["trace"]:
        print(json.dumps({"k6_trace": trace()}), flush=True)
        return 0
    spec = len(argv) == 2 and argv[0] == "spec"
    if len(argv) != 1 and not spec:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"other": os.path.abspath(argv[-1]), "this": HERE_ROOT}
    turns = []
    for which in TURNS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             "spec" if spec else "k6", roots[which]], capture_output=True,
            text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0 or not proc.stdout.strip():
            print(f"k6_ab: the {which} turn failed (rc {proc.returncode})",
                  file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=which, turn_s=time.perf_counter() - t)
        print(json.dumps(res), flush=True)
        turns.append(res)
    if spec:
        print(json.dumps({"k6_ab_spec": {
            "turns": list(TURNS), "card": turns[0]["card"],
            "E0_us": [r["E0_us"] for r in turns],
            "round_fit": [r["round_fit"] for r in turns],
            "draft_fit": [r["draft_fit"] for r in turns]}}), flush=True)
        return 0
    summary = {"turns": list(TURNS), "card": turns[0]["card"],
               "ms": {k: [r["ms"][k] for r in turns] for k in turns[0]["ms"]},
               "routes": {w: r["routes"] for w, r in zip(TURNS, turns)}}
    print(json.dumps({"k6_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
