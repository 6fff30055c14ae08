#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`nv_wavenet_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `nv_wavenet_tpu_torch/csrc/` with
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's paths at full width, the flagship geometry (20 layers,
R=64, S=256, A=256, max_dilation 512, fp32, batch 16, random weights from
seed 1): the main path serving 3 requests of 8192 samples through
`WaveNetInfer.set_inputs` + `run_chunks`; the streaming serving path, 16
slots fed tick by tick through `begin_stream` / `feed(lengths=...)` /
`reset_utterances` / `export_state` + `import_state`; the scoring path,
`WaveNetInfer.score` and `scoring.*` over the first request's audio; and a
request in mode "prng".  Phases, in order; any failure exits non-zero:

  1. device: card name and power limit (nvidia-smi), torch.version.cuda, nvcc
  2. build: every csrc/*.cu, timed
  3. K0a (elementwise exact exp/tanh/sigmoid) vs plain: 0 bit mismatches on
     the dense sweep of tests/test_exact_math.py
  4. K0b (canonical sampler) vs plain: 0 mismatches on za [4096, 256]; K0c
     (canonical softmax) vs plain on the same za: 0 bit mismatches; K7 (the
     scorer's fixed-order product) vs plain at the scorer's flagship shapes
     with 4096 rows: 0 bit mismatches, timed beside torch.matmul
  5. K1 (persistent generation) vs plain, TEST_CONFIG_MED, B=4, T=64, sample
     and argmax modes with the dump: exact y, activations within the
     reference ladder; 7+7+...+1 chunked run_partial calls equal one call;
     then the 65,536-draw horizon case of tests/test_torch_generate.py (4
     layers, R=32, B=16, T=4096), K1 on the card in chunks of 256 against
     the plain version on the CPU in one call: 0 integer mismatches (the CPU
     test holds that plain version to the golden model with 0 too).  K2
     (forced) vs plain on the same config, forcing K1's samples, with and
     without the dump: y echoes the symbols, p_seq within 1e-6, the ring
     within the xt ladder (the plain version uses cuBLAS: not bitwise);
     K3 (prng) through run(mode="prng") vs the plain version fed
     prng_uniform_sel's selectors: 0 mismatches; 7+7+...+1 run_partial
     calls equal one call; another seed gives another stream
  6. K5 (ragged generation, per-row clocks and lengths) vs plain,
     TEST_CONFIG_MED, B=4: 6 seeded ticks of lengths in [0, 16] (one tick
     with every length 0, one with one row at 0) through an engine on the
     card and through the plain ragged generator on the card: 0 integer
     mismatches, equal y_state and clocks, the ring within the xt ladder
  7. main path: kernel launch counts set to 0 just before and read just
     after; K1 must have launched; the first 256 samples of request 1 must
     equal the plain version's on the card (0 integer mismatches); the
     lockstep K1's time per step
  8. serving: counts set to 0 just before and read just after; 192 ticks of
     at most 160 samples over 16 slots, per-row lengths from {0} and
     [40, 160], utterances of [2048, 8192] samples (conditioning and
     injected selectors drawn on the card from a seeded generator), a slot
     reset when its utterance ends; once every slot reset in one tick, 4
     lockstep ticks, then a partial reset (the R3 sequence); once, mid-run
     and desynced, the stream moves to a second engine by export_state ->
     import_state (the R7 sequence).  K1 and K5 must both have launched.
     Prints per-feed wall time p50/p99, samples served per second over the
     live rows, the dead row-step share and the launches
  9. correctness at full width: the first 16 utterances completed, replayed
     as one lockstep batch (set_inputs + run) on a fresh engine, equal what
     they were served (0 mismatches), among them one that crossed the
     migration and one that began at the full reset and ran through the
     partial reset; then K5 on one 160-step ragged tick of the scenario,
     timed, and on a 32-step tick against the plain version (0 mismatches)
 10. K2 and K3 at the flagship: vs plain over 32 steps of request 1 (K2
     forcing its samples), each timed over a 256-step launch
 11. scoring at full width: counts set to 0 just before and read just
     after; request 1's window (16 x 8192 samples) scored from silence by
     `WaveNetInfer.score` (the time-parallel scorer: K7, K0a, K0c) and by
     K2 on the same state and symbols: p_seq, the final ring and y_state
     bit-equal; both timed; `scoring.score_teacher_forced_kernel` (K2) and
     `score_teacher_forced_parallel` on the same audio, bits per sample
     within 1e-5
 12. handoff: request 1 fed in two halves equals its run; then the first
     half scored and the second fed: 0 mismatches, and the half-window
     p_seq equals the full window's first half bit for bit
 13. prng at full width: counts set to 0 just before and read just after;
     one request of 16 x 8192 samples through run_chunks(256, mode="prng"),
     its time per step beside K1's
 14. the `kernels` JSON line: per kernel its launches on its path (K5: the
     serving phase; K0a, K0c, K7, K2: the scoring phase; K3: the prng
     request), its time, the plain version's, the least time the card could
     take for the same work (bound_ms) and, where one PyTorch call computes
     the same function, that call's time

The last three lines of standard output are the kernels line, the card's
name and power limit, and {"ok": true, "device": {...}}.  Imports nothing of
jax or of the JAX package.  Exits non-zero, printing no result, when
torch.cuda.is_available() is false or the port is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth; the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the fp32 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# fp32 operations of one element of the canonical exact math
# (ops/exact_math.py, one op per line of the normative lowering)
EXP_OPS = 25            # clamp 2, k 3, r 4, r2 r4 2, pA 4, pB 2, pC 1, p 4, 2^k 2, scale 1
RECIP_OPS = 21          # e2 e4 e8 3, q0..q4 10, h0 h1 4, y 4
TANH_SMALL_OPS = 17     # |x| and branch 2, u u2 2, a b c 6, q 4, x + (x u) q 3
TANH_LARGE_OPS = 53     # |x| and branch 2, -2|x| 1, exp, e2+e2 1, recip, 1 - . 2, sign 1
SIGMOID_OPS = 50        # -|x| 2, exp, recip, branch and e r 2
PHILOX_OPS = 103        # 10 rounds of 2 mul-hi, 2 mul-lo, 4 xor, 2 key adds; 3 to map

MAIN_B, MAIN_T, MAIN_CHUNK, MAIN_REQUESTS, CHECK_T = 16, 8192, 256, 3, 256
HORIZON_B, HORIZON_T, HORIZON_CHUNK = 16, 4096, 256
# K5 against its plain version: TEST_CONFIG_MED, 4 rows, 6 ticks of <= 16
K5_SMALL_B, K5_SMALL_TICKS, K5_SMALL_T = 4, 6, 16
# the serving phase: 16 slots, 192 ticks of at most 160 samples (10 ms of
# 16 kHz audio); a row's tick takes 0 samples (a stalled frontend) with
# probability 1/8, else [40, 160]; utterances of [2048, 8192] samples
SERVE = dict(B=16, ticks=192, tick_t=160, len_min=40, p_stall=1 / 8,
             utt_min=2048, utt_max=8192,
             full_reset_tick=8, lockstep_ticks=4,      # the R3 sequence:
             partial_tick=16, partial_rows=(0, 1, 2, 3),  # full, then partial
             migrate_tick=40)                          # the R7 sequence
SERVE_REPLAY = 16   # the first utterances completed, replayed lockstep
K5_PLAIN_T = 32   # the plain step costs ~32 ms at the flagship
# K7 at the scorer's flagship products, (M, K, N): the dilated halves
# [x_{t-d} | x_t] W, the fused res/skip product, and the output stack
K7_SHAPES = ((4096, 64, 128), (4096, 64, 320), (4096, 256, 256))
PRNG_SEED = 3   # the sampling_seed of the prng request


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def rel_close(a, b, tol, atol=None) -> bool:
    """The reference ladder's two-sided relative check with an absolute
    floor (tests/test_golden_vs_scan.py::rel_close)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = tol * 1e-2 if atol is None else atol
    return bool(np.all(np.abs(b - a) <= tol * np.abs(a) + atol))


def dense_sweep():
    """The dense input sweep of tests/test_exact_math.py, from its seed."""
    import numpy as np
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-95, 95, 200000),
        rng.uniform(-8, 8, 100000),
        rng.uniform(-0.6, 0.6, 100000),
        rng.uniform(-0.01, 0.01, 50000),
        np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, np.nextafter(0.5, 0.0),
                  np.nextafter(0.5, 1.0), 87.9, -86.9, -87.0, 88.0, 200.0,
                  -200.0, 50.0, -50.0, 1e-20, -1e-20, 2e-38, -2e-38]),
    ]).astype(np.float32)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_ops_per_row_step(cfg) -> int:
    """Operations of one sample of one batch row: the matrix products (2 per
    multiply-add) plus the elementwise work of the canonical step."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    macs = L * (2 * R * 2 * R + R * (R + S)) + S * A + A * A
    gate = TANH_LARGE_OPS + SIGMOID_OPS + 1            # per gate channel
    elementwise = (R * (1 + TANH_LARGE_OPS)            # embedding + tanh
                   + L * (R * (4 + gate) + 2 * (R + S))  # z, gate, biases
                   + S + A                             # relu skip, relu zs
                   + A * (2 + EXP_OPS + A.bit_length() - 1 + 2))  # sampler
    return 2 * macs + elementwise


def k1_bytes(cfg, B: int, T: int, live: int | None = None) -> int:
    """Each input read once, each output written once: weights, cond_pre
    and selectors of the row-steps that run (`live`, default all T * B),
    the FIFO ring and y_state in and out, y."""
    L, R = cfg.num_layers, cfg.R
    live = T * B if live is None else live
    return 4 * (cfg.param_count() + live * L * 2 * R + live
                + 2 * cfg.ring_size * B * R + 2 * 2 * B + T * B)


def k5_bytes(cfg, B: int, T: int, live: int) -> int:
    """K1's count over the live row-steps, plus the per-row clocks (int64)
    and lengths (int32)."""
    return k1_bytes(cfg, B, T, live) + 12 * B


def serve_scenario(torch, np, make_engine, cfg, dev, rng, gen, B, ticks,
                   tick_t, len_min, p_stall, utt_min, utt_max,
                   full_reset_tick, lockstep_ticks, partial_tick,
                   partial_rows, migrate_tick):
    """Serve utterances in B slots of one streaming engine, tick by tick.

    Each utterance has a length from [utt_min, utt_max] and its own
    conditioning and injected selectors, drawn on `dev` from `gen`.  A
    ragged tick gives each row 0 samples (probability p_stall) or
    [len_min, tick_t], at most what its utterance has left, through
    `feed(lengths=...)`.  A row whose utterance ended is handed to the next
    one by `reset_utterances`.  Before tick `full_reset_tick` every slot is
    reset (its utterance abandoned) and the next `lockstep_ticks` ticks feed
    tick_t samples to every row without lengths (the lockstep path, K1);
    before `partial_tick` the rows `partial_rows` are reset (the R3
    sequence).  Before `migrate_tick` the stream moves to a second engine
    through `export_state` -> `import_state` (the R7 sequence).  The
    schedule depends on `rng` alone, never on the samples.

    Returns (utterances in order of completion, stats)."""
    L, C = cfg.num_layers, 2 * cfg.R
    utts, live = [], [None] * B

    def start(row, tick):
        n = int(rng.randint(utt_min, utt_max + 1))
        u = {"n": n, "row": row, "start": tick, "pos": 0, "out": [],
             "end": None, "migrated": False,
             "cond": torch.rand((n, L, C), generator=gen, device=dev) - 0.5,
             "sel": torch.rand((n,), generator=gen, device=dev)}
        utts.append(u)
        live[row] = u

    eng = make_engine()
    eng.begin_stream(B)
    for b in range(B):
        start(b, 0)
    feed_ms, served, steps, dead, lock_ticks = [], 0, 0, 0, 0
    tick_of_160 = None
    for tick in range(ticks):
        done = [b for b, u in enumerate(live) if u["pos"] == u["n"]]
        forced = (range(B) if tick == full_reset_tick
                  else partial_rows if tick == partial_tick else ())
        rows = sorted(set(done) | set(forced))
        if rows:
            eng.reset_utterances(rows)
            for b in rows:
                if live[b]["pos"] == live[b]["n"]:
                    live[b]["end"] = tick
                start(b, tick)
        if tick == migrate_tick:
            snap = eng.export_state()
            if len(set(snap["stream_t_row"].tolist())) < 2:
                raise RuntimeError("migration: the rows are not desynced")
            eng = make_engine()
            eng.import_state(snap)
            for u in live:
                u["migrated"] = True
        lockstep = full_reset_tick <= tick < full_reset_tick + lockstep_ticks
        if lockstep:
            lens = np.full(B, tick_t)
            if any(u["n"] - u["pos"] < tick_t for u in live):
                raise RuntimeError("lockstep tick past an utterance's end")
        else:
            draw = np.where(rng.rand(B) < p_stall, 0,
                            rng.randint(len_min, tick_t + 1, size=B))
            lens = np.minimum(draw, [u["n"] - u["pos"] for u in live])
        tm = int(lens.max())
        cond = torch.zeros((tm, L, B, C), device=dev)
        sel = torch.zeros((tm, B), device=dev)
        for b, u in enumerate(live):
            n, p = int(lens[b]), u["pos"]
            cond[:n, :, b] = u["cond"][p:p + n]
            sel[:n, b] = u["sel"][p:p + n]
        if tm == tick_t and not lockstep and tick_of_160 is None:
            tick_of_160 = (lens.copy(),
                           eng.export_state()["stream_t_row"].copy())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        y = (eng.feed(cond, sel) if lockstep
             else eng.feed(cond, sel, lengths=lens))
        dt = time.perf_counter() - t
        if y.shape != (B, tm) or (tm and (y.min() < 0 or y.max() >= cfg.A)):
            raise RuntimeError(f"tick {tick}: malformed y {y.shape}")
        if tm:
            feed_ms.append(dt * 1e3)
        lock_ticks += lockstep
        served += int(lens.sum())
        steps += tm * B
        dead += int(tm * B - lens.sum())
        for b, u in enumerate(live):
            u["out"].append(y[b, :lens[b]])
            u["pos"] += int(lens[b])
    for u in live:
        if u["pos"] == u["n"]:
            u["end"] = ticks
    completed = sorted((u for u in utts if u["end"] is not None),
                       key=lambda u: (u["end"], u["row"]))
    stats = {"ticks": ticks, "lockstep_ticks": lock_ticks,
             "feed_ms": feed_ms, "samples_served": served,
             "row_steps": steps, "dead_row_steps": dead,
             "utterances_started": len(utts),
             "utterances_completed": len(completed),
             "tick_of_160": tick_of_160}
    return completed, stats


def replay_lockstep(torch, np, make_engine, cfg, dev, utts):
    """Replay utterances as one lockstep batch (`set_inputs` + `run`, each
    conditioning padded to the longest) on a fresh engine; returns the
    integer mismatches of each against the samples it was served."""
    B, T = len(utts), max(u["n"] for u in utts)
    cond = torch.zeros((T, cfg.num_layers, B, 2 * cfg.R), device=dev)
    sel = torch.zeros((T, B), device=dev)
    for b, u in enumerate(utts):
        cond[:u["n"], :, b] = u["cond"]
        sel[:u["n"], b] = u["sel"]
    eng = make_engine()
    eng.set_inputs(cond, sel)
    y = eng.run(T, B)
    return [int((y[b, :u["n"]] != np.concatenate(u["out"])).sum())
            for b, u in enumerate(utts)]


def bit_mismatches(torch, a, b) -> int:
    """Elements of two float32 tensors (or arrays) whose bits differ."""
    a, b = (torch.as_tensor(x).contiguous() for x in (a, b))
    return int((a.view(torch.int32) != b.view(torch.int32).to(a.device))
               .sum())


def fresh_state(torch, persistent, cfg, B, dev):
    """Silence: a zero FIFO ring and y_state at the silence bin."""
    return (persistent.init_ring(cfg, B, dev),
            torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                       device=dev))


def time_launch_ms(torch, np, launch, make_state, reps: int = 4) -> float:
    """Mean device time of launch(ring, y_state) by CUDA events, each from a
    fresh state, after one warm-up launch."""
    times = []
    for _ in range(reps + 1):
        ring, ys = make_state()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(ring, ys)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times[1:]))


def check_k0c(torch, em, za) -> dict:
    """K0c against its plain version on the card and on the CPU (bit
    mismatches), and its time beside the plain version's and torch.softmax's
    at the same shape."""
    pk = em.softmax_canonical(za)
    pp = em.softmax_canonical_plain(za)
    torch.cuda.synchronize()
    rows, A = za.shape
    out = {"mismatches": bit_mismatches(torch, pk, pp),
           "cpu_plain_mismatches": bit_mismatches(
               torch, pk.cpu(), em.softmax_canonical_plain(za.cpu())),
           "max_abs_err": float((pk - pp).abs().max()),
           "ms": time_ms(torch, lambda: em.softmax_canonical(za), 50),
           "plain_ms": time_ms(torch, lambda: em.softmax_canonical_plain(za),
                               5),
           "library_ms": time_ms(torch, lambda: torch.softmax(za, -1), 50)}
    # max, subtract, exp, the fixed-tree prefix sum, divide
    out["bound_ms"], out["bound_by"] = bound_ms(
        8 * rows * A, rows * A * (3 + EXP_OPS + (A.bit_length() - 1)))
    return out


def check_k7(torch, om, dev, gen) -> dict:
    """K7 against its plain version at K7_SHAPES (bit mismatches), timed
    beside the plain version and torch.matmul; sums over the shapes."""
    out = {"mismatches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "library_ms": 0.0, "bound_ms": 0.0, "per_shape": []}
    by = set()
    for M, K, N in K7_SHAPES:
        x = torch.rand((M, K), generator=gen, device=dev) - 0.5
        w = torch.rand((K, N), generator=gen, device=dev) - 0.5
        yk = om.ordered_matmul(x, w)
        yp = om.ordered_matmul_plain(x, w)
        torch.cuda.synchronize()
        row = {"shape": [M, K, N], "mismatches": bit_mismatches(torch, yk, yp),
               "max_abs_err": float((yk - yp).abs().max()),
               "cublas_max_abs_diff": float((yk - x @ w).abs().max()),
               "ms": time_ms(torch, lambda: om.ordered_matmul(x, w), 20),
               "plain_ms": time_ms(torch, lambda: om.ordered_matmul_plain(
                   x, w), 3),
               "library_ms": time_ms(torch, lambda: torch.matmul(x, w), 20)}
        row["bound_ms"], b_by = bound_ms(4 * (M * K + K * N + M * N),
                                         2 * M * N * K)
        by.add(b_by)
        for k in ("mismatches", "ms", "plain_ms", "library_ms", "bound_ms"):
            out[k] += row[k]
        out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
        out["per_shape"].append(row)
    out["bound_by"] = "+".join(sorted(by))
    return out


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call of fn over reps back-to-back calls,
    after one warm-up call, by CUDA events."""
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


def main() -> int:
    import numpy as np
    import torch

    # -- phase 1: device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "nv_wavenet_tpu_torch")):
        fail("the nv_wavenet_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import exact_math as em
    from nv_wavenet_tpu_torch.ops import ordered_matmul as om
    from nv_wavenet_tpu_torch.ops import persistent, scoring
    from nv_wavenet_tpu_torch.ops import scan_generate as tsg
    from nv_wavenet_tpu_torch.utils import build

    # the plain versions' matrix products go to cuBLAS: full fp32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] nvcc {nvcc}: {nvcc_ver.splitlines()[-1]}")

    # -- phase 2: build -------------------------------------------------------
    t = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t:.2f} s "
        f"({' '.join(build.NVCC_FLAGS)}) -> {build.build_dir()}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {src}: {line.strip()}")

    # -- phase 3: K0a vs plain ------------------------------------------------
    x_np = dense_sweep()
    x = torch.from_numpy(x_np).to(dev)
    k0a = {"mismatches": 0, "max_abs_err": 0.0, "cpu_plain_mismatches": 0}
    for name in ("exp", "tanh", "sigmoid"):
        yk = em.exact_fn(name, x)
        yp = em.PLAIN_FNS[name](x)
        torch.cuda.synchronize()
        mism = int((yk.view(torch.int32) != yp.view(torch.int32)).sum())
        cpu = em.PLAIN_FNS[name](x.cpu())
        cpu_mism = int((yk.cpu().view(torch.int32)
                        != cpu.view(torch.int32)).sum())
        k0a["mismatches"] += mism
        k0a["cpu_plain_mismatches"] += cpu_mism
        k0a["max_abs_err"] = max(k0a["max_abs_err"],
                                 float((yk - yp).abs().max()))
        log(f"[K0a] {name}: {mism}/{x.numel()} bit mismatches vs plain on "
            f"the card, {cpu_mism} vs plain on the CPU")
    if k0a["mismatches"]:
        fail(f"K0a disagrees with its plain version: {k0a['mismatches']}")

    # -- phase 4: K0b vs plain ------------------------------------------------
    rng = np.random.RandomState(4)
    za = torch.from_numpy(rng.uniform(-8, 8, (4096, 256)).astype(np.float32)
                          ).to(dev)
    sel_za = torch.from_numpy(rng.uniform(0, 1, (4096, 1)).astype(np.float32)
                              ).to(dev)
    yk = em.sample_from_logits(za, sel_za, 128)
    yp = em.sample_from_logits_plain(za, sel_za, 128)
    torch.cuda.synchronize()
    k0b_mism = int((yk != yp).sum())
    k0b_cpu = int((yk.cpu() != em.sample_from_logits_plain(
        za.cpu(), sel_za.cpu(), 128)).sum())
    log(f"[K0b] {k0b_mism}/{yk.numel()} mismatches vs plain on the card, "
        f"{k0b_cpu} vs plain on the CPU")
    if k0b_mism:
        fail(f"K0b disagrees with its plain version: {k0b_mism}")

    # K0c on the same logits, K7 at the scorer's products
    k0c = check_k0c(torch, em, za)
    log(f"[K0c] {k0c['mismatches']}/{za.numel()} bit mismatches vs plain on "
        f"the card, {k0c['cpu_plain_mismatches']} vs plain on the CPU")
    if k0c["mismatches"]:
        fail(f"K0c disagrees with its plain version: {k0c['mismatches']}")
    gen_k7 = torch.Generator(device=dev)
    gen_k7.manual_seed(7)
    k7 = check_k7(torch, om, dev, gen_k7)
    for row in k7["per_shape"]:
        log(f"[K7] {row['shape']}: {row['mismatches']} bit mismatches vs "
            f"plain; vs cuBLAS max abs diff {row['cublas_max_abs_diff']:.3g};"
            f" {row['ms']:.4f} ms (torch.matmul {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f})")
    if k7["mismatches"]:
        fail(f"K7 disagrees with its plain version: {k7['mismatches']}")

    # -- phase 5: K1 vs plain, small config -----------------------------------
    cfg = cfg_lib.TEST_CONFIG_MED
    B, T = 4, 64
    ref_w = params_lib.random_reference_weights(cfg, seed=11)
    params = params_lib.canonical_to_torch(
        params_lib.to_canonical(ref_w, cfg), dev)
    rng = np.random.RandomState(1011)
    cond_np = (rng.uniform(-1, 1, (T, cfg.num_layers, B, 2 * cfg.R))
               .astype(np.float32) * 0.5)
    sel_np = rng.uniform(0, 1, (T, B)).astype(np.float32)
    cond = torch.from_numpy(cond_np).to(dev)
    sel = torch.from_numpy(sel_np).to(dev)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    ladder = (("xt", 1e-2, 3e-4), ("skip", 1e-2, 3e-4), ("zs", 1e-4, 2e-5),
              ("za", 1e-4, 2e-5), ("p", 1e-3, None))
    y_small = None
    for mode in ("sample", "argmax"):
        def fresh():
            return (persistent.init_ring(cfg, B, dev),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        gen = persistent.make_persistent_generator(cfg, B, mode=mode,
                                                   dump=True)
        out_k = gen(params, 0, cond_pre, sel, *fresh())
        out_p = persistent.generate_plain(cfg, params, 0, cond_pre, sel,
                                          *fresh(), T, mode=mode, dump=True)
        torch.cuda.synchronize()
        y_mism = int((out_k[0] != out_p[0]).sum())
        state_ok = torch.equal(out_k[2], out_p[2])
        ring_ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
        dumps_ok = all(rel_close(p.cpu(), k.cpu(), tol, atol)
                       for (_, tol, atol), k, p
                       in zip(ladder, out_k[3:], out_p[3:]))
        log(f"[K1 small] {mode}: y {y_mism}/{out_k[0].numel()} mismatches, "
            f"y_state equal {state_ok}, ring in ladder {ring_ok}, dumps in "
            f"ladder {dumps_ok}")
        if y_mism or not (state_ok and ring_ok and dumps_ok):
            fail(f"K1 disagrees with its plain version in mode {mode}")
        if mode == "sample":
            y_small = out_k[0].T.cpu().numpy()

    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=T, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    y_one = eng.run(T, B)
    parts = [eng.run_partial(t0, min(7, T - t0), B) for t0 in range(0, T, 7)]
    y_parts = np.concatenate(parts, axis=1)
    log(f"[K1 small] run == kernel: {np.array_equal(y_one, y_small)}; "
        f"{len(parts)} chunked run_partial calls == one run: "
        f"{np.array_equal(y_one, y_parts)}")
    if not (np.array_equal(y_one, y_small) and np.array_equal(y_one, y_parts)):
        fail("chunked run_partial calls differ from one call")

    # K2 against the plain version, forcing K1's samples
    def fresh_med():
        return fresh_state(torch, persistent, cfg, B, dev)
    sym = torch.from_numpy(np.ascontiguousarray(y_small.T, np.float32)).to(dev)
    out_p = persistent.generate_plain(cfg, params, 0, cond_pre, sym,
                                      *fresh_med(), T, mode="forced",
                                      dump=True)
    k2_small = {"echo_mismatches": 0, "p_err": 0.0}
    for dump in (False, True):
        gen = persistent.make_persistent_generator(cfg, B, mode="forced",
                                                   dump=dump)
        out_k = gen(params, 0, cond_pre, sym, *fresh_med())
        torch.cuda.synchronize()
        echo = int((out_k[0] != sym.to(torch.int32)).sum())
        p_err = float((out_k[-1] - out_p[-1]).abs().max())
        state_ok = torch.equal(out_k[2], out_p[2])
        ring_ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
        dumps_ok = not dump or all(
            rel_close(p.cpu(), k.cpu(), tol, atol) for (_, tol, atol), k, p
            in zip(ladder, out_k[3:8], out_p[3:8]))
        k2_small["echo_mismatches"] += echo
        k2_small["p_err"] = max(k2_small["p_err"], p_err)
        log(f"[K2 small] dump={dump}: y echoes the symbols with {echo} "
            f"mismatches; p_seq max abs err {p_err:.3g} (limit 1e-6); "
            f"y_state equal {state_ok}, ring in ladder {ring_ok}, dumps in "
            f"ladder {dumps_ok}")
        if echo or p_err > 1e-6 or not (state_ok and ring_ok and dumps_ok):
            fail(f"K2 disagrees with its plain version (dump={dump})")

    # K3 through the engine against the plain version fed Philox selectors
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=T, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.sampling_seed = PRNG_SEED
    eng.set_inputs(cond, sel)
    y3 = eng.run(T, B, mode="prng")
    sel3 = torch.from_numpy(tsg.prng_uniform_sel(PRNG_SEED, np.arange(T), B)
                            ).to(dev)
    y3p = persistent.generate_plain(cfg, params, 0, cond_pre, sel3,
                                    *fresh_med(), T)[0].T.cpu().numpy()
    parts = [eng.run_partial(t0, min(7, T - t0), B, mode="prng")
             for t0 in range(0, T, 7)]
    eng.sampling_seed = PRNG_SEED + 1
    y3_other = eng.run(T, B, mode="prng")
    k3_small = {"mismatches": int((y3 != y3p).sum()),
                "chunk_mismatches": int((np.concatenate(parts, 1) != y3).sum()),
                "seeds_differ": not np.array_equal(y3, y3_other)}
    log(f"[K3 small] run(mode='prng') vs plain fed prng_uniform_sel: "
        f"{k3_small['mismatches']}/{y3.size} mismatches; {len(parts)} chunked"
        f" run_partial calls vs one: {k3_small['chunk_mismatches']}; "
        f"another seed differs: {k3_small['seeds_differ']}")
    if (k3_small["mismatches"] or k3_small["chunk_mismatches"]
            or not k3_small["seeds_differ"]):
        fail("K3 disagrees with its plain version, or is not chunk "
             "invariant, or ignores its seed")

    # the horizon case, with the inputs of the CPU test from its seeds
    hcfg = cfg_lib.WaveNetConfig(num_layers=4, R=32, S=128, A=256,
                                 max_dilation=4)
    rng = np.random.RandomState(123)
    h_ref = params_lib.to_canonical(
        params_lib.random_reference_weights(hcfg, seed=321), hcfg)
    h_cond = rng.uniform(-0.5, 0.5, (HORIZON_T, hcfg.num_layers, HORIZON_B,
                                     2 * hcfg.R)).astype(np.float32)
    h_sel = rng.uniform(0, 1, (HORIZON_T, HORIZON_B)).astype(np.float32)
    h_y = {}
    for d in (dev, torch.device("cpu")):
        h_params = params_lib.canonical_to_torch(h_ref, d)
        cond_pre = (torch.from_numpy(h_cond).to(d)
                    + h_params["dil_b"][None, :, None, :]).contiguous()
        sel = torch.from_numpy(h_sel).to(d)
        ring = persistent.init_ring(hcfg, HORIZON_B, d)
        y_state = torch.full((2, HORIZON_B), hcfg.silence_bin,
                             dtype=torch.int32, device=d)
        if d.type == "cuda":
            gen = persistent.make_persistent_generator(hcfg, HORIZON_B)
            ys = [gen(h_params, t0, cond_pre[t0:t0 + HORIZON_CHUNK],
                      sel[t0:t0 + HORIZON_CHUNK], ring, y_state)[0]
                  for t0 in range(0, HORIZON_T, HORIZON_CHUNK)]
            h_y[d.type] = torch.cat(ys).cpu()
        else:
            h_y[d.type] = persistent.generate_plain(
                hcfg, h_params, 0, cond_pre, sel, ring, y_state, HORIZON_T)[0]
    h_mism = int((h_y["cuda"] != h_y["cpu"]).sum())
    log(f"[K1 horizon] {h_mism}/{HORIZON_B * HORIZON_T} mismatches, K1 on the "
        f"card in chunks of {HORIZON_CHUNK} vs plain on the CPU")
    if h_mism:
        fail(f"K1 disagrees with the plain version over the horizon: {h_mism}")

    # -- phase 6: K5 vs plain, small config -----------------------------------
    # one seeded schedule of ragged ticks (one with every length 0, one with
    # one row at 0) through an engine on the card (K5) and through the plain
    # ragged generator on the card, carrying their own state
    B, T = K5_SMALL_B, K5_SMALL_T
    rng = np.random.RandomState(1013)
    sched = rng.randint(1, T + 1, size=(K5_SMALL_TICKS, B))
    sched[2] = 0
    sched[4, 1] = 0
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.begin_stream(B)
    ring = persistent.init_ring(cfg, B, dev)
    y_state = torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                         device=dev)
    clocks = np.zeros(B, np.int64)
    k5_small_mism = 0
    k5_launches = persistent.RAGGED_KERNEL.launches
    for lens in sched:
        cond = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R)).astype(np.float32)
            ).to(dev)
        sel = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32)
                               ).to(dev)
        y_eng = eng.feed(cond, sel, lengths=lens)
        y_pl = persistent.generate_plain(
            cfg, params, torch.from_numpy(clocks),
            (cond + params["dil_b"][None, :, None, :]).contiguous(), sel,
            ring, y_state, torch.from_numpy(lens.astype(np.int32)))[0]
        y_pl = y_pl.T.cpu().numpy()
        if lens.max():
            k5_small_mism += int((y_eng != y_pl).sum())
        elif y_eng.shape != (B, 0) or y_pl.any():
            fail("K5: a tick with every length 0 produced samples")
        clocks += lens
    snap = eng.export_state()
    k5_small_err = float(np.abs(snap["ring"] - ring.cpu().numpy()).max())
    k5_small_ok = (np.array_equal(snap["y_state"], y_state.cpu().numpy())
                   and rel_close(ring.cpu(), snap["ring"], 1e-2, 3e-4)
                   and np.array_equal(snap["stream_t_row"], clocks))
    log(f"[K5 small] {K5_SMALL_TICKS} ticks, lengths {sched.tolist()}: y "
        f"{k5_small_mism} mismatches, y_state and clocks equal and ring in "
        f"ladder {k5_small_ok} (max abs err {k5_small_err:.3g}); "
        f"{persistent.RAGGED_KERNEL.launches - k5_launches} K5 launches")
    if k5_small_mism or not k5_small_ok:
        fail("K5 disagrees with its plain version")

    # timing of the standalone kernels at their check shapes (their launches
    # here are comparisons, not the main path: the counts are reset below)
    n_small = int((np.abs(x_np) < 0.5).sum())
    n = x.numel()
    fn_ops = {"exp": n * EXP_OPS,
              "tanh": n_small * TANH_SMALL_OPS + (n - n_small) * TANH_LARGE_OPS,
              "sigmoid": n * SIGMOID_OPS}
    lib_fn = {"exp": torch.exp, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    k0a_ms = k0a_plain = k0a_lib = k0a_bound = 0.0
    k0a_by = set()
    for name in ("exp", "tanh", "sigmoid"):
        k0a_ms += time_ms(torch, lambda: em.exact_fn(name, x), 50)
        k0a_plain += time_ms(torch, lambda: em.PLAIN_FNS[name](x), 5)
        k0a_lib += time_ms(torch, lambda: lib_fn[name](x), 50)
        b_ms, b_by = bound_ms(8 * n, fn_ops[name])
        k0a_bound += b_ms
        k0a_by.add(b_by)
    rows, A = za.shape
    k0b_ms = time_ms(torch, lambda: em.sample_from_logits(za, sel_za, 128), 50)
    k0b_plain = time_ms(torch, lambda: em.sample_from_logits_plain(
        za, sel_za, 128), 5)
    k0b_bound, k0b_by = bound_ms(
        rows * (4 * A + 4 + 4),
        rows * A * (2 + EXP_OPS + (A.bit_length() - 1) + 2))

    # -- phase 7: the main path at full width ---------------------------------
    cfg = cfg_lib.FLAGSHIP_CONFIG
    L, R = cfg.num_layers, cfg.R
    ref_w = params_lib.random_reference_weights(cfg, seed=1)
    eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                       S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                       chunk_size=MAIN_CHUNK, device="cuda")
    eng.set_reference_weights(ref_w)
    gen_dev = torch.Generator(device=dev)
    gen_dev.manual_seed(0)
    all_kernels = (em.EXACT_FN_KERNEL, em.SAMPLE_KERNEL, em.SOFTMAX_KERNEL,
                   om.ORDERED_MATMUL_KERNEL, persistent.PERSISTENT_KERNEL,
                   persistent.RAGGED_KERNEL, persistent.FORCED_KERNEL,
                   persistent.PRNG_KERNEL)
    for k in all_kernels:
        k.launches = 0
    requests = []
    for r in range(MAIN_REQUESTS):
        cond = (torch.rand((MAIN_T, L, MAIN_B, 2 * R), generator=gen_dev,
                           device=dev) - 0.5)
        sel = torch.rand((MAIN_T, MAIN_B), generator=gen_dev, device=dev)
        eng.set_inputs(cond, sel)
        seen = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = eng.run_chunks(MAIN_CHUNK, lambda yc, off, n: seen.append(n),
                           MAIN_T, MAIN_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        ok = (y.shape == (MAIN_B, MAIN_T) and sum(seen) == MAIN_T
              and int(y.min()) >= 0 and int(y.max()) < cfg.A)
        log(f"[main] request {r + 1}: {MAIN_B} x {MAIN_T} samples in "
            f"{dt:.3f} s = {MAIN_T / dt / 1e3:.3f} kHz per utterance; "
            f"{len(seen)} chunks; output well-formed {ok}")
        if not ok:
            fail(f"request {r + 1}: malformed output")
        requests.append({"seconds": dt, "khz_per_utt": MAIN_T / dt / 1e3})
        if r == 0:
            first = (cond, sel, y)
    launches = {k.symbol: k.launches for k in all_kernels}
    log(f"[main] launches on the main path: {launches}")
    if launches[persistent.PERSISTENT_KERNEL.symbol] == 0:
        fail("the main path did not launch K1")

    # request 1's first CHECK_T samples: plain version vs the main path's y,
    # and K1 at the same shape (with the dump) vs the plain version
    cond, sel, y_main = first
    params = eng._device_params()
    cond_pre = (cond[:CHECK_T] + params["dil_b"][None, :, None, :]).contiguous()
    sel_c = sel[:CHECK_T].contiguous()

    def fresh():
        return (persistent.init_ring(cfg, MAIN_B, dev),
                torch.full((2, MAIN_B), cfg.silence_bin, dtype=torch.int32,
                           device=dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    out_p = persistent.generate_plain(cfg, params, 0, cond_pre, sel_c,
                                      *fresh(), CHECK_T, dump=True)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t) * 1e3
    plain_mism = int((out_p[0].T.cpu().numpy() != y_main[:, :CHECK_T]).sum())
    gen = persistent.make_persistent_generator(cfg, MAIN_B, dump=True)
    out_k = gen(params, 0, cond_pre, sel_c, *fresh())
    torch.cuda.synchronize()
    k1_mism = int((out_k[0] != out_p[0]).sum())
    k1_err = max(float((k - p).abs().max())
                 for k, p in zip(out_k[1:2] + out_k[3:], out_p[1:2] + out_p[3:]))
    log(f"[main] first {CHECK_T} samples of request 1: {plain_mism}/"
        f"{MAIN_B * CHECK_T} mismatches main path vs plain on the card; "
        f"K1 (dump) vs plain {k1_mism}; max abs err of ring and dumps "
        f"{k1_err:.3g}")
    if plain_mism or k1_mism:
        fail("the main path disagrees with the plain version")

    gen = persistent.make_persistent_generator(cfg, MAIN_B)
    k1_ms = time_launch_ms(torch, np, lambda r, ys: gen(
        params, 0, cond_pre, sel_c, r, ys), fresh)
    k1_bound, k1_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T),
        k1_ops_per_row_step(cfg) * MAIN_B * CHECK_T)
    khz = float(np.mean([r["khz_per_utt"] for r in requests]))
    k1_us = k1_ms / CHECK_T * 1e3
    log(json.dumps({"main_path": {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "samples_per_request": MAIN_T, "requests": requests,
        "khz_per_utt": khz, "k1_ms_per_256_steps": k1_ms,
        "k1_us_per_step": k1_us, "card": card}}))
    log(f"[main] lockstep K1: {k1_us:.2f} us per step (earlier runs: "
        f"PERF.md)")

    # -- phase 8: serving at full width ---------------------------------------
    def flagship_engine():
        e = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                         S=cfg.S, A=cfg.A, max_batch=SERVE["B"],
                         chunk_size=MAIN_CHUNK, device="cuda")
        e.set_reference_weights(ref_w)
        return e
    gen_serve = torch.Generator(device=dev)
    gen_serve.manual_seed(2)
    for k in all_kernels:
        k.launches = 0
    t = time.perf_counter()
    completed, st = serve_scenario(torch, np, flagship_engine, cfg, dev,
                                   np.random.RandomState(2024), gen_serve,
                                   **SERVE)
    serve_s = time.perf_counter() - t
    serve_launches = {k.symbol: k.launches for k in all_kernels}
    feed_ms = np.array(st["feed_ms"])
    p50, p99 = (float(v) for v in np.percentile(feed_ms, [50, 99]))
    serving = {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32",
        "slots": SERVE["B"], "ticks": st["ticks"],
        "lockstep_ticks": st["lockstep_ticks"], "seconds": serve_s,
        "feeds_timed": len(feed_ms), "feed_ms_p50": p50, "feed_ms_p99": p99,
        "feed_ms_max": float(feed_ms.max()),
        "samples_served": st["samples_served"],
        "samples_per_s_live_rows": st["samples_served"] / (feed_ms.sum() / 1e3),
        "dead_row_step_share": st["dead_row_steps"] / st["row_steps"],
        "utterances_started": st["utterances_started"],
        "utterances_completed": st["utterances_completed"],
        "launches": serve_launches, "card": card}
    log(json.dumps({"serving": serving}))
    if not (serve_launches[persistent.RAGGED_KERNEL.symbol]
            and serve_launches[persistent.PERSISTENT_KERNEL.symbol]):
        fail(f"the serving path did not launch both K1 and K5: "
             f"{serve_launches}")

    # -- phase 9: correctness at full width -----------------------------------
    # the first utterances completed, replayed as one lockstep batch on a
    # fresh engine: each must equal what it was served, sample for sample
    chosen = completed[:SERVE_REPLAY]
    if len(chosen) < SERVE_REPLAY:
        fail(f"only {len(chosen)} utterances completed")
    replay_mism = replay_lockstep(torch, np, flagship_engine, cfg, dev, chosen)
    r3 = [u for u in chosen if u["start"] == SERVE["full_reset_tick"]
          and u["row"] not in SERVE["partial_rows"]
          and u["end"] > SERVE["partial_tick"]]
    migrated = [u for u in chosen if u["migrated"]]
    for u, m in zip(chosen, replay_mism):
        log(f"[replay] row {u['row']:2d}: {u['n']} samples, ticks "
            f"{u['start']}-{u['end']}, across the migration {u['migrated']}:"
            f" {m} mismatches")
    log(f"[replay] {len(chosen)} utterances, {sum(u['n'] for u in chosen)} "
        f"samples: {sum(replay_mism)} mismatches; {len(r3)} began at the "
        f"full reset and ran through the partial reset (R3), "
        f"{len(migrated)} crossed the migration (R7)")
    if sum(replay_mism) or not r3 or not migrated:
        fail("the served utterances do not replay exactly, or the replay "
             "misses the R3 or R7 sequence")

    # K5 at the flagship: one 160-step ragged tick of the scenario (its
    # lengths and row clocks), timed; the plain version over a 32-step tick
    # (the same rows scaled to 32 steps), and K5 on it against the plain
    if st["tick_of_160"] is None:
        fail("no ragged tick of 160 steps to time")
    lens, clocks = st["tick_of_160"]
    t0_row = torch.from_numpy(clocks)
    cond_pre = (cond[:SERVE["tick_t"]] + params["dil_b"][None, :, None, :]
                ).contiguous()
    sel_c = sel[:SERVE["tick_t"]].contiguous()
    gen5 = persistent.make_persistent_generator(cfg, MAIN_B, ragged=True)
    nvr = torch.from_numpy(lens.astype(np.int32))
    ring, ys = fresh()
    k5_ms = time_ms(torch, lambda: gen5(params, t0_row, cond_pre, sel_c,
                                        ring, ys, nvr), 5)
    live = int(lens.sum())
    k5_bound, k5_by = bound_ms(k5_bytes(cfg, MAIN_B, SERVE["tick_t"], live),
                               k1_ops_per_row_step(cfg) * live)
    lens32 = torch.from_numpy((lens * K5_PLAIN_T // SERVE["tick_t"]
                               ).astype(np.int32))
    cp32 = cond_pre[:K5_PLAIN_T].contiguous()
    sel32 = sel_c[:K5_PLAIN_T].contiguous()
    (ring_p, ys_p), (ring_k, ys_k) = fresh(), fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_p = persistent.generate_plain(cfg, params, t0_row, cp32, sel32, ring_p,
                                    ys_p, lens32)[0]
    torch.cuda.synchronize()
    k5_plain = (time.perf_counter() - t) * 1e3
    y_k = gen5(params, t0_row, cp32, sel32, ring_k, ys_k, lens32)[0]
    torch.cuda.synchronize()
    k5_flag_mism = int((y_k != y_p).sum()) + int(not torch.equal(ys_k, ys_p))
    k5_err = max(k5_small_err, float((ring_k - ring_p).abs().max()))
    log(f"[K5 flagship] 160-step tick, lengths {lens.tolist()}: "
        f"{k5_ms:.3f} ms = {k5_ms / SERVE['tick_t'] * 1e3:.2f} us per step "
        f"of the longest row (lockstep K1 {k1_us:.2f}); bound {k5_bound:.4f}"
        f" ms ({k5_by}, {live} live row-steps); plain over a {K5_PLAIN_T}"
        f"-step tick {k5_plain:.1f} ms; K5 vs plain on it: {k5_flag_mism} "
        f"mismatches, ring max abs err {k5_err:.3g}")
    if k5_flag_mism:
        fail("K5 disagrees with its plain version at the flagship")

    # -- phase 10: K2 and K3 at the flagship ----------------------------------
    # request 1's samples are the symbols K2 forces; the plain versions run
    # K5_PLAIN_T steps, the kernels are timed over CHECK_T-step launches
    y_tb = torch.from_numpy(np.ascontiguousarray(y_main.T)).to(dev)  # [T, B]
    sym_main = y_tb.to(torch.float32)
    cp_chk = (cond[:CHECK_T] + params["dil_b"][None, :, None, :]).contiguous()
    sel_chk = sel[:CHECK_T].contiguous()
    n = K5_PLAIN_T
    gen2 = persistent.make_persistent_generator(cfg, MAIN_B, mode="forced")
    gen3 = persistent.make_persistent_generator(cfg, MAIN_B, mode="prng")
    sel3 = torch.from_numpy(tsg.prng_uniform_sel(PRNG_SEED, np.arange(n),
                                                 MAIN_B)).to(dev)
    plain = {}
    for name, mode, s_in in (("K2", "forced", sym_main[:n].contiguous()),
                             ("K3", "sample", sel3)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain[name] = persistent.generate_plain(
            cfg, params, 0, cp_chk[:n].contiguous(), s_in, *fresh(), n,
            mode=mode)
        torch.cuda.synchronize()
        plain[name] += ((time.perf_counter() - t) * 1e3,)
    out2 = gen2(params, 0, cp_chk[:n].contiguous(), sym_main[:n].contiguous(),
                *fresh())
    out3 = gen3(params, 0, cp_chk[:n].contiguous(), sel_chk[:n].contiguous(),
                *fresh(), seed=PRNG_SEED)
    torch.cuda.synchronize()
    k2_flag = {"echo_mismatches": int((out2[0] != y_tb[:n]).sum()),
               "p_err": float((out2[3] - plain["K2"][3]).abs().max()),
               "ring_err": float((out2[1] - plain["K2"][1]).abs().max()),
               "state_equal": torch.equal(out2[2], plain["K2"][2]),
               "plain_ms": plain["K2"][-1]}
    k3_flag = {"mismatches": int((out3[0] != plain["K3"][0]).sum())
               + int(not torch.equal(out3[2], plain["K3"][2])),
               "ring_err": float((out3[1] - plain["K3"][1]).abs().max()),
               "plain_ms": plain["K3"][-1]}
    k2_ms = time_launch_ms(torch, np, lambda r, ys: gen2(
        params, 0, cp_chk, sym_main[:CHECK_T].contiguous(), r, ys), fresh)
    k3_ms = time_launch_ms(torch, np, lambda r, ys: gen3(
        params, 0, cp_chk, sel_chk, r, ys, seed=PRNG_SEED), fresh)
    k2_bound, k2_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T) + 4 * CHECK_T * MAIN_B * cfg.A,
        (k1_ops_per_row_step(cfg) - cfg.A) * MAIN_B * CHECK_T)
    k3_bound, k3_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T) - 4 * CHECK_T * MAIN_B,
        (k1_ops_per_row_step(cfg) + PHILOX_OPS) * MAIN_B * CHECK_T)
    log(f"[K2 flagship] {n} steps vs plain: y echoes the symbols with "
        f"{k2_flag['echo_mismatches']} mismatches, p_seq max abs err "
        f"{k2_flag['p_err']:.3g}, ring {k2_flag['ring_err']:.3g}, y_state "
        f"equal {k2_flag['state_equal']}; {k2_ms:.3f} ms per {CHECK_T}-step "
        f"launch = {k2_ms / CHECK_T * 1e3:.2f} us per step (K1 {k1_us:.2f})")
    log(f"[K3 flagship] {n} steps vs plain fed prng_uniform_sel: "
        f"{k3_flag['mismatches']} mismatches, ring {k3_flag['ring_err']:.3g};"
        f" {k3_ms:.3f} ms per {CHECK_T}-step launch = "
        f"{k3_ms / CHECK_T * 1e3:.2f} us per step (K1 {k1_us:.2f})")
    if (k2_flag["echo_mismatches"] or k2_flag["p_err"] > 1e-6
            or not k2_flag["state_equal"] or k3_flag["mismatches"]):
        fail("K2 or K3 disagrees with its plain version at the flagship")

    # -- phase 11: scoring at full width --------------------------------------
    # request 1's window scored from silence by the engine's time-parallel
    # scorer (K7, K0a, K0c) and by K2 on the same state and symbols
    for k in all_kernels:
        k.launches = 0
    seng = flagship_engine()
    seng.begin_stream(MAIN_B)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_eng = seng.score(cond, y_main)                          # [B, T, A]
    score_wall_ms = (time.perf_counter() - t) * 1e3
    snap = seng.export_state()
    cp_full = (cond + params["dil_b"][None, :, None, :]).contiguous()
    ring2, ys2 = fresh()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_w = gen2(params, 0, cp_full, sym_main, ring2, ys2)
    end.record()
    torch.cuda.synchronize()
    k2_window_ms = start.elapsed_time(end)
    del cp_full
    score_cmp = {
        "p_bit_mismatches": bit_mismatches(
            torch, torch.from_numpy(p_eng), out_w[3].permute(1, 0, 2).cpu()),
        "ring_bit_mismatches": bit_mismatches(torch, snap["ring"],
                                              ring2.cpu()),
        "y_state_equal": bool(np.array_equal(snap["y_state"],
                                             ys2.cpu().numpy())),
        "echo_mismatches": int((out_w[0] != y_tb).sum())}
    scorer_times = []
    for _ in range(3):
        seng.begin_stream(MAIN_B)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seng.score_device(cond, y_tb)
        end.record()
        torch.cuda.synchronize()
        scorer_times.append(start.elapsed_time(end))
    scorer_ms = float(np.mean(scorer_times))
    t = time.perf_counter()
    logp_k, bits_k = scoring.score_teacher_forced_kernel(params, cfg, cond,
                                                         y_main)
    kernel_score_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    logp_p, bits_p = scoring.score_teacher_forced_parallel(params, cfg, cond,
                                                           y_main)
    bits_p = bits_p.cpu().numpy()
    parallel_score_ms = (time.perf_counter() - t) * 1e3
    score_launches = {k.symbol: k.launches for k in all_kernels}
    bits_diff = float(np.abs(bits_k - bits_p).max())
    window_bound, window_by = bound_ms(
        k1_bytes(cfg, MAIN_B, MAIN_T) + 4 * MAIN_T * MAIN_B * cfg.A,
        (k1_ops_per_row_step(cfg) - cfg.A) * MAIN_B * MAIN_T)
    scoring_line = {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "window": MAIN_T, **score_cmp,
        "engine_score_wall_ms": score_wall_ms,
        "scorer_device_ms": scorer_ms, "k2_window_ms": k2_window_ms,
        "k2_over_scorer": k2_window_ms / scorer_ms,
        "window_bound_ms": window_bound, "window_bound_by": window_by,
        "score_teacher_forced_kernel_ms": kernel_score_ms,
        "score_teacher_forced_parallel_ms": parallel_score_ms,
        "bits_per_sample_kernel": float(bits_k.mean()),
        "bits_per_sample_parallel": float(bits_p.mean()),
        "bits_max_abs_diff": bits_diff, "launches": score_launches,
        "card": card}
    log(json.dumps({"scoring": scoring_line}))
    log(f"[scoring] scorer vs K2 over {MAIN_B} x {MAIN_T}: p_seq "
        f"{score_cmp['p_bit_mismatches']} bit mismatches, ring "
        f"{score_cmp['ring_bit_mismatches']}, y_state equal "
        f"{score_cmp['y_state_equal']}; scorer {scorer_ms:.2f} ms, K2 "
        f"{k2_window_ms:.1f} ms; bits per sample {bits_k.mean():.6f} (K2) "
        f"{bits_p.mean():.6f} (parallel), max diff {bits_diff:.3g}")
    if (score_cmp["p_bit_mismatches"] or score_cmp["ring_bit_mismatches"]
            or not score_cmp["y_state_equal"]
            or score_cmp["echo_mismatches"] or bits_diff > 1e-5):
        fail("the time-parallel scorer and K2 disagree, or the two scoring "
             "functions' bits per sample differ by more than 1e-5")
    scoring_kernels = (om.ORDERED_MATMUL_KERNEL, em.EXACT_FN_KERNEL,
                       em.SOFTMAX_KERNEL, persistent.FORCED_KERNEL)
    if not all(score_launches[k.symbol] for k in scoring_kernels):
        fail(f"the scoring path did not launch K7, K0a, K0c and K2: "
             f"{score_launches}")

    # -- phase 12: score -> feed handoff --------------------------------------
    half = MAIN_T // 2
    heng = flagship_engine()
    heng.begin_stream(MAIN_B)
    yf1 = heng.feed(cond[:half], sel[:half])
    yf2 = heng.feed(cond[half:], sel[half:])
    feed_mism = int((np.concatenate([yf1, yf2], 1) != y_main).sum())
    heng.begin_stream(MAIN_B)
    p_half = heng.score(cond[:half], yf1)
    yf2b = heng.feed(cond[half:], sel[half:])
    handoff = {"feed_vs_run_mismatches": feed_mism,
               "handoff_mismatches": int((yf2b != yf2).sum()),
               "half_window_p_bit_mismatches": bit_mismatches(
                   torch, p_half, np.ascontiguousarray(p_eng[:, :half]))}
    log(f"[handoff] two feeds of {half} vs the run: {feed_mism} mismatches;"
        f" score the first half, feed the second: "
        f"{handoff['handoff_mismatches']} mismatches; half-window p_seq vs "
        f"the full window's: {handoff['half_window_p_bit_mismatches']} bit "
        f"mismatches")
    if any(handoff.values()):
        fail(f"the score -> feed handoff is not exact: {handoff}")
    del p_eng, p_half

    # -- phase 13: prng at full width -----------------------------------------
    for k in all_kernels:
        k.launches = 0
    peng = flagship_engine()
    peng.sampling_seed = PRNG_SEED
    peng.set_inputs(cond, sel)
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_prng = peng.run_chunks(MAIN_CHUNK, lambda yc, off, n: None, MAIN_T,
                             MAIN_B, mode="prng")
    prng_s = time.perf_counter() - t
    prng_launches = {k.symbol: k.launches for k in all_kernels}
    prng_ok = (y_prng.shape == (MAIN_B, MAIN_T) and int(y_prng.min()) >= 0
               and int(y_prng.max()) < cfg.A)
    log(json.dumps({"prng": {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "samples": MAIN_T, "seconds": prng_s,
        "khz_per_utt": MAIN_T / prng_s / 1e3,
        "us_per_step_wall": prng_s / MAIN_T * 1e6,
        "k3_us_per_step": k3_ms / CHECK_T * 1e3, "k1_us_per_step": k1_us,
        "launches": prng_launches, "card": card}}))
    log(f"[prng] {MAIN_B} x {MAIN_T} samples in {prng_s:.3f} s = "
        f"{prng_s / MAIN_T * 1e6:.2f} us per step (main path "
        f"{requests[0]['seconds'] / MAIN_T * 1e6:.2f}); K3 "
        f"{k3_ms / CHECK_T * 1e3:.2f} us per step on the card, K1 "
        f"{k1_us:.2f}; output well-formed {prng_ok}")
    if not prng_ok or not prng_launches[persistent.PRNG_KERNEL.symbol]:
        fail(f"the prng request did not launch K3 or is malformed: "
             f"{prng_launches}")

    # -- phase 14: the kernels line -------------------------------------------
    def entry(name, source, replaces, n_launches, mism, err, ms, plain, bnd,
              by, lib, shape, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "mismatches": mism, "max_abs_err": err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "bound_by": by, "library_ms": lib, "shape": shape, **extra}

    csrc = "nv_wavenet_tpu_torch/csrc/"
    kernels = [
        entry("K0a exact_fn_kernel", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:90",
              score_launches[em.EXACT_FN_KERNEL.symbol], k0a["mismatches"],
              k0a["max_abs_err"], k0a_ms, k0a_plain, k0a_bound,
              "+".join(sorted(k0a_by)), k0a_lib,
              f"exp+tanh+sigmoid over [{x.numel()}] f32",
              also_replaces="tools/probe_exact_math_tpu.py:135",
              inlined_in="K1, K2, K3, K5", launches_on="the scoring phase",
              main_path_launches=launches[em.EXACT_FN_KERNEL.symbol]),
        entry("K0b sample_kernel", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:107",
              launches[em.SAMPLE_KERNEL.symbol], k0b_mism, 0.0, k0b_ms,
              k0b_plain, k0b_bound, k0b_by, None,
              f"za [{rows},{A}] f32, sel [{rows},1]",
              inlined_in="K1, K3, K5"),
        entry("K1 persistent_generate_kernel<false>", csrc + "persistent.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              launches[persistent.PERSISTENT_KERNEL.symbol],
              plain_mism + k1_mism + h_mism,
              k1_err, k1_ms, k1_plain, k1_bound, k1_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch",
              serving_launches=serve_launches[
                  persistent.PERSISTENT_KERNEL.symbol]),
        entry("K5 persistent_generate_kernel<true>", csrc + "persistent.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              serve_launches[persistent.RAGGED_KERNEL.symbol],
              k5_small_mism + k5_flag_mism + sum(replay_mism), k5_err, k5_ms,
              k5_plain, k5_bound, k5_by, None,
              f"flagship, B={MAIN_B}, one {SERVE['tick_t']}-step ragged tick "
              f"({live} live row-steps); plain_ms over a {K5_PLAIN_T}-step "
              f"ragged tick",
              variant="ragged=True (:109-118, 252-256, 302-311, 410-416) "
                      "and rotate_ring_phase (:785)",
              launches_on="the serving phase"),
        entry("K2 persistent_generate_kernel<false, kSelForced>",
              csrc + "persistent.cu", "nv_wavenet_tpu/ops/persistent.py:762",
              score_launches[persistent.FORCED_KERNEL.symbol],
              k2_small["echo_mismatches"] + k2_flag["echo_mismatches"]
              + score_cmp["p_bit_mismatches"]
              + score_cmp["ring_bit_mismatches"],
              max(k2_small["p_err"], k2_flag["p_err"]), k2_ms,
              k2_flag["plain_ms"], k2_bound, k2_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch; "
              f"plain_ms over {K5_PLAIN_T} steps",
              variant='mode="forced" (:139-146, 387-400, 692-694)',
              launches_on="the scoring phase",
              window_ms=k2_window_ms),
        entry("K3 persistent_generate_kernel<false, kSelPrng>",
              csrc + "persistent.cu", "nv_wavenet_tpu/ops/persistent.py:762",
              prng_launches[persistent.PRNG_KERNEL.symbol],
              k3_small["mismatches"] + k3_small["chunk_mismatches"]
              + k3_flag["mismatches"], 0.0, k3_ms, k3_flag["plain_ms"],
              k3_bound, k3_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch; "
              f"plain_ms over {K5_PLAIN_T} steps",
              variant='mode="prng", prng_uniform_sel (:74-83, 404-405)',
              launches_on="the prng request"),
        entry("K0c softmax_p_kernel", csrc + "exact_math_kernels.cu",
              "none (XLA in nv_wavenet_tpu/ops/score_parallel.py:169; "
              "softmax_canonical, nv_wavenet_tpu/ops/persistent.py:64)",
              score_launches[em.SOFTMAX_KERNEL.symbol], k0c["mismatches"],
              k0c["max_abs_err"], k0c["ms"], k0c["plain_ms"],
              k0c["bound_ms"], k0c["bound_by"], k0c["library_ms"],
              f"za [{rows},{A}] f32", launches_on="the scoring phase"),
        entry("K7 ordered_matmul_kernel", csrc + "ordered_matmul.cu",
              "none (XLA in nv_wavenet_tpu/ops/score_parallel.py:135-139, "
              "150-151, 163-168)",
              score_launches[om.ORDERED_MATMUL_KERNEL.symbol],
              k7["mismatches"], k7["max_abs_err"], k7["ms"], k7["plain_ms"],
              k7["bound_ms"], k7["bound_by"], k7["library_ms"],
              "sum over " + ", ".join(f"[{m},{k}]x[{k},{n}]"
                                      for m, k, n in K7_SHAPES) + " f32",
              launches_on="the scoring phase",
              per_shape=k7["per_shape"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
