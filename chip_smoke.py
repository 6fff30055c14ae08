#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`nv_wavenet_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `nv_wavenet_tpu_torch/csrc/` with
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's main path at full width: the flagship geometry (20 layers,
R=64, S=256, A=256, max_dilation 512, fp32, batch 16, random weights from
seed 1) serving 3 requests of 8192 samples through `WaveNetInfer.set_inputs`
+ `run_chunks`.  Phases, in order; any failure exits non-zero:

  1. device: card name and power limit (nvidia-smi), torch.version.cuda, nvcc
  2. build: every csrc/*.cu, timed
  3. K0a (elementwise exact exp/tanh/sigmoid) vs plain: 0 bit mismatches on
     the dense sweep of tests/test_exact_math.py
  4. K0b (canonical sampler) vs plain: 0 mismatches on za [4096, 256]
  5. K1 (persistent generation) vs plain, TEST_CONFIG_MED, B=4, T=64, sample
     and argmax modes with the dump: exact y, activations within the
     reference ladder; 7+7+...+1 chunked run_partial calls equal one call;
     then the 65,536-draw horizon case of tests/test_torch_generate.py (4
     layers, R=32, B=16, T=4096), K1 on the card in chunks of 256 against
     the plain version on the CPU in one call: 0 integer mismatches (the CPU
     test holds that plain version to the golden model with 0 too)
  6. main path: kernel launch counts set to 0 just before and read just
     after; K1 must have launched; the first 256 samples of request 1 must
     equal the plain version's on the card (0 integer mismatches)
  7. the `kernels` JSON line: per kernel its launches on the main path, its
     time, the plain version's, the least time the card could take for the
     same work (bound_ms) and, where one PyTorch call computes the same
     function, that call's time

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

MAIN_B, MAIN_T, MAIN_CHUNK, MAIN_REQUESTS, CHECK_T = 16, 8192, 256, 3, 256
HORIZON_B, HORIZON_T, HORIZON_CHUNK = 16, 4096, 256


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


def k1_bytes(cfg, B: int, T: int) -> int:
    """Each input read once, each output written once: weights, cond_pre,
    selectors, the FIFO ring and y_state in and out, y."""
    L, R = cfg.num_layers, cfg.R
    return 4 * (cfg.param_count() + T * L * B * 2 * R + T * B
                + 2 * cfg.ring_size * B * R + 2 * 2 * B + T * B)


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
    from nv_wavenet_tpu_torch.ops import persistent
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

    # -- phase 6: the main path at full width ---------------------------------
    cfg = cfg_lib.FLAGSHIP_CONFIG
    L, R = cfg.num_layers, cfg.R
    ref_w = params_lib.random_reference_weights(cfg, seed=1)
    eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                       S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                       chunk_size=MAIN_CHUNK, device="cuda")
    eng.set_reference_weights(ref_w)
    gen_dev = torch.Generator(device=dev)
    gen_dev.manual_seed(0)
    all_kernels = (em.EXACT_FN_KERNEL, em.SAMPLE_KERNEL,
                   persistent.PERSISTENT_KERNEL)
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
    times = []
    for _ in range(5):
        ring, ys = fresh()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gen(params, 0, cond_pre, sel_c, ring, ys)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    k1_ms = float(np.mean(times[1:]))
    k1_bound, k1_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T),
        k1_ops_per_row_step(cfg) * MAIN_B * CHECK_T)
    khz = float(np.mean([r["khz_per_utt"] for r in requests]))
    log(json.dumps({"main_path": {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "samples_per_request": MAIN_T, "requests": requests,
        "khz_per_utt": khz, "k1_ms_per_256_steps": k1_ms,
        "k1_us_per_step": k1_ms / CHECK_T * 1e3, "card": card}}))

    # -- phase 7: the kernels line --------------------------------------------
    def entry(name, source, replaces, symbol, mism, err, ms, plain, bnd, by,
              lib, shape, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[symbol],
                "mismatches": mism, "max_abs_err": err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "bound_by": by, "library_ms": lib, "shape": shape, **extra}

    csrc = "nv_wavenet_tpu_torch/csrc/"
    kernels = [
        entry("K0a exact_fn_kernel", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:90",
              em.EXACT_FN_KERNEL.symbol, k0a["mismatches"],
              k0a["max_abs_err"], k0a_ms, k0a_plain, k0a_bound,
              "+".join(sorted(k0a_by)), k0a_lib,
              f"exp+tanh+sigmoid over [{n}] f32",
              also_replaces="tools/probe_exact_math_tpu.py:135",
              inlined_in="K1"),
        entry("K0b sample_kernel", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:107", em.SAMPLE_KERNEL.symbol,
              k0b_mism, 0.0, k0b_ms, k0b_plain, k0b_bound, k0b_by, None,
              f"za [{rows},{A}] f32, sel [{rows},1]", inlined_in="K1"),
        entry("K1 persistent_generate_kernel", csrc + "persistent.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              persistent.PERSISTENT_KERNEL.symbol,
              plain_mism + k1_mism + h_mism,
              k1_err, k1_ms, k1_plain, k1_bound, k1_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
