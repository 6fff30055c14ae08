#!/usr/bin/env python3
"""Performance harness with the flags of the reference's `nv_wavenet_perf`
(`nv_wavenet_perf.cu:203-254`): the sample rate in kHz per utterance
(num_samples / elapsed ms) of a configurable model and batch, by mode.

The port's counterpart of `nv_wavenet_tpu/tools/perf.py`, with its flags:
  -l layers (20)  -r residual channels (64)  -s skip channels (128)
  -a output channels (256)  -b batch (1)  -c chunk, samples per launch (256)
  -n samples (16384)  -d max dilation (512)
  -m mode: auto | single | dual | persistent (K1) | manyblock (K4) |
     fused (K6) | fused_pack (K6, gate blocks of R rows) | fused_fast (K6
     with fast_math) | speculative (`WaveNetInfer.run_speculative`)
  --spec_window K (256)  --spec_adaptive (the self-governing tier)
  -p 32|16 weight storage (16: bf16)  --compute 32|16 (16: bf16 compute)
  --fast_math  --fused  --fused_pack
  --stream_gs, --stream_prefetch, --stream_quant int8 (MANYBLOCK's copies)
  -t iterations (3): back-to-back timed runs after one warm-up
  -f device index: the CUDA device to run on (reference -f parity)
  --device cpu: the plain PyTorch path on the CPU (tests; a CPU rate is no
     rate of the card)
  --sampling sample|argmax
  --sweep: every (mode, batch, chunk) of --sweep_modes / --sweep_batches /
     --sweep_chunks, a table ranked by total rate and the best configs.

Output: the reference's `Sample rate: X kHz` line and a JSON record naming
the device (on the card also its name and power limit from nvidia-smi).

    python3 -m nv_wavenet_tpu_torch.tools.perf -b 1 -m speculative
"""

from __future__ import annotations

import argparse
import json
import time

import torch

SWEEP_MODES_ALL = ("persistent", "manyblock", "fused", "fused_pack",
                   "fused_fast", "speculative")
MODES = ("auto", "single", "dual") + SWEEP_MODES_ALL


def impl_of(mode: str):
    from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl
    return {"auto": Impl.AUTO, "single": Impl.SINGLE_BLOCK,
            "dual": Impl.DUAL_BLOCK,
            "manyblock": Impl.MANYBLOCK}.get(mode, Impl.PERSISTENT)


def build_engine(args, batch: int, chunk: int, mode: str, device):
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer

    fused = args.fused or mode.startswith("fused")
    return WaveNetInfer(
        num_layers=args.layers, max_dilation=args.max_dilation,
        R=args.r_chans, S=args.s_chans, A=args.a_chans, max_batch=batch,
        implementation=impl_of(mode), chunk_size=chunk,
        weight_dtype=torch.bfloat16 if args.precision == 16 else torch.float32,
        compute_dtype=torch.bfloat16 if args.compute == 16 else torch.float32,
        fast_math=args.fast_math or mode == "fused_fast",
        stream_group_size=args.stream_gs, stream_prefetch=args.stream_prefetch,
        stream_quant=args.stream_quant, fuse_chain=fused,
        fuse_pack=args.fused_pack or mode == "fused_pack", device=device)


def resolved(eng, mode: str) -> str:
    """The kernel a run of this engine launches."""
    if mode == "speculative":
        return "K6 draft + scorer (K7, K0a, K0c, K0b)"
    if eng._stream:
        return "MANYBLOCK (K4)"
    return "K6" if eng._fuse_fits else "PERSISTENT (K1)"


def inputs(args, T: int, batch: int, device):
    """Conditioning in [-0.5, 0.5) and selectors from a seeded generator on
    the device (no host upload)."""
    gen = torch.Generator(device=device).manual_seed(0)
    cond = torch.rand((T, args.layers, batch, 2 * args.r_chans),
                      generator=gen, device=device) - 0.5
    sel = torch.rand((T, batch), generator=gen, device=device)
    return cond, sel


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(eng, T: int, batch: int, iters: int, sampling: str, mode: str,
            spec_window: int = 256, spec_adaptive: bool = False) -> float:
    """kHz per utterance: `iters` back-to-back runs after a warm-up, timed
    on the host clock up to a synchronisation of the device."""
    if mode == "speculative":
        if sampling != "sample":
            raise ValueError(f"-m speculative measures sampling mode "
                             f"'sample' only, not {sampling!r}")
        return measure_speculative(eng, T, batch, iters, spec_window,
                                   spec_adaptive)
    dev = eng.device
    eng.run_device(T, batch, mode=sampling)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(iters):
        eng.run_device(T, batch, mode=sampling)
    _sync(dev)
    return iters * T / (time.perf_counter() - t) / 1e3


def measure_speculative(eng, T: int, batch: int, iters: int, window: int,
                        adaptive: bool) -> float:
    """Speculative exact decode, as `measure`; also prints the rounds, the
    mean committed run (T / rounds) and, adaptive, the branch taken."""
    from nv_wavenet_tpu_torch.ops import speculative

    dev = eng.device
    _, rounds = eng._run_speculative_device(T, batch, window, adaptive)
    _sync(dev)
    tag = (f"adaptive branch={eng.spec_branch} "
           f"({speculative.BRANCHES[eng.spec_branch]}), " if adaptive
           else "")
    print(f"  speculative window={window}: {tag}{rounds} rounds, avg "
          f"committed run {T / max(rounds, 1):.1f} samples", flush=True)
    t = time.perf_counter()
    for _ in range(iters):
        eng._run_speculative_device(T, batch, window, adaptive)
    _sync(dev)
    return iters * T / (time.perf_counter() - t) / 1e3


def device_of(args) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("perf: no CUDA device (pass --device cpu for the "
                         "plain path on the CPU)")
    return torch.device("cuda", args.card)


def device_name(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "cpu"
    from nv_wavenet_tpu_torch.utils.profiling import card
    return card()


def run_single(args, dev):
    from nv_wavenet_tpu_torch.models import params as params_lib

    print(f"Config: layers={args.layers} R={args.r_chans} S={args.s_chans} "
          f"A={args.a_chans} batch={args.batch} samples={args.samples} "
          f"max_dilation={args.max_dilation} chunk={args.chunk} "
          f"mode={args.mode} precision=fp{args.precision} "
          f"compute=fp{args.compute} fast_math={args.fast_math} "
          f"device={dev}", flush=True)
    eng = build_engine(args, args.batch, args.chunk, args.mode, dev)
    print(f"Resolved implementation: {resolved(eng, args.mode)}", flush=True)
    eng.set_reference_weights(
        params_lib.random_reference_weights(eng.cfg, seed=1))
    eng.set_inputs(*inputs(args, args.samples, args.batch, dev))
    rate = measure(eng, args.samples, args.batch, args.iters, args.sampling,
                   args.mode, args.spec_window, args.spec_adaptive)
    print(f"Sample rate: {rate:.2f} kHz", flush=True)
    print(json.dumps({"khz_per_utterance": round(rate, 2),
                      "khz_total": round(rate * args.batch, 1),
                      "batch": args.batch, "mode": args.mode,
                      "precision": args.precision, "compute": args.compute,
                      "fast_math": args.fast_math,
                      "device": device_name(dev)}), flush=True)


def run_sweep(args, dev):
    """Every (mode, batch, chunk): a ranked table and the best configs.  A
    configuration that raises is reported as FAILED with its error, and the
    sweep goes on."""
    from nv_wavenet_tpu_torch.models import params as params_lib

    batches = [int(b) for b in args.sweep_batches.split(",")]
    chunks = [int(c) for c in args.sweep_chunks.split(",")]
    modes = (list(SWEEP_MODES_ALL) if args.sweep_modes == "all"
             else args.sweep_modes.split(","))
    T = args.samples
    print(f"Sweep: layers={args.layers} R={args.r_chans} S={args.s_chans} "
          f"A={args.a_chans} maxD={args.max_dilation} T={T} "
          f"precision=fp{args.precision} compute=fp{args.compute} "
          f"fast_math={args.fast_math} device={dev}", flush=True)
    print(f"  modes={modes} batches={batches} chunks={chunks}", flush=True)
    rows, ref_w = [], None
    for batch in batches:
        cond, sel = inputs(args, T, batch, dev)
        for mode in modes:
            for chunk in chunks:
                try:
                    eng = build_engine(args, batch, chunk, mode, dev)
                    if ref_w is None:
                        ref_w = params_lib.random_reference_weights(eng.cfg,
                                                                    seed=1)
                    eng.set_reference_weights(ref_w)
                    eng.set_inputs(cond, sel)
                    rate = measure(eng, T, batch, args.iters, args.sampling,
                                   mode, args.spec_window,
                                   args.spec_adaptive)
                except (ValueError, RuntimeError) as err:
                    print(f"  mode={mode:10s} b={batch:<3d} c={chunk:<4d} "
                          f"FAILED: {type(err).__name__}: {err}", flush=True)
                    continue
                row = {"mode": mode, "resolved": resolved(eng, mode),
                       "batch": batch, "chunk": chunk,
                       "khz_per_utterance": round(rate, 2),
                       "khz_total": round(rate * batch, 1)}
                rows.append(row)
                print(f"  mode={mode:10s} b={batch:<3d} c={chunk:<4d} "
                      f"-> {rate:8.2f} kHz/utt  {rate * batch:9.1f} kHz total"
                      f"  [{row['resolved']}]", flush=True)
    rows.sort(key=lambda r: -r["khz_total"])
    print("\nRanked by total throughput:", flush=True)
    for r in rows[:10]:
        print(f"  {r['khz_total']:9.1f} kHz total  "
              f"{r['khz_per_utterance']:8.2f} kHz/utt  "
              f"mode={r['mode']} b={r['batch']} c={r['chunk']}", flush=True)
    if rows:
        best_utt = max(rows, key=lambda r: r["khz_per_utterance"])
        print(f"\nBest total: {json.dumps(rows[0])}", flush=True)
        print(f"Best per-utterance: {json.dumps(best_utt)}", flush=True)
    print(f"Device: {device_name(dev)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-l", "--layers", type=int, default=20)
    ap.add_argument("-r", "--r_chans", type=int, default=64)
    ap.add_argument("-s", "--s_chans", type=int, default=128)
    ap.add_argument("-a", "--a_chans", type=int, default=256)
    ap.add_argument("-b", "--batch", type=int, default=1)
    ap.add_argument("-c", "--chunk", type=int, default=256)
    ap.add_argument("-n", "--samples", type=int, default=16384)
    ap.add_argument("-d", "--max_dilation", type=int, default=512)
    ap.add_argument("-m", "--mode", default="auto", choices=MODES)
    ap.add_argument("--spec_adaptive", action="store_true",
                    help="mode speculative: the self-governing tier (a probe "
                         "picks window, window/2 or the exact kernel)")
    ap.add_argument("--spec_window", type=int, default=256,
                    help="mode speculative: the draft window K")
    ap.add_argument("-p", "--precision", type=int, default=32,
                    choices=[16, 32])
    ap.add_argument("--compute", type=int, default=32, choices=[16, 32])
    ap.add_argument("--fast_math", action="store_true")
    ap.add_argument("--fused_pack", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--stream_gs", type=int, default=8)
    ap.add_argument("--stream_prefetch", action="store_true")
    ap.add_argument("--stream_quant", choices=["int8"], default=None)
    ap.add_argument("-t", "--iters", type=int, default=3)
    ap.add_argument("-f", "--card", type=int, default=0,
                    help="CUDA device index (reference -f parity)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu: the plain path (tests), no rate of the card")
    ap.add_argument("--sampling", default="sample",
                    choices=["sample", "argmax"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep_batches", default="1,8,16,64")
    ap.add_argument("--sweep_chunks", default="64,256")
    ap.add_argument("--sweep_modes", default="persistent,manyblock,fused_fast",
                    help="comma list of " + ",".join(SWEEP_MODES_ALL)
                         + " or 'all'")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device_of(args)
    if args.sweep:
        run_sweep(args, dev)
    else:
        run_single(args, dev)


if __name__ == "__main__":
    main()
