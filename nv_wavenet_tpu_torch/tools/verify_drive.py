#!/usr/bin/env python3
"""Hardware self-test (`nvw-torch-verify`): the canonical cross-check of the
port on the card through the public engine API, at the JAX drive's config
(20 layers, R=64, S=128, A=256, max_dilation 8, B=4, T=32).

The port's counterpart of `nv_wavenet_tpu/tools/verify_drive.py` (the
reference's ./nv_wavenet_test).  Covers ragged `run_chunks` (K1), MANYBLOCK
against PERSISTENT (K4 against K1), bf16 weights across both, the dump's p
normalisation, int8 exactness (K4 against the plain loop on the
round-tripped weights), the fused chain's TV contract (K6 against K2,
reported, not fatal), `reset_utterances`, `set_temperature`, feed parity,
the scorer's handoff (K7, K0a, K0c) and speculative decode's bit match.
The exact checks are held against the plain loop on the CPU
(`scan_generate.generate`), which the tests hold against the JAX package.

    python3 -m nv_wavenet_tpu_torch.tools.verify_drive [--device cpu]

Exits nonzero on any exact-path mismatch.  Runs on the card; `--device
cpu` (or `main(device="cpu")`) runs the same checks on the plain path,
and without a card the default raises rather than falling back.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.engine.wavenet_infer import (Impl, WaveNetInfer,
                                                       resolve_device)
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import fused_chain, persistent, scan_generate
from nv_wavenet_tpu_torch.utils.oracles import int8_dequant_scan_oracle

CFG = WaveNetConfig(num_layers=20, R=64, S=128, A=256, max_dilation=8)
B, T = 4, 32
T1 = 13            # the handoff point of the reset and scorer checks
TV_MEAN, TV_MAX = 0.01, 0.2   # the fused chain's TV contract (JAX drive)


def check(ok: bool, what: str) -> None:
    """Print the check's outcome; exit 1 on a mismatch."""
    if not ok:
        print(f"FAILED: {what}", flush=True)
        raise SystemExit(1)
    print(f"{what} OK", flush=True)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        description="nv_wavenet_tpu_torch hardware self-test: every kernel "
                    "tier on the card against the plain loop; exits nonzero "
                    "on any exact-path mismatch")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print("device: cpu (the plain path)", flush=True)
    cfg = CFG
    ref_w = params_lib.random_reference_weights(cfg, seed=77)
    rng = np.random.RandomState(7)
    cond = rng.uniform(-0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)

    # the oracle: the plain loop on the CPU
    params_cpu = params_lib.canonical_to_torch(
        params_lib.to_canonical(ref_w, cfg), "cpu")
    _, y_gold, _ = scan_generate.generate(
        params_cpu, scan_generate.init_state(cfg, B, "cpu"),
        torch.from_numpy(cond), torch.from_numpy(sel), cfg)
    y_gold = y_gold.numpy()

    def make(impl, **kw):
        eng = WaveNetInfer(num_layers=cfg.num_layers,
                           max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                           A=cfg.A, max_batch=B, chunk_size=8,
                           implementation=impl, device=dev, **kw)
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        return eng

    def ragged(eng):
        return eng.run_chunks(13, lambda yc, off, n: None, T, B)

    t0 = time.time()
    eng = make(Impl.AUTO)
    check(np.array_equal(ragged(eng), y_gold),
          "PERSISTENT ragged run_chunks exact-match")
    check(np.array_equal(ragged(make(Impl.MANYBLOCK)), y_gold),
          "MANYBLOCK (the staged K4) exact-match")
    bf = [make(impl, weight_dtype=torch.bfloat16).run(T, B)
          for impl in (Impl.PERSISTENT, Impl.MANYBLOCK)]
    check(np.array_equal(*bf), "bf16-weights cross-impl identity")

    eng.set_inputs(cond, sel)
    yd = eng.run(T, B, dump_activations=True)
    psum = eng.get_p().sum(-1)
    check(np.array_equal(yd, y_gold)
          and np.allclose(psum, 1.0, atol=1e-5),
          f"dump mode (p sums to 1: {psum.min():.7f}..{psum.max():.7f})")

    yq = make(Impl.MANYBLOCK, stream_quant="int8").run(T, B)
    y_q = int8_dequant_scan_oracle(cfg, ref_w, cond, sel)
    check(np.array_equal(yq, y_q),
          f"int8 weight-streaming exact-match (agreement "
          f"{np.mean(yq == y_q):.3f})")

    # the fused chain is governed by the teacher-forced TV contract, not
    # exact match: K6's forced p against K2's on the exact trajectory.
    # Not fatal: the tier is opt-in, and this drive exists for the exact
    # paths
    try:
        params = params_lib.canonical_to_torch(
            params_lib.to_canonical(ref_w, cfg), dev)
        forced = torch.from_numpy(y_gold.T.astype(np.float32)).to(dev)
        cond_d = torch.from_numpy(cond).to(dev)

        def fresh():
            return (persistent.init_ring(cfg, B, dev),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        p_exact = persistent.make_persistent_generator(cfg, B, mode="forced")(
            params, 0, (cond_d + params["dil_b"][None, :, None, :])
            .contiguous(), forced, *fresh())[-1]
        p_fused = fused_chain.make_fused_generator(cfg, B, mode="forced")(
            params, 0, cond_d, forced, *fresh())[-1]
        pe, pf = (np.asarray(p.cpu(), np.float64) for p in (p_exact,
                                                            p_fused))
        pe, pf = (p / p.sum(-1, keepdims=True) for p in (pe, pf))
        tv = 0.5 * np.abs(pf - pe).sum(-1)
        agree = float(np.mean(make(Impl.PERSISTENT, fuse_chain=True)
                              .run(T, B) == y_gold))
        print(f"fused TV mean/p99/max = {tv.mean():.2e}/"
              f"{np.percentile(tv, 99):.2e}/{tv.max():.2e}, trajectory "
              f"agreement {agree:.3f}", flush=True)
        if tv.mean() < TV_MEAN and tv.max() < TV_MAX:
            print("fused-chain TV contract OK", flush=True)
        else:
            print(f"WARNING: fused TV out of contract (non-fatal): mean "
                  f"{tv.mean():.3g} max {tv.max():.3g}", flush=True)
    except Exception as err:   # report, never abort the exact checks
        print(f"WARNING: fused-chain check FAILED (non-fatal): "
              f"{type(err).__name__}: {err}", flush=True)

    # reset_utterances: row 2 reset mid-stream continues as a fresh
    # engine fed only the tail; the other rows as the uninterrupted run
    er = make(Impl.AUTO)
    er.begin_stream(B)
    y1 = er.feed(cond[:T1], sel[:T1])
    er.reset_utterances([2])
    y2 = er.feed(cond[T1:], sel[T1:])
    keep = [r for r in range(B) if r != 2]
    ef = make(Impl.AUTO)
    ef.begin_stream(B)
    y_fresh = ef.feed(cond[T1:], sel[T1:])
    check(np.array_equal(np.concatenate([y1, y2], 1)[keep], y_gold[keep])
          and np.array_equal(y2[2], y_fresh[2]),
          "reset_utterances continuous-batching exact-match")

    # set_temperature: the patch path (end_w / end_b re-uploaded) equals
    # the constructor's temperature, and T=1 restores exactness
    et = make(Impl.AUTO)
    et._device_params()
    et.set_temperature(2.0)
    et.set_inputs(cond, sel)
    y_t2 = et.run(T, B)
    same = np.array_equal(y_t2, make(Impl.AUTO, temperature=2.0).run(T, B))
    et.set_temperature(1.0)
    et.set_inputs(cond, sel)
    check(same and np.array_equal(et.run(T, B), y_gold),
          "set_temperature patch-path identity + T=1 exactness")

    eng.begin_stream(B)
    outs, off = [], 0
    for n in (13, 6, 13):
        outs.append(eng.feed(cond[off:off + n], sel[off:off + n]))
        off += n
    check(np.array_equal(np.concatenate(outs, 1), y_gold),
          "streaming feed exact-match")

    # the scorer mid-stream: the golden prefix scored, the tail generated;
    # p against the plain loop's forced run
    es = make(Impl.AUTO)
    es.begin_stream(B)
    p_s = es.score(cond[:T1], y_gold[:, :T1])                 # [B, T1, A]
    y_tail = es.feed(cond[T1:], sel[T1:])
    cond_pre = torch.from_numpy(cond[:T1]) + params_cpu["dil_b"][
        None, :, None, :]
    ring = persistent.init_ring(cfg, B, "cpu")
    ys = torch.full((2, B), cfg.silence_bin, dtype=torch.int32)
    _, _, p_plain = scan_generate.run_steps(
        params_cpu, cfg, 0, cond_pre, torch.from_numpy(
            y_gold[:, :T1].T.astype(np.float32)), ring, ys, T1, "forced",
        record="p")
    dp = float(np.abs(np.transpose(p_s, (1, 0, 2)) - p_plain.numpy()).max())
    check(np.array_equal(y_tail, y_gold[:, T1:]) and dp < 1e-5,
          f"time-parallel scorer exact handoff (max |dp| {dp:.1e})")

    esp = make(Impl.PERSISTENT)
    y_spec = esp.run_speculative(T, B, window=8)
    check(np.array_equal(y_spec, y_gold),
          f"speculative exact decode bit-match ({esp.spec_rounds} rounds "
          f"for {T} samples)")

    try:
        WaveNetInfer(num_layers=cfg.num_layers,
                     max_dilation=cfg.max_dilation, max_batch=B,
                     device=dev).run(8, B)
        check(False, "run before set_inputs raises")
    except RuntimeError as err:
        check("set_inputs" in str(err), "run before set_inputs raises")
    print(f"ALL HARDWARE CHECKS PASSED ({time.time() - t0:.1f} s on {dev})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
