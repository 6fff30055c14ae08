#!/usr/bin/env python3
"""Evaluate a trained checkpoint end to end (`nvw-torch-eval-checkpoint`):
the teacher-forced likelihood of reference audio in bits per sample, by
the engine's scorer (`WaveNetInfer.score_device`: K7, K0a, K0c on the
card), autoregressive generation from the clip's mel (K1), and a spectral
check of what was generated, the quantitative stand-in for the
reference's listen-and-compare (`pytorch/README.md:19`).

The port's counterpart of `nv_wavenet_tpu/tools/eval_checkpoint.py`, for a
checkpoint of `nvw-torch-train` (`train/trainer.py`):

    python3 -m nv_wavenet_tpu_torch.tools.eval_checkpoint -c ckpt [-i 3000]
        [-w input.wav] [-o out.wav] [--config configs/config.json]
        [--device cpu]

With no -w it evaluates on the synthetic training clips
(`train/data.synthetic_clips`, the training CLI's default), so train ->
eval needs no wav.  Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from nv_wavenet_tpu_torch.engine.wavenet_infer import (WaveNetInfer,
                                                       resolve_device)
from nv_wavenet_tpu_torch.models import wavenet as wavenet_lib
from nv_wavenet_tpu_torch.ops import score_parallel
from nv_wavenet_tpu_torch.train import trainer
from nv_wavenet_tpu_torch.train.data import (data_config_from_json,
                                             load_wav, mel_spectrogram,
                                             synthetic_clips, write_wav)
from nv_wavenet_tpu_torch.utils.mu_law import (mu_law_decode_np,
                                               mu_law_encode_np)


def dominant_hz(x: np.ndarray, sr: int) -> float:
    """The frequency of the largest bin of x's windowed spectrum above
    20 Hz."""
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    lo = max(1, int(20 * len(x) / sr))
    return float((np.argmax(sp[lo:]) + lo) * sr / len(x))


def _engine(model: wavenet_lib.WaveNetTrain, batch: int, device,
            **kw) -> WaveNetInfer:
    cfg = wavenet_lib.config_of(model)
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=batch, tanh_embed=cfg.tanh_embed,
                       chunk_size=256, device=device, **kw)
    eng.set_canonical_params(wavenet_lib.export_canonical(model))
    return eng


def conditioning(model: wavenet_lib.WaveNetTrain, mel: np.ndarray,
                 device) -> torch.Tensor:
    """The engine's conditioning [T, L, B, 2R] of mel [B, frames, n_mel]
    (`get_cond_input`, on `device`)."""
    with torch.no_grad():
        return model.get_cond_input(torch.as_tensor(
            np.asarray(mel, np.float32), device=device))


def teacher_forced_bits(model: wavenet_lib.WaveNetTrain, cond: torch.Tensor,
                        audio_bins: np.ndarray, device) -> float:
    """Mean bits per sample of audio_bins [B, T] (mu-law) under the model,
    teacher forced: the engine's scorer from the state (silence, audio[:,
    0]) over cond[:T-1] (position t conditions the prediction of t + 1),
    -log2 p of each true symbol (`score_parallel.bits_per_sample`).  A
    uniform model reads log2(A) = 8."""
    y = np.asarray(audio_bins, np.int32)
    B, T = y.shape
    eng = _engine(model, B, device)
    eng.begin_stream(B)
    snap = eng.export_state()
    snap["y_state"][1] = y[:, 0]
    eng.import_state(snap)
    y_next = torch.as_tensor(y[:, 1:].T.copy(), device=device)
    p_seq = eng.score_device(cond[:T - 1], y_next)
    return float(score_parallel.bits_per_sample(p_seq, y_next)
                 .to(torch.float64).mean())


def generate(model: wavenet_lib.WaveNetTrain, cond: torch.Tensor, device,
             seed: int = 0, fused: bool = False) -> np.ndarray:
    """y [B, T] generated from cond [T, L, B, 2R] with the default selectors
    of `seed` (K1 on the card; K6 with `fused`)."""
    T, _, B, _ = cond.shape
    eng = _engine(model, B, device, fuse_chain=fused)
    eng.set_inputs(cond, selectors=None, seed=seed)
    return eng.run(T, B)


def evaluate(argv=None) -> dict:
    """`main`'s work; returns what it printed: the iteration,
    bits_per_sample, the samples scored, source_hz, generated_hz, rms and
    the output path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--checkpoint_dir", required=True)
    ap.add_argument("-i", "--iteration", type=int, default=None)
    ap.add_argument("-w", "--wav", help="reference wav (default: synthetic)")
    ap.add_argument("-o", "--output", default=None,
                    help="the generated wav (default: eval_gen.wav in the "
                         "checkpoint directory)")
    ap.add_argument("--config", default="configs/config.json")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fused", action="store_true",
                    help="generate through the collapsed chain K6 (scoring "
                         "stays on the exact path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, the plain path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.config) as f:
        cfg_json = json.load(f)
    model = trainer.create_model(cfg_json["wavenet_config"])
    data_cfg = data_config_from_json(cfg_json["data_config"])
    sr = data_cfg.sampling_rate
    n = int(args.seconds * sr)
    if args.wav:
        audio, wav_sr = load_wav(args.wav)
        if wav_sr != sr:
            raise ValueError(f"wav is {wav_sr} Hz, config {sr} Hz")
        audio = audio[:n]
    else:
        audio = synthetic_clips(n_clips=1, length=max(n, 4 * 16000),
                                sr=sr)[0][:n]
    mel = mel_spectrogram(audio, data_cfg)[None]           # [1, frames, n]

    state = trainer.create_train_state(model, trainer.TrainConfig(), device)
    _, it = trainer.load_checkpoint(args.checkpoint_dir, args.iteration,
                                    state)
    model.eval()
    print(f"restored iteration {it}", flush=True)
    A = model.n_out_channels
    cond = conditioning(model, mel, device)
    T = min(cond.shape[0], len(audio))          # the scored samples
    y_true = mu_law_encode_np(np.clip(audio[:T], -1, 1), A)[None]
    bits = teacher_forced_bits(model, cond[:T].contiguous(), y_true, device)
    print(f"teacher-forced bits/sample: {bits:.3f} (uniform = "
          f"{np.log2(A):.1f})", flush=True)

    y = generate(model, cond, device, fused=args.fused)
    gen = mu_law_decode_np(y[0], A)
    out = args.output or os.path.join(args.checkpoint_dir, "eval_gen.wav")
    write_wav(out, gen, sr)
    src_hz, gen_hz = dominant_hz(audio[:T], sr), dominant_hz(gen, sr)
    rms = (float(np.sqrt(np.mean(audio[:T] ** 2))),
           float(np.sqrt(np.mean(gen ** 2))))
    print(f"dominant frequency: source {src_hz:.1f} Hz, generated "
          f"{gen_hz:.1f} Hz", flush=True)
    print(f"rms: source {rms[0]:.3f}, generated {rms[1]:.3f}", flush=True)
    print(f"wrote {out}", flush=True)
    return {"iteration": it, "bits_per_sample": bits, "samples": int(T),
            "source_hz": src_hz, "generated_hz": gen_hz, "rms": rms,
            "output": out}


def main(argv=None) -> None:
    evaluate(argv)


if __name__ == "__main__":
    main()
