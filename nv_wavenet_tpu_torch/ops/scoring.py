"""Likelihood scoring: per-sample log-probabilities of given audio under the
model, by teacher forcing.

The port's counterpart of `nv_wavenet_tpu/ops/scoring.py`, with its three
scorers: the plain sequential loop (`score_teacher_forced`), the forced
kernel K2 (`score_teacher_forced_kernel`) and the time-parallel scorer
(`score_teacher_forced_parallel`).  Uses: held-out bits per sample and
regression checks of trained checkpoints.  Each runs on the device of
`params`: a CUDA device runs the kernels, the CPU the plain versions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.ops import persistent, scan_generate, score_parallel


def _inputs(params: Dict[str, torch.Tensor], cond, audio):
    """(cond [T-1, L, B, 2R] float32, audio [B, T] int32) on params' device."""
    dev = params["embed"].device
    audio = torch.as_tensor(audio, device=dev).to(torch.int32)
    Tm = audio.shape[1] - 1
    return torch.as_tensor(cond[:Tm], dtype=torch.float32, device=dev), audio


def _log_prob(logits: torch.Tensor, targets: torch.Tensor):
    """(logp [B, T-1], bits [B]) from za [T-1, B, A] and targets [T-1, B]."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, targets[..., None].long())[..., 0].T
    return logp, -logp.mean(dim=-1) / math.log(2.0)


def score_teacher_forced(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                         cond, audio) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample log p(audio[t] | audio[<t], cond) for t in [1, T), by the
    plain sequential loop (`scan_generate.generate` with forced_y and
    return_za) and log_softmax on the logits.

    cond: [T, L, B, 2R] conditioning (position t conditions the prediction
    of audio[t+1]); audio: [B, T] int mu-law bins.  Returns tensors (logp
    [B, T-1], bits_per_sample [B])."""
    cond, audio = _inputs(params, cond, audio)
    B = audio.shape[0]
    forced = audio[:, 1:].T                                   # [T-1, B]
    state = scan_generate.init_state(cfg, B, cond.device)._replace(
        y_cur=audio[:, 0].clone())
    sel = torch.zeros(forced.shape, dtype=torch.float32, device=cond.device)
    _, _, za = scan_generate.generate(params, state, cond, sel, cfg,
                                      forced_y=forced, return_za=True)
    return _log_prob(za, forced)


def score_teacher_forced_kernel(params: Dict[str, torch.Tensor],
                                cfg: WaveNetConfig, cond, audio,
                                chunk: Optional[int] = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """`score_teacher_forced` on the forced kernel K2 (the selector stream
    carries the symbols; the kernel emits the per-step distributions), in
    launches of `chunk` steps (default: one launch) that carry the state.

    Same arguments; returns numpy (logp [B, T-1], bits [B]).  The kernel
    emits fp32 probabilities, so logp = log(max(p, 1e-30)): a target whose
    probability underflows fp32 is floored at log(1e-30), where the
    log_softmax scorers resolve any tail."""
    cond, audio = _inputs(params, cond, audio)
    dev = cond.device
    B, T = audio.shape
    Tm = T - 1
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    forced = audio[:, 1:].T.to(torch.float32).contiguous()      # [T-1, B]
    gen = persistent.make_persistent_generator(cfg, B, mode="forced")
    ring = persistent.init_ring(cfg, B, dev)
    y_state = torch.stack([torch.full((B,), cfg.silence_bin, dtype=torch.int32,
                                      device=dev), audio[:, 0]])
    step = chunk or Tm
    p_seq = torch.cat([gen(params, t0, cond_pre[t0:t0 + step],
                           forced[t0:t0 + step], ring, y_state)[-1]
                       for t0 in range(0, Tm, step)])
    p = np.asarray(p_seq.cpu(), np.float64)                   # [T-1, B, A]
    tgt = audio[:, 1:].T.cpu().numpy()[..., None]
    p_tgt = np.take_along_axis(p, tgt, axis=-1)[..., 0].T     # [B, T-1]
    logp = np.log(np.maximum(p_tgt, 1e-30))
    bits = -logp.mean(axis=-1) / np.log(2.0)
    return logp.astype(np.float32), bits.astype(np.float32)


def score_teacher_forced_parallel(params: Dict[str, torch.Tensor],
                                  cfg: WaveNetConfig, cond, audio
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`score_teacher_forced` with the time dimension fully parallel: the
    time-parallel scorer (`ops/score_parallel.make_parallel_scorer`) from
    the silent start state, log_softmax on its logits.  Returns tensors
    (logp [B, T-1], bits [B])."""
    cond, audio = _inputs(params, cond, audio)
    B = audio.shape[0]
    scorer = score_parallel.make_parallel_scorer(cfg, B, return_za=True)
    ring = persistent.init_ring(cfg, B, cond.device)
    y_state = torch.stack([torch.full_like(audio[:, 0], cfg.silence_bin),
                           audio[:, 0]])
    forced = audio[:, 1:].T
    za = scorer(params, 0, cond, forced, ring, y_state)[-1]
    return _log_prob(za, forced)
