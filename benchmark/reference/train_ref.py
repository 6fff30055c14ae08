"""Plain reference of a WaveNet training step: the data pipeline's
features, the teacher-forced forward, the loss, its gradients and Adam.

A frozen copy, in plain torch and numpy, of the model of NVIDIA's
nv-wavenet `pytorch/wavenet.py` and its trainer `pytorch/train.py`, as the
port states them (`models/wavenet.py`, `train/trainer.py`,
`train/data.py`, `utils/mu_law.py`), importing none of them:

  * features: a centered hann-window STFT, a Slaney mel filterbank, log
    compression; targets: mu-law bins of the segment;
  * segments: the infinite random sampler of the data pipeline, whose
    draws (a clip, then a start) come from numpy's legacy generator keyed
    on the data seed and the data rank;
  * forward: the mel upsampled by a transposed conv and cropped, one 1x1
    conv to every layer's conditioning, the embedding, L causal dilated
    convs (k=2) with the gate, residual and skip 1x1 convs, relu, conv_out,
    relu, conv_end, and the one-step shift of the logits;
  * the mean cross entropy, autograd's gradients, and Adam (b1 0.9, b2
    0.999, eps 1e-8) written out.

Everything runs in float32 with TF32 off in cuDNN and cuBLAS.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """TF32 off in cuDNN and cuBLAS inside the block; both restored."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(d: dict) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] Slaney-normalised triangles."""
    n_fft, sr, n_mels = d["filter_length"], d["sampling_rate"], \
        d["n_mel_channels"]
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(d["mel_fmin"]),
                                _hz_to_mel(d["mel_fmax"]), n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb.astype(np.float32)


def log_mel(audio: np.ndarray, d: dict, fb: np.ndarray) -> np.ndarray:
    """audio [T] -> log mel [frames, n_mels], frames = T // hop + 1."""
    n_fft, hop, win = d["filter_length"], d["hop_length"], d["win_length"]
    x = np.pad(audio, (n_fft // 2, n_fft // 2), mode="reflect")
    window = np.hanning(win + 1)[:-1].astype(np.float32)
    if win < n_fft:
        window = np.pad(window, ((n_fft - win) // 2,) * 2)
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(x[idx] * window, axis=-1)).astype(np.float32)
    return np.log(np.clip(mag @ fb.T, 1e-5, None)).astype(np.float32)


def mu_law_bins(x: np.ndarray, mu_quantization: int) -> np.ndarray:
    mu = mu_quantization - 1.0
    x_mu = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return ((x_mu + 1) / 2 * mu + 0.5).astype(np.int64)


def batches(clips: List[np.ndarray], d: dict, seed: int, batch: int,
            rank: int, world: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The data rank's stream of (mel [b, frames, n_mels], bins [b, T]):
    for each row a clip index, then a segment start, from numpy's legacy
    generator (seeded with `seed` in one process; with a per-rank seed
    across ranks)."""
    rng = (np.random.RandomState(seed) if world == 1 else
           np.random.RandomState((seed + 0x9E3779B9 * (rank + 1))
                                 & 0x7FFFFFFF))
    fb, seg = mel_filterbank(d), d["segment_length"]
    while True:
        mels, bins = [], []
        for _ in range(batch):
            audio = clips[rng.randint(len(clips))]
            if len(audio) >= seg:
                start = rng.randint(len(audio) - seg + 1)
                audio = audio[start:start + seg]
            else:
                audio = np.pad(audio, (0, seg - len(audio)))
            mels.append(log_mel(audio, d, fb))
            bins.append(mu_law_bins(np.clip(audio, -1, 1),
                                    d["mu_quantization"]))
        yield np.stack(mels), np.stack(bins)


# ---------------------------------------------------------------------------
# the model, the loss, Adam
# ---------------------------------------------------------------------------

def logits(p: Dict[str, torch.Tensor], w: dict, mel: torch.Tensor,
           audio: torch.Tensor) -> torch.Tensor:
    """mel [B, frames, C], audio [B, T] bins -> logits [B, T, A], where
    logits[:, t] predicts audio[:, t]."""
    L, R = w["n_layers"], w["n_residual_channels"]
    T = audio.shape[1]
    up = F.conv_transpose1d(mel.transpose(1, 2), p["upsample.weight"],
                            p["upsample.bias"], stride=w["upsamp_stride"])
    cond = F.conv1d(up[:, :, :T], p["cond_layer.weight"],
                    p["cond_layer.bias"])
    x = p["embed.weight"][audio.long()].transpose(1, 2)
    out = None
    for i, d in enumerate(dilations(L, w["max_dilation"])):
        z = F.conv1d(F.pad(x, (d, 0)), p[f"dilate_layers.{i}.weight"],
                     p[f"dilate_layers.{i}.bias"], dilation=d) \
            + cond[:, 2 * R * i:2 * R * (i + 1)]
        h = torch.tanh(z[:, :R]) * torch.sigmoid(z[:, R:])
        if i < L - 1:
            x = F.conv1d(h, p[f"res_layers.{i}.weight"],
                         p[f"res_layers.{i}.bias"]) + x
        s = F.conv1d(h, p[f"skip_layers.{i}.weight"],
                     p[f"skip_layers.{i}.bias"])
        out = s if out is None else out + s
    out = F.conv1d(F.relu(out), p["conv_out.weight"])
    out = F.conv1d(F.relu(out), p["conv_end.weight"])
    return F.pad(out[..., :-1], (1, 0)).transpose(1, 2)


def dilations(num_layers: int, max_dilation: int) -> list:
    out, d = [], 1
    for _ in range(num_layers):
        out.append(d)
        d = 1 if d * 2 > max_dilation else d * 2
    return out


def loss_and_grads(p: Dict[str, torch.Tensor], w: dict, parts
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean cross entropy over every row of `parts` (a list of
    (mel, bins) tensor pairs of equal size, one a data rank) and its
    gradient, accumulated part by part."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    total = 0.0
    with full_fp32():
        for mel, bins in parts:
            z = logits(leaves, w, mel, bins)
            loss = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                                   bins.reshape(-1).long()) / len(parts)
            loss.backward()
            total += float(loss.detach())
    return total, {k: v.grad.detach() for k, v in leaves.items()}


class Adam:
    """Adam as torch.optim.Adam states it (no weight decay, no amsgrad)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t, self.m, self.v = 0, {}, {}

    def step(self, p: Dict[str, torch.Tensor],
             g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k in p:
            self.m[k] = self.b1 * self.m.get(k, 0.0) + (1 - self.b1) * g[k]
            self.v[k] = (self.b2 * self.v.get(k, 0.0)
                         + (1 - self.b2) * g[k] * g[k])
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            out[k] = p[k] - (self.lr / c1) * self.m[k] / denom
        return out


def reference_steps(p0: Dict[str, torch.Tensor], w: dict, lr: float,
                    steps: list) -> dict:
    """Run the steps (each a list of (mel, bins) parts) from p0: each
    step's loss, the first step's gradient and the parameters after the
    last."""
    opt, p = Adam(lr), dict(p0)
    losses, g1 = [], None
    for parts in steps:
        loss, g = loss_and_grads(p, w, parts)
        losses.append(loss)
        g1 = g if g1 is None else g1
        p = opt.step(p, g)
    return {"losses": losses, "grad1": g1, "params": p}
