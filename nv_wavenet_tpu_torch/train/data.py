"""Dataset / featurization: mel-spectrogram conditioning + mu-law targets.

The port's copy of `nv_wavenet_tpu/train/data.py`, numpy only (the port
never imports the JAX package).  Equivalent of the reference's
`Mel2SampOnehot` dataset (`pytorch/mel2samp_onehot.py:44-94`), which
delegates STFT/mel extraction to the Tacotron2 submodule.  Here the whole
featurization is self-contained numpy (no librosa): hann-window STFT + a
Slaney-style mel filterbank, with the reference's config defaults
(`pytorch/config.json`: filter 800 / hop 200 / win 800, 80 mels, 16 kHz,
segment 16000).

Also provides a synthetic-audio generator so training and integration tests
run hermetically without wav assets.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from nv_wavenet_tpu_torch.utils.mu_law import MAX_WAV_VALUE, mu_law_encode_np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    segment_length: int = 16000
    mu_quantization: int = 256
    filter_length: int = 800
    hop_length: int = 200
    win_length: int = 800
    sampling_rate: int = 16000
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


def data_config_from_json(d: dict) -> DataConfig:
    """Build a DataConfig from a config.json `data_config` section — the ONE
    mapping used by every CLI (train, mel2samp, inference, eval), so no tool
    silently drops a field like sampling_rate or mel_fmax."""
    return DataConfig(
        segment_length=d.get("segment_length", 16000),
        mu_quantization=d.get("mu_quantization", 256),
        filter_length=d.get("filter_length", 800),
        hop_length=d.get("hop_length", 200),
        win_length=d.get("win_length", 800),
        sampling_rate=d.get("sampling_rate", 16000),
        n_mel_channels=d.get("n_mel_channels", 80),
        mel_fmin=d.get("mel_fmin", 0.0),
        mel_fmax=d.get("mel_fmax", 8000.0),
    )


def _hz_to_mel(f):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_t = f >= min_log_hz
    mel = np.where(log_t, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10)
                                                     / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_t = m >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(cfg: DataConfig) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalized triangular mel filterbank."""
    n_fft = cfg.filter_length
    fft_freqs = np.linspace(0, cfg.sampling_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(cfg.mel_fmin), _hz_to_mel(cfg.mel_fmax),
                          cfg.n_mel_channels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((cfg.n_mel_channels, len(fft_freqs)))
    for i in range(cfg.n_mel_channels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down))
        # Slaney normalization: constant energy per channel
        fb[i] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def stft_magnitude(audio: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """Centered hann-window STFT magnitudes: [frames, n_fft//2+1]."""
    n_fft, hop, win = cfg.filter_length, cfg.hop_length, cfg.win_length
    pad = n_fft // 2
    # numpy "reflect" handles pad > len via multiple reflections (the native
    # C++ pipeline folds indices identically); only the degenerate 1-D case
    # needs no guard — np.pad reflects a singleton as a constant
    x = np.pad(audio, (pad, pad), mode="reflect")
    window = np.hanning(win + 1)[:-1].astype(np.float32)
    if win < n_fft:
        window = np.pad(window, ((n_fft - win) // 2,) * 2)
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop, x.strides[0])).copy()
    spec = np.fft.rfft(frames * window, axis=-1)
    return np.abs(spec).astype(np.float32)


def mel_spectrogram(audio: np.ndarray, cfg: DataConfig,
                    fb: Optional[np.ndarray] = None) -> np.ndarray:
    """audio in [-1, 1] -> log-compressed mel [frames, n_mels] (the dynamic
    range compression used by the Tacotron2 STFT the reference imports)."""
    if fb is None:
        fb = mel_filterbank(cfg)
    mag = stft_magnitude(audio, cfg)
    mel = mag @ fb.T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def _check_rank(rank: int, world_size: int):
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")


class Mel2Samp:
    """Random fixed-length segments -> (mel, mu-law targets).

    Mirrors `Mel2SampOnehot`: pad short clips, random segment choice, mu-law
    encode targets (`mel2samp_onehot.py:81-90`)."""

    def __init__(self, audio_clips: List[np.ndarray], data_cfg: DataConfig,
                 seed: int = 0):
        self.cfg = data_cfg
        self.clips = audio_clips
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.fb = mel_filterbank(data_cfg)

    def sample_clip(self, index: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Featurize a random fixed-length segment of clip `index` (random
        segment start + short-clip padding, `mel2samp_onehot.py:81-87`)."""
        if rng is None:
            rng = self.rng
        cfg = self.cfg
        audio = self.clips[index]
        seg = cfg.segment_length
        if len(audio) >= seg:
            start = rng.randint(len(audio) - seg + 1)
            audio = audio[start:start + seg]
        else:
            audio = np.pad(audio, (0, seg - len(audio)))
        mel = mel_spectrogram(audio, cfg, self.fb)
        target = mu_law_encode_np(np.clip(audio, -1, 1), cfg.mu_quantization)
        return mel, target.astype(np.int32)

    def sample(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.sample_clip(self.rng.randint(len(self.clips)))

    def batches(self, batch_size: int, rank: int = 0, world_size: int = 1
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite random sampler (iteration-count-driven training).

        Under multi-process training each rank must draw a DISTINCT stream
        (the DistributedSampler analog for the infinite sampler): the clip
        choice and segment start come from a per-rank decorrelated
        RandomState, so the staged global batch is world_size distinct
        shards rather than world_size copies of the same data."""
        _check_rank(rank, world_size)
        rng = (self.rng if world_size == 1 else np.random.RandomState(
            (self.seed + 0x9E3779B9 * (rank + 1)) & 0x7FFFFFFF))
        while True:
            mels, targets = zip(
                *[self.sample_clip(rng.randint(len(self.clips)), rng)
                  for _ in range(batch_size)])
            yield np.stack(mels), np.stack(targets)

    def steps_per_epoch(self, batch_size: int, world_size: int = 1) -> int:
        """Batches per dataset pass per process (drop_last=True semantics,
        `train.py:113-117`)."""
        return len(self.clips) // world_size // batch_size

    def epoch_batches(self, batch_size: int, epochs: Optional[int] = None,
                      rank: int = 0, world_size: int = 1,
                      start_epoch: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Epoch/dataset-pass semantics (reference `train.py:129-136`): each
        epoch visits every clip once in a deterministically re-shuffled order
        (the DistributedSampler set_epoch analog: shuffle keyed on the epoch
        index, identical across processes), shards the order across processes,
        and drops the ragged final batch (DataLoader drop_last=True).

        epochs=None iterates forever; start_epoch implements the reference's
        resume epoch offset (`train.py:127`).  Segment crops are keyed on
        (seed, epoch, clip), not drawn from the shared stream — so a resume
        at epoch k reproduces epoch k's exact batches, not just its shuffle
        order."""
        _check_rank(rank, world_size)
        e = start_epoch
        while epochs is None or e < epochs:
            order = np.random.RandomState(
                (self.seed + 0x9E3779B9 * e) & 0x7FFFFFFF
            ).permutation(len(self.clips))
            # equal per-rank shards (truncate the ragged remainder) so every
            # rank yields exactly steps_per_epoch batches and epoch boundaries
            # stay in lockstep across processes
            order = order[rank::world_size][:len(order) // world_size]
            n_full = len(order) // batch_size * batch_size
            for i in range(0, n_full, batch_size):
                mels, targets = zip(*[
                    self.sample_clip(j, np.random.RandomState(
                        (self.seed + 0x9E3779B9 * e + 0x85EBCA6B * int(j))
                        & 0x7FFFFFFF))
                    for j in order[i:i + batch_size]])
                yield np.stack(mels), np.stack(targets)
            e += 1


def synthetic_clips(n_clips: int = 4, length: int = 32000, sr: int = 16000,
                    seed: int = 0) -> List[np.ndarray]:
    """Deterministic synthetic audio (mixed sinusoids + noise) for hermetic
    training/integration tests."""
    rng = np.random.RandomState(seed)
    clips = []
    for _ in range(n_clips):
        t = np.arange(length) / sr
        f0 = rng.uniform(80, 400)
        sig = (0.5 * np.sin(2 * np.pi * f0 * t)
               + 0.25 * np.sin(2 * np.pi * 2.01 * f0 * t)
               + 0.05 * rng.randn(length))
        clips.append((sig / np.max(np.abs(sig)) * 0.95).astype(np.float32))
    return clips


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a wav into [-1, 1] float32 (scipy backend, like
    `pytorch/utils.py:33-38`)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # stereo/multichannel: downmix to mono
        data = data.mean(axis=1).astype(np.float32)
    return data, sr


def write_wav(path: str, audio: np.ndarray, sr: int = 16000):
    from scipy.io import wavfile
    wavfile.write(path, sr, (np.clip(audio, -1, 1) * MAX_WAV_VALUE * 0.999)
                  .astype(np.int16))
