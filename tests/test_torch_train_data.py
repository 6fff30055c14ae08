"""The port's data pipeline (`nv_wavenet_tpu_torch/train/data.py`, a numpy
copy) and mu-law codec (`nv_wavenet_tpu_torch/utils/mu_law.py`) against
the JAX package's: the same featurisation, segments and rank shards, exactly
(the same numpy operations); the torch mu-law encode exactly equal to the
numpy one and its decode within 1e-6 (float32 against numpy's float64)."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.train import data as jdata
from nv_wavenet_tpu.utils import mu_law as jmu
from nv_wavenet_tpu_torch.train import data as tdata
from nv_wavenet_tpu_torch.utils import mu_law as tmu
from tests.test_train import TINY_DATA

CFG = dict(segment_length=4000, filter_length=800, hop_length=200,
           win_length=800, n_mel_channels=80)


def test_config_and_filterbank_equal():
    d = {"segment_length": 3000, "sampling_rate": 22050, "mel_fmax": 7600.0}
    assert (tdata.data_config_from_json(d).__dict__
            == jdata.data_config_from_json(d).__dict__)
    for cfg in (CFG, TINY_DATA.__dict__):
        np.testing.assert_array_equal(
            tdata.mel_filterbank(tdata.DataConfig(**cfg)),
            jdata.mel_filterbank(jdata.DataConfig(**cfg)))


def test_mel_spectrogram_equal():
    clips = jdata.synthetic_clips(n_clips=2, length=9000, seed=3)
    for c_t, c_j in zip(tdata.synthetic_clips(n_clips=2, length=9000, seed=3),
                        clips):
        np.testing.assert_array_equal(c_t, c_j)
        np.testing.assert_array_equal(
            tdata.mel_spectrogram(c_t, tdata.DataConfig(**CFG)),
            jdata.mel_spectrogram(c_j, jdata.DataConfig(**CFG)))


@pytest.mark.parametrize("world", [1, 2])
def test_batches_and_rank_shards_equal(world):
    clips = jdata.synthetic_clips(n_clips=5, length=1200, seed=1)
    tds = tdata.Mel2Samp(clips, tdata.DataConfig(**TINY_DATA.__dict__), 7)
    jds = jdata.Mel2Samp(clips, TINY_DATA, 7)
    for rank in range(world):
        tb = tds.batches(2, rank, world)
        jb = jds.batches(2, rank, world)
        for _ in range(3):
            (tm, ta), (jm, ja) = next(tb), next(jb)
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(ta, ja)
            assert ta.dtype == ja.dtype == np.int32
        tds.rng, jds.rng = (np.random.RandomState(7),
                            np.random.RandomState(7))
    with pytest.raises(ValueError, match="rank"):
        next(tds.batches(2, rank=world, world_size=world))


@pytest.mark.parametrize("world,start_epoch", [(1, 0), (2, 1)])
def test_epoch_batches_equal(world, start_epoch):
    clips = jdata.synthetic_clips(n_clips=7, length=1200, seed=2)
    tds = tdata.Mel2Samp(clips, tdata.DataConfig(**TINY_DATA.__dict__), 5)
    jds = jdata.Mel2Samp(clips, TINY_DATA, 5)
    assert tds.steps_per_epoch(2, world) == jds.steps_per_epoch(2, world)
    for rank in range(world):
        got = list(tds.epoch_batches(2, 3, rank, world, start_epoch))
        want = list(jds.epoch_batches(2, 3, rank, world, start_epoch))
        assert len(got) == len(want) > 0
        for (tm, ta), (jm, ja) in zip(got, want):
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(ta, ja)


def test_short_clip_padded_equal():
    cfg = tdata.DataConfig(**CFG)
    t = tdata.Mel2Samp([np.ones(100, np.float32) * 0.1], cfg, seed=0)
    j = jdata.Mel2Samp([np.ones(100, np.float32) * 0.1],
                       jdata.DataConfig(**CFG), seed=0)
    for a, b in zip(t.sample(), j.sample()):
        np.testing.assert_array_equal(a, b)


def test_wav_round_trip(tmp_path):
    x = tdata.synthetic_clips(n_clips=1, length=4000)[0]
    path = str(tmp_path / "a.wav")
    tdata.write_wav(path, x, 16000)
    got, sr = tdata.load_wav(path)
    want, jsr = jdata.load_wav(path)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
    assert np.max(np.abs(got - x)) < 2e-3


def test_mu_law_numpy_equal_and_torch_matches():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.uniform(-1, 1, 4096), [-1.0, 0.0, 1.0]]
                       ).astype(np.float32)
    enc = tmu.mu_law_encode_np(x)
    np.testing.assert_array_equal(enc, jmu.mu_law_encode_np(x))
    np.testing.assert_array_equal(tmu.mu_law_decode_np(enc),
                                  jmu.mu_law_decode_np(enc))
    enc_t = tmu.mu_law_encode(torch.from_numpy(x))
    assert enc_t.dtype == torch.int32
    np.testing.assert_array_equal(enc_t.numpy(), enc)
    dec_t = tmu.mu_law_decode(enc_t)
    assert dec_t.dtype == torch.float32
    np.testing.assert_allclose(dec_t.numpy(), tmu.mu_law_decode_np(enc),
                               rtol=0, atol=1e-6)
    assert tmu.mu_law_encode_np(np.zeros(4)).tolist() == [128] * 4
    with pytest.raises(ValueError):
        tmu.mu_law_encode_np(np.array([1.5]))
    with pytest.raises(ValueError):
        tmu.mu_law_decode_np(np.array([256]))
