"""The port's command-line chain on the CPU at the tiny size of
`tests/test_train.py`: `nvw-torch-train` (`train/cli.py`) writes
checkpoints, also from a two-process model-parallel run,
`tools/mel2samp.py` turns a wav into a mel, and `tools/inference.py`
vocodes that mel from the checkpoint into a wav of the mel's length.
Everything is made here (synthetic audio); nothing is downloaded."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from nv_wavenet_tpu_torch.tools import inference, mel2samp
from nv_wavenet_tpu_torch.train import cli, trainer
from nv_wavenet_tpu_torch.train.data import synthetic_clips, write_wav
from tests.test_train import TINY, TINY_DATA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def write_config(tmp_path, **train):
    cfg = {"train_config": {"output_directory": str(tmp_path / "ckpt"),
                            "num_iters": 4, "learning_rate": 1e-3,
                            "iters_per_checkpoint": 2, "batch_size": 2,
                            "seed": 1234, "checkpoint_path": "", **train},
           "data_config": {**TINY_DATA.__dict__, "synthetic": True},
           "dist_config": {"data_parallel": 1, "model_parallel": 1,
                           "seq_parallel": 1},
           "wavenet_config": dict(TINY)}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_then_mel2samp_then_inference(tmp_path, capsys):
    config = write_config(tmp_path)
    state, losses = cli.main(["-c", config, "--device", "cpu"])
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["it_2", "it_4"]
    assert "final loss" in capsys.readouterr().out

    wav = tmp_path / "clip.wav"
    write_wav(str(wav), synthetic_clips(n_clips=1, length=600, seed=5)[0],
              TINY_DATA.sampling_rate)
    (tmp_path / "wavs.txt").write_text(f"{wav}\n")
    mel2samp.main(["-f", str(tmp_path / "wavs.txt"), "-o",
                   str(tmp_path / "mels"), "-c", config])
    mel_path = tmp_path / "mels" / "clip.npy"
    mel = np.load(mel_path)
    assert mel.shape == (600 // TINY_DATA.hop_length + 1,
                         TINY_DATA.n_mel_channels)

    (tmp_path / "mels.txt").write_text(f"{mel_path}\n")
    written = inference.main(["-c", str(tmp_path / "ckpt"), "-f",
                              str(tmp_path / "mels.txt"), "-o",
                              str(tmp_path / "out"), "--config", config,
                              "--device", "cpu"])
    assert written == [str(tmp_path / "out" / "audio_0.wav")]
    sr, audio = wavfile.read(written[0])
    assert sr == TINY_DATA.sampling_rate
    assert audio.shape == (mel.shape[0] * TINY["upsamp_stride"],)
    assert audio.dtype == np.int16


def test_resume_and_epoch_schedule(tmp_path, capsys):
    config = write_config(tmp_path)
    cli.main(["-c", config, "--device", "cpu", "-n", "2"])
    resumed = write_config(tmp_path, checkpoint_path=str(tmp_path / "ckpt"),
                           num_iters=3)
    _, losses = cli.main(["-c", resumed, "--device", "cpu"])
    assert len(losses) == 1   # iteration 2 only
    assert "resumed from" in capsys.readouterr().out
    epochs = write_config(tmp_path, num_iters=None, epochs=2,
                          output_directory="")
    _, losses = cli.main(["-c", epochs, "--device", "cpu"])
    assert len(losses) == 2 * (4 // 2)   # 4 synthetic clips, batch 2
    assert "epoch schedule: 2 epochs x 2 steps" in capsys.readouterr().out


def test_cli_rejects_what_it_does_not_run(tmp_path):
    """A mesh whose data x model x seq differs from the process count
    raises, naming the three axes; so does the card where there is none."""
    config = json.loads(open(write_config(tmp_path)).read())
    for key in ("model_parallel", "seq_parallel"):
        bad = dict(config, dist_config=dict(config["dist_config"], **{key: 2}))
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=r"data_parallel=1 x "
                           r"model_parallel=\d x seq_parallel=\d = 2 needs "
                           r"as many processes .* got 1"):
            cli.main(["-c", str(path), "--device", "cpu"])
    dp = dict(config, dist_config=dict(config["dist_config"],
                                       data_parallel=2))
    (tmp_path / "dp.json").write_text(json.dumps(dp))
    with pytest.raises(ValueError, match="data_parallel=2"):
        cli.main(["-c", str(tmp_path / "dp.json"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            cli.main(["-c", str(tmp_path / "config.json")])
        with pytest.raises(RuntimeError, match="CUDA device"):
            inference.main(["--demo", "-o", str(tmp_path / "o"), "--config",
                            str(tmp_path / "config.json")])


def test_two_process_model_parallel_cli_writes_a_full_checkpoint(tmp_path):
    """nvw-torch-train with model_parallel 2 over two gloo processes on the
    CPU: rank 0 reports, the collective save writes one full checkpoint, a
    one-process model loads it, and it stays within one Adam step (2.1 x
    lr) a step of the one-process CLI's on the same batches."""
    port = free_port()
    sharded = write_config(tmp_path, num_iters=2, iters_per_checkpoint=2,
                           output_directory=str(tmp_path / "mp"))
    cfg = json.loads(open(sharded).read())
    cfg["dist_config"] = {"data_parallel": 1, "model_parallel": 2,
                          "seq_parallel": 1, "num_processes": 2,
                          "coordinator_address": f"127.0.0.1:{port}"}
    (tmp_path / "mp.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nv_wavenet_tpu_torch.train.cli", "-c",
         str(tmp_path / "mp.json"), "--device", "cpu", "--process_id",
         str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    assert "final loss" in outs[0] and "final loss" not in outs[1]
    assert sorted(os.listdir(tmp_path / "mp")) == ["it_2"]

    state = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(seed=7), "cpu")
    state, it = trainer.load_checkpoint(str(tmp_path / "mp"), None, state)
    assert it == 2
    one = write_config(tmp_path, num_iters=2, iters_per_checkpoint=2,
                       output_directory=str(tmp_path / "one"))
    want, _ = cli.main(["-c", one, "--device", "cpu"])
    got, want = state.module.state_dict(), want.module.state_dict()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=2 * 2.1 * 1e-3, err_msg=k)


def test_inference_demo_on_cpu(tmp_path, monkeypatch):
    """--demo: an untrained model on synthetic mels (the clips cut from 1 s
    to 300 samples: the plain path on the CPU takes ~3 ms a sample)."""
    made = []

    def short_clips(n_clips, length, sr):
        made.append((n_clips, length, sr))
        return synthetic_clips(n_clips=n_clips, length=300, sr=sr)

    monkeypatch.setattr(inference, "synthetic_clips", short_clips)
    written = inference.main(["--demo", "-o", str(tmp_path / "out"),
                              "--config", write_config(tmp_path),
                              "--device", "cpu", "-b", "2", "-s", "argmax"])
    assert made == [(2, 16000, TINY_DATA.sampling_rate)]
    assert len(written) == 2
    for path in written:
        sr, audio = wavfile.read(path)
        assert audio.shape == ((300 // TINY_DATA.hop_length + 1)
                               * TINY["upsamp_stride"],)
