"""The port's user tools on the CPU: the hardware self-test
`tools/verify_drive.py` (`nvw-torch-verify`) and the checkpoint evaluation
`tools/eval_checkpoint.py` (`nvw-torch-eval-checkpoint`).

  * `verify_drive.main(device="cpu")` passes every check at the JAX drive's
    config, and an engine broken on purpose (every launch restarted at
    sample 0) makes it exit nonzero;
  * the evaluation's teacher-forced bits per sample (the engine's scorer)
    for parameters carried from the JAX model by `params_from_flax` equal
    that model's cross-entropy / ln 2 on the same batch within 1e-5
    relative, and its generation from the mel's conditioning equals the
    JAX scan's integers;
  * the hermetic wav -> mel -> train -> eval chain of
    tests/test_real_wav_e2e.py at a tiny size."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nv_wavenet_tpu.engine.wavenet_infer import _selector_stream
from nv_wavenet_tpu.models import wavenet as jwn
from nv_wavenet_tpu.ops import scan_generate as jsg
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import wavenet as twn
from nv_wavenet_tpu_torch.tools import eval_checkpoint, mel2samp, verify_drive
from nv_wavenet_tpu_torch.train import cli
from nv_wavenet_tpu_torch.train.data import synthetic_clips, write_wav

from tests.test_real_wav_e2e import DATA_C, WAVENET_C
from tests.test_train import TINY, tiny_batch

BITS_RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_verify_drive_passes_on_cpu(one_thread, capsys):
    assert verify_drive.main([], device="cpu") == 0
    out = capsys.readouterr().out
    assert "ALL HARDWARE CHECKS PASSED" in out and "FAILED" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            verify_drive.main([])


def test_verify_drive_fails_on_a_broken_engine(one_thread, monkeypatch,
                                               capsys):
    """A mutant engine that restarts every launch at sample 0 (a chunk
    boundary bug: the state resets and the selectors repeat): the first
    exact check fails and the drive exits 1."""
    run = WaveNetInfer._run_partial_device
    monkeypatch.setattr(WaveNetInfer, "_run_partial_device",
                        lambda self, t0, n, *a: run(self, 0, n, *a))
    with pytest.raises(SystemExit) as err:
        verify_drive.main(["--device", "cpu"])
    assert err.value.code == 1
    assert "FAILED: PERSISTENT ragged run_chunks" in capsys.readouterr().out


@pytest.fixture(scope="module")
def carried():
    """The JAX model's parameters from PRNGKey(0), the port's model holding
    them, a tiny batch and the JAX logits on it."""
    mel, audio = tiny_batch()
    jmodel = jwn.WaveNetTrain(**TINY)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                         jnp.asarray(audio))
    tmodel = twn.WaveNetTrain(**TINY)
    tmodel.load_state_dict(twn.params_from_flax(
        jax.tree.map(np.asarray, params)))
    tmodel.eval()
    logits = np.asarray(jmodel.apply(params, jnp.asarray(mel),
                                     jnp.asarray(audio)), np.float64)
    return dict(mel=mel, audio=audio, jmodel=jmodel, params=params,
                tmodel=tmodel, logits=logits)


def test_eval_bits_equal_the_jax_cross_entropy(carried):
    """logits[:, t] predict audio[:, t] (the right shift): the mean CE over
    t >= 1, in bits, against the scorer's from the state (silence,
    audio[:, 0])."""
    mel, audio, logits = carried["mel"], carried["audio"], carried["logits"]
    z = logits[:, 1:] - logits[:, 1:].max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    tgt = audio[:, 1:, None].astype(np.int64)
    ce_bits = -np.take_along_axis(logp, tgt, -1).mean() / math.log(2.0)
    cond = eval_checkpoint.conditioning(carried["tmodel"], mel, CPU)
    T = audio.shape[1]
    bits = eval_checkpoint.teacher_forced_bits(
        carried["tmodel"], cond[:T].contiguous(), audio, CPU)
    assert abs(bits - ce_bits) <= BITS_RTOL * ce_bits, (bits, ce_bits)


def test_eval_generation_equals_the_jax_scan(carried):
    """Generation from the mel's conditioning (the default stream of seed
    0) against the JAX scan on the JAX model's export: 0 mismatches."""
    tmodel, mel = carried["tmodel"], carried["mel"][:1]
    cond = eval_checkpoint.conditioning(tmodel, mel, CPU)[:96].contiguous()
    T, _, B, _ = cond.shape
    y = eval_checkpoint.generate(tmodel, cond, CPU, seed=0)
    cfg = jwn.config_of(carried["jmodel"])
    canon = jwn.export_canonical(carried["params"], carried["jmodel"])
    _, y_jax, _ = jsg.generate(canon, jsg.init_state(cfg, B), cond.numpy(),
                               _selector_stream(0, 0, T, B), cfg)
    assert y.shape == (B, T)
    assert int((y != np.asarray(y_jax)).sum()) == 0


def test_wav_to_training_to_eval(tmp_path, one_thread, capsys):
    """wav files -> mel2samp -> training from training_files -> the
    evaluation on a wav: finite bits per sample, a generated wav."""
    clips = synthetic_clips(n_clips=3, length=512)
    paths = []
    for i, c in enumerate(clips):
        paths.append(str(tmp_path / f"clip_{i}.wav"))
        write_wav(paths[-1], c, sr=16000)
    flist = tmp_path / "files.txt"
    flist.write_text("\n".join(paths) + "\n")
    config = {"train_config": {"output_directory": str(tmp_path / "ckpt"),
                               "num_iters": 2, "learning_rate": 1e-3,
                               "iters_per_checkpoint": 2, "batch_size": 2,
                               "seed": 7, "checkpoint_path": ""},
              "data_config": dict(DATA_C, training_files=str(flist)),
              "dist_config": {"data_parallel": 1, "model_parallel": 1},
              "wavenet_config": WAVENET_C}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    mel2samp.main(["-f", str(flist), "-o", str(tmp_path / "mels"), "-c",
                   str(cfg_path)])
    assert len(os.listdir(tmp_path / "mels")) == 3
    _, losses = cli.main(["-c", str(cfg_path), "--device", "cpu"])
    assert len(losses) == 2
    out = tmp_path / "gen.wav"
    res = eval_checkpoint.evaluate([
        "-c", str(tmp_path / "ckpt"), "-w", paths[0], "-o", str(out),
        "--config", str(cfg_path), "--seconds", "0.02", "--device", "cpu"])
    assert res["iteration"] == 2 and out.exists()
    assert np.isfinite(res["bits_per_sample"]) and 0 < res[
        "bits_per_sample"] < 16
    assert res["samples"] == 320
    assert "teacher-forced bits/sample" in capsys.readouterr().out
