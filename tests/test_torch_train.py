"""The port's trainer (`nv_wavenet_tpu_torch/train/trainer.py`) against
the JAX package's (`nv_wavenet_tpu/train/trainer.py`) at the tiny size of
`tests/test_train.py`, on the CPU.

Tolerances: the loss and every gradient within rtol 1e-4 of
`jax.value_and_grad` (the convolutions and their transposes sum in another
order; atol 1e-7 for entries that cancel to ~0); one Adam step on the same
gradients within 1e-6 of optax's (the same update formula, rounded in
another order); two gloo processes under DistributedDataParallel within
1e-6 of one process on the whole batch (the gradient's average over ranks
rounds differently from one backward over the batch); a resumed run equal
to the uninterrupted one within rtol 1e-6 (the same operations on the same
inputs)."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nv_wavenet_tpu.models import wavenet as jwn
from nv_wavenet_tpu.train import trainer as jtrainer
from nv_wavenet_tpu_torch.models import wavenet as twn
from nv_wavenet_tpu_torch.train import trainer
from nv_wavenet_tpu_torch.train.data import Mel2Samp, synthetic_clips
from tests.test_train import TINY, TINY_DATA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_batch(batch=2, seed=0):
    ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024, seed=seed),
                  TINY_DATA, seed=seed)
    return next(ds.batches(batch))


@pytest.fixture(scope="module")
def jax_case():
    """The JAX loss and gradients at PRNGKey(1)'s parameters, and the port's
    model holding the same parameters."""
    mel, audio = tiny_batch()
    jm = jwn.WaveNetTrain(**TINY)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(mel),
                     jnp.asarray(audio))

    def loss_fn(p):
        return jtrainer.cross_entropy_loss(
            jm.apply(p, jnp.asarray(mel), jnp.asarray(audio)),
            jnp.asarray(audio))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tm = twn.WaveNetTrain(**TINY)
    tm.load_state_dict(twn.params_from_flax(jax.tree.map(np.asarray,
                                                         params)))
    return dict(mel=mel, audio=audio, params=params, loss=float(loss),
                grads=twn.params_from_flax(jax.tree.map(np.asarray, grads)),
                jgrads=grads, tmodel=tm)


def test_loss_and_gradients_match_jax(jax_case):
    tm = jax_case["tmodel"]
    tm.zero_grad()
    loss = trainer.cross_entropy_loss(
        tm(torch.from_numpy(jax_case["mel"]),
           torch.from_numpy(jax_case["audio"])),
        torch.from_numpy(jax_case["audio"]))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jax_case["loss"], rel=1e-4)
    params = dict(tm.named_parameters())
    assert set(params) == set(jax_case["grads"])
    for k, g in jax_case["grads"].items():
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_one_adam_step_matches_optax(jax_case):
    """optax.adam's defaults and torch's Adam as create_train_state builds
    it, one step from the same parameters on the same gradients."""
    lr = 1e-3
    tx = optax.adam(lr)
    params = jax_case["params"]

    @jax.jit
    def adam_step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    want = twn.params_from_flax(jax.tree.map(
        np.asarray, adam_step(params, jax_case["jgrads"])))
    tm = twn.WaveNetTrain(**TINY)
    state = trainer.create_train_state(
        tm, trainer.TrainConfig(learning_rate=lr), "cpu")
    tm.load_state_dict(twn.params_from_flax(jax.tree.map(np.asarray,
                                                         params)))
    for k, p in tm.named_parameters():
        p.grad = jax_case["grads"][k].clone()
    state.optimizer.step()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_loss_decreases_over_20_steps():
    ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024), TINY_DATA)
    _, losses = trainer.train(trainer.create_model(TINY),
                              trainer.TrainConfig(learning_rate=3e-3,
                                                  batch_size=2),
                              ds.batches(2), num_iters=20, log_every=100,
                              device="cpu")
    assert len(losses) == 20 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
    assert losses[0] < 6.0   # ~ln(256) = 5.55 at init


def test_create_train_state_is_seeded():
    a = trainer.create_train_state(twn.WaveNetTrain(**TINY),
                                   trainer.TrainConfig(seed=7), "cpu")
    b = trainer.create_train_state(twn.WaveNetTrain(**TINY),
                                   trainer.TrainConfig(seed=7), "cpu")
    c = trainer.create_train_state(twn.WaveNetTrain(**TINY),
                                   trainer.TrainConfig(seed=8), "cpu")
    sa, sb, sc = (s.module.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.weight"], sc["embed.weight"])


def test_checkpoint_round_trip(tmp_path):
    mel, audio = (torch.from_numpy(a) for a in tiny_batch())
    state = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(), "cpu")
    trainer.train_step(state, mel, audio)
    path = trainer.save_checkpoint(str(tmp_path), state, 1)
    assert os.path.isfile(path)
    fresh = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(seed=99), "cpu")
    restored, it = trainer.load_checkpoint(str(tmp_path), None, fresh)
    assert it == 1 and restored.step == 1
    want, got = state.module.state_dict(), restored.module.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
    # the optimizer's moments too: one more step stays equal
    l1 = trainer.train_step(state, mel, audio)
    l2 = trainer.train_step(restored, mel, audio)
    assert float(l1) == float(l2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no it_"):
        trainer.load_checkpoint(str(tmp_path / "empty"), None, fresh)


def test_resume_reproduces_the_uninterrupted_losses(tmp_path):
    model = trainer.create_model(TINY)
    cfg = trainer.TrainConfig(learning_rate=1e-3, iters_per_checkpoint=3)

    def batches():
        ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024), TINY_DATA,
                      seed=0)
        return ds.batches(2)

    _, full = trainer.train(model, cfg, batches(), 6, log_every=1000,
                            ckpt_dir=str(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["it_3", "it_6"]
    b = batches()
    for _ in range(3):   # the batches consumed before the checkpoint
        next(b)
    _, resumed = trainer.train(model, cfg, b, 6, log_every=1000,
                               resume_dir=str(tmp_path), resume_iteration=3,
                               device="cpu")
    assert len(resumed) == 3
    np.testing.assert_allclose(full[3:], resumed, rtol=1e-6)


def test_metrics_jsonl_sink(tmp_path):
    ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024), TINY_DATA)
    tcfg = trainer.TrainConfig(batch_size=2, with_tensorboard=True)
    trainer.train(trainer.create_model(TINY), tcfg, ds.batches(2),
                  num_iters=3, ckpt_dir=str(tmp_path), log_every=1,
                  device="cpu")
    lines = [json.loads(l) for l in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [l["iteration"] for l in lines] == [0, 1, 2]
    assert all(np.isfinite(l["loss"]) and l["elapsed_s"] >= 0
               for l in lines)


def test_prefetch_propagates_worker_errors():
    def bad_batches():
        yield (np.zeros((2, 4), np.float32),)
        raise RuntimeError("boom")

    it = trainer._device_prefetch(bad_batches(), "cpu")
    (first,) = next(it)
    assert isinstance(first, torch.Tensor) and first.shape == (2, 4)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


@pytest.mark.parametrize("precision,tf32", [("highest", False),
                                            ("default", True)])
def test_train_step_sets_and_restores_the_tf32_flags(precision, tf32):
    """TF32 is off (highest) or on (default) in cuDNN and cuBLAS through
    the forward and the backward of a step, and both flags are as before
    after it."""
    seen = []

    def flags(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    model = trainer.create_model(dict(TINY, precision=precision))
    state = trainer.create_train_state(model, trainer.TrainConfig(), "cpu")
    model.conv_end.register_forward_hook(flags)
    model.embed.weight.register_hook(flags)     # runs in the backward
    mel, audio = (torch.from_numpy(a) for a in tiny_batch())
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for start in (True, False):
            torch.backends.cudnn.allow_tf32 = start
            torch.backends.cuda.matmul.allow_tf32 = start
            seen.clear()
            loss = trainer.train_step(state, mel, audio)
            assert np.isfinite(float(loss))
            assert seen == [(tf32, tf32)] * 2
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (start, start)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_train_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        trainer.create_train_state(trainer.create_model(TINY),
                                   trainer.TrainConfig())


# one rank of the DDP test: train_step on its half of the batch, then its
# loss, parameters and gradients to <out>/rank<r>.pt
DDP_WORKER = """
import sys, torch
torch.set_num_threads(1)
from nv_wavenet_tpu_torch.parallel.mesh import initialize_multihost
from nv_wavenet_tpu_torch.train import trainer
rank, port, out, tiny = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
initialize_multihost("127.0.0.1:" + port, 2, rank, device="cpu")
batch = torch.load(out + "/batch.pt")
state = trainer.create_train_state(trainer.create_model(eval(tiny)),
                                   trainer.TrainConfig(), "cpu")
assert isinstance(state.model, torch.nn.parallel.DistributedDataParallel)
lo, hi = 2 * rank, 2 * rank + 2
loss = trainer.train_step(state, batch["mel"][lo:hi], batch["audio"][lo:hi])
torch.save({"loss": loss, "params": state.module.state_dict(),
            "grads": {k: p.grad for k, p in state.module.named_parameters()}},
           out + f"/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def test_two_process_ddp_equals_one_process_on_the_whole_batch(tmp_path):
    mel, audio = (torch.from_numpy(a) for a in tiny_batch(batch=4))
    torch.save({"mel": mel, "audio": audio}, tmp_path / "batch.pt")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", DDP_WORKER, str(r), port, str(tmp_path),
         repr(TINY)], cwd=REPO, env=env, stdout=subprocess.PIPE,
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
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    state = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(), "cpu")
    loss = trainer.train_step(state, mel, audio)
    want_p = state.module.state_dict()
    want_g = {k: p.grad for k, p in state.module.named_parameters()}
    for got in ranks:
        assert float(got["loss"]) == pytest.approx(float(loss), abs=1e-6)
        for k in want_p:
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       want_p[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        for k in want_g:
            np.testing.assert_allclose(got["grads"][k].numpy(),
                                       want_g[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
