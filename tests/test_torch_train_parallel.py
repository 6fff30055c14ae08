"""Tensor and sequence parallel training in the port (`train/sharding.py`,
`trainer.make_mesh` / `shard_train_state` / `make_sharded_train_step`) on
the CPU, at the tiny size of `tests/test_train.py`: a data x model x seq
step over eight gloo processes against `jax.value_and_grad` of the JAX
model at the same parameters (carried across by `params_from_flax`) and
against the port's one-process step on the whole batch.  The two meshes
mirror `tests/test_train.py::test_sharded_training_matches_single_device`
(data 4 x model 2) and `::test_seq_parallel_training_matches_single_device`
(2 x 2 x 2), with their tolerances: the loss within 1e-5, every gathered
gradient within rtol 1e-4 and atol 1e-6 (the shards sum in another order),
the parameters after one Adam step within 2.1 x lr (its first update is
~sign(g) lr, and a gradient near 0 may flip sign).  The collective
checkpoint loads into a one-process model bit for bit."""

import json
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nv_wavenet_tpu.models import wavenet as jwn
from nv_wavenet_tpu.train import trainer as jtrainer
from nv_wavenet_tpu_torch.models import wavenet as twn
from nv_wavenet_tpu_torch.tools import train_mesh_probe
from nv_wavenet_tpu_torch.train import sharding, trainer
from nv_wavenet_tpu_torch.train.data import (Mel2Samp,
                                             data_config_from_json,
                                             synthetic_clips)
from tests.test_train import TINY, TINY_DATA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
MESHES = {"data4_model2": (4, 2, 1), "data2_model2_seq2": (2, 2, 2)}


def tiny_batch(batch=4, seed=0):
    ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024, seed=seed),
                  TINY_DATA, seed=seed)
    return next(ds.batches(batch))


@pytest.fixture(scope="module")
def reference():
    """The JAX loss, gradients and one optax Adam step at PRNGKey(1)'s
    parameters, and the port's one-process step from the same parameters
    on the same batch of 4."""
    mel, audio = tiny_batch()
    jm = jwn.WaveNetTrain(**TINY)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(mel),
                     jnp.asarray(audio))

    def loss_fn(p):
        return jtrainer.cross_entropy_loss(
            jm.apply(p, jnp.asarray(mel), jnp.asarray(audio)),
            jnp.asarray(audio))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    after = optax.apply_updates(params, updates)
    full = twn.params_from_flax(jax.tree.map(np.asarray, params))

    state = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(learning_rate=LR),
                                       "cpu")
    trainer.load_full_state(state, full)
    mel_t, audio_t = torch.from_numpy(mel), torch.from_numpy(audio)
    one_loss = trainer.train_step(state, mel_t, audio_t)
    return dict(
        mel=mel_t, audio=audio_t, params=full,
        jax_loss=float(loss),
        jax_grads=twn.params_from_flax(jax.tree.map(np.asarray, grads)),
        jax_after=twn.params_from_flax(jax.tree.map(np.asarray, after)),
        one_loss=float(one_loss),
        one_grads={k: p.grad.clone()
                   for k, p in state.module.named_parameters()},
        one_after={k: v.clone() for k, v in state.module.state_dict().items()})


# one rank of a mesh: the sharded step on its data rank's rows from the
# reference parameters, then (every rank: collectives) the gathered
# gradients, parameters and a checkpoint; rank 0 saves them
WORKER = """
import json, sys, torch
torch.set_num_threads(1)
from nv_wavenet_tpu_torch.parallel.mesh import initialize_multihost
from nv_wavenet_tpu_torch.train import trainer
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
(data, model, seq), tiny, lr = json.loads(sys.argv[4])
initialize_multihost("127.0.0.1:" + port, data * model * seq, rank, "cpu")
case = torch.load(out + "/case.pt")
net = trainer.create_model(tiny)
mesh = trainer.make_mesh(data, model, seq, net=net,
                         segment_length=case["audio"].shape[1])
state = trainer.shard_train_state(
    net, trainer.TrainConfig(learning_rate=lr), mesh, "cpu")
trainer.load_full_state(state, case["params"])
b = case["audio"].shape[0] // data
rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
loss = trainer.make_sharded_train_step(mesh)(
    state, case["mel"][rows], case["audio"][rows])
grads = trainer.full_state_dict(
    state, {k: p.grad for k, p in state.module.named_parameters()})
params = trainer.full_state_dict(state)
trainer.save_checkpoint(out + "/ckpt", state, 1)
torch.save({"loss": float(loss), "coords": [mesh.data_rank,
            mesh.model_rank, mesh.seq_rank],
            "sharded": {k: list(v.shape)
                        for k, v in state.module.state_dict().items()}},
           out + f"/rank{rank}.pt")
if rank == 0:
    torch.save({"grads": grads, "params": params}, out + "/result.pt")
torch.distributed.destroy_process_group()
"""


def free_port() -> str:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()
    return port


def spawn(code: str, n: int, args, timeout: int = 120):
    """n processes of `code` (argv: rank, a free port, *args), joined."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                               *args], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"


@pytest.fixture(scope="module", params=sorted(MESHES))
def sharded(request, reference, tmp_path_factory):
    """One mesh's step over its data * model * seq gloo processes."""
    axes = MESHES[request.param]
    out = tmp_path_factory.mktemp(request.param)
    torch.save({k: reference[k] for k in ("mel", "audio", "params")},
               out / "case.pt")
    n = int(np.prod(axes))
    spawn(WORKER, n, [str(out), json.dumps([axes, TINY, LR])])
    result = torch.load(out / "result.pt")
    result.update(axes=axes, dir=out,
                  ranks=[torch.load(out / f"rank{r}.pt") for r in range(n)])
    return result


def assert_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def test_sharded_step_matches_jax(sharded, reference):
    for r in sharded["ranks"]:
        assert abs(r["loss"] - reference["jax_loss"]) < LOSS_TOL
    assert_close(sharded["grads"], reference["jax_grads"], rtol=GRAD_RTOL,
                 atol=GRAD_ATOL)
    assert_close(sharded["params"], reference["jax_after"], rtol=0,
                 atol=2.1 * LR)


def test_sharded_step_matches_one_process(sharded, reference):
    for r in sharded["ranks"]:
        assert abs(r["loss"] - reference["one_loss"]) < LOSS_TOL
    assert_close(sharded["grads"], reference["one_grads"], rtol=GRAD_RTOL,
                 atol=GRAD_ATOL)
    assert_close(sharded["params"], reference["one_after"], rtol=0,
                 atol=2.1 * LR)


def test_every_rank_holds_its_shard(sharded, reference):
    data, model, seq = sharded["axes"]
    coords = [tuple(r["coords"]) for r in sharded["ranks"]]
    assert coords == [(d, m, s) for d in range(data) for m in range(model)
                      for s in range(seq)]
    full = reference["params"]
    for r in sharded["ranks"]:
        for k, shape in r["sharded"].items():
            want = list(full[k].shape)
            dim = sharding.param_partition(k)
            if dim is not None:
                want[dim] //= model
            assert shape == want, k


def test_collective_checkpoint_loads_into_one_process_model(sharded):
    state = trainer.create_train_state(trainer.create_model(TINY),
                                       trainer.TrainConfig(seed=5), "cpu")
    state, it = trainer.load_checkpoint(str(sharded["dir"] / "ckpt"), None,
                                        state)
    assert it == 1
    got = state.module.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sharded["params"].items())
    # Adam's moments came back whole: one more step runs
    mel, audio = (torch.from_numpy(a) for a in tiny_batch(batch=2))
    assert np.isfinite(float(trainer.train_step(state, mel, audio)))


# -- in-process: the rules and the carry --------------------------------------

@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_identity(model):
    full = trainer.create_model(TINY).state_dict()
    shards = [sharding.shard_state_dict(full, model, m) for m in range(model)]
    for k in full:
        dim = sharding.param_partition(k)
        if dim is not None:
            assert shards[0][k].shape[dim] * model == full[k].shape[dim]
    back = sharding.gather_state_dict(shards)
    assert set(back) == set(full)
    assert all(torch.equal(back[k], full[k]) for k in full)


def test_param_partition_follows_the_jax_rules():
    names = trainer.create_model(TINY).state_dict()
    sharded = {k for k in names if sharding.param_partition(k) is not None}
    assert sharded == ({"cond_layer.weight", "cond_layer.bias",
                        "conv_out.weight"}
                       | {f"skip_layers.{i}.{p}" for i in range(4)
                          for p in ("weight", "bias")})
    assert sharding.param_partition("conv_out.weight") == 1


def test_batch_partition_keeps_the_81_frame_mel_whole():
    with open(os.path.join(REPO, "configs", "config.json")) as f:
        data_cfg = data_config_from_json(json.load(f)["data_config"])
    ds = Mel2Samp(synthetic_clips(n_clips=1, length=data_cfg.segment_length),
                  data_cfg)
    mel, audio = (torch.from_numpy(a) for a in next(ds.batches(1)))
    assert mel.shape[1] == 81 and audio.shape[1] == 16000
    for s in range(2):
        mesh = types.SimpleNamespace(seq=2, seq_rank=s)
        mel_s, audio_s = sharding.batch_partition(mesh, mel, audio)
        assert mel_s is mel
        assert torch.equal(audio_s, audio[:, 8000 * s:8000 * (s + 1)])
    with pytest.raises(ValueError, match="seq=3 must divide"):
        sharding.batch_partition(types.SimpleNamespace(seq=3, seq_rank=0),
                                 mel, audio)


@pytest.mark.parametrize("net,axes,match", [
    (TINY, (1, 1, 128), "max_dilation 4"),             # 256 / 128 = 2 < 4
    (TINY, (1, 3, 1), "2RL = 256"),
    (dict(TINY, n_skip_channels=100), (1, 8, 1), "S = 100"),
    (TINY, (2, 1, 1), "data=2 x model=1 x seq=1"),     # one process here
])
def test_make_mesh_raises(net, axes, match):
    with pytest.raises(ValueError, match=match):
        trainer.make_mesh(*axes, net=trainer.create_model(net),
                          segment_length=256)


def test_a_sharded_module_refuses_to_export_or_run_unsharded():
    net = trainer.create_model(TINY)
    sharding.shard_module(net, types.SimpleNamespace(model=2, model_rank=1,
                                                     seq=1))
    assert net.cond_layer.weight.shape[0] == 2 * 32 * 4 // 2
    for export in (twn.export_canonical, twn.export_weights):
        with pytest.raises(ValueError, match="shards"):
            export(net)
    mel, audio = (torch.from_numpy(a) for a in tiny_batch(batch=1))
    with pytest.raises(ValueError, match="sharded over 2"):
        net(mel, audio)


def test_collectives_without_a_mesh_are_the_plain_ops():
    x = torch.randn(2, 3, 9)
    assert sharding.copy_to_model(x, None) is x
    assert sharding.reduce_from_model(x, None) is x
    assert sharding.gather_model(x, None) is x
    assert torch.equal(sharding.halo_pad(x, 4, None),
                       torch.nn.functional.pad(x, (4, 0)))
    assert torch.equal(sharding.shift_right(x, None),
                       torch.nn.functional.pad(x[..., :-1], (1, 0)))


@pytest.mark.parametrize("cards,want", [
    (4, [(4, 1, 1), (2, 1, 2), (1, 1, 4), (2, 2, 1), (1, 2, 2), (1, 4, 1)]),
    (3, [(3, 1, 1)]),              # 3 divides neither 2RL, S nor 16000
])
def test_train_mesh_probe_takes_every_mesh_that_shards_the_model(cards, want):
    """The probe's meshes at configs/config.json's width: every data x
    model x seq of the cards' count that `make_mesh` accepts."""
    with open(os.path.join(REPO, "configs", "config.json")) as f:
        net = trainer.create_model(json.load(f)["wavenet_config"])
    assert train_mesh_probe.meshes_of(cards, net, 16000) == want
    for data, model, seq in want:
        sharding.check_shapes(net, model, seq, 16000)
