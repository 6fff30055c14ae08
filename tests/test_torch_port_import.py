"""Reference-checkpoint migration of the port (`engine/torch_import.py`),
mirroring tests/test_torch_import.py (that file is the JAX package's own
test of its numpy migration): a state_dict shaped like the reference's
trainable WaveNet (`pytorch/wavenet.py:54-100`) goes through the port's
functions and the JAX package's.  The exported weights equal bit for bit;
the conditioning within 1e-5 of the JAX function's and of real torch
modules carrying the same weights; the migrated weights generate through
the port's `NVWaveNet` the integers of the JAX scan.  A state_dict of the
port's own trainable model round-trips the same way."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import torch_import as jimport
from nv_wavenet_tpu.engine.wavenet_infer import _selector_stream
from nv_wavenet_tpu.ops import scan_generate as jsg
from nv_wavenet_tpu_torch.engine import torch_import as timport
from nv_wavenet_tpu_torch.engine.nv_wavenet import Impl, NVWaveNet
from nv_wavenet_tpu_torch.models import wavenet as twn

from tests.test_torch_import import (C, L, MAXD, STRIDE, A, R, S,
                                     make_state_dict, torch_get_cond_input)
from tests.test_train import TINY

COND_TOL = 1e-5


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_cond_input_matches_jax_and_torch():
    sd = make_state_dict()
    rng = np.random.RandomState(3)
    mels = rng.uniform(-1, 1, (2, C, 12)).astype(np.float32)
    got = timport.cond_input_from_state_dict(sd, mels, STRIDE, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == (2 * R, 2, L, 12 * STRIDE)
    want = jimport.cond_input_from_state_dict(sd, mels, upsamp_stride=STRIDE)
    assert np.abs(got.numpy() - want).max() <= COND_TOL
    assert np.abs(got.numpy() - torch_get_cond_input(sd, mels)).max() \
        <= COND_TOL
    one = timport.cond_input_from_state_dict(sd, mels[0], STRIDE,
                                             device="cpu")
    assert (one - got[:, :1]).abs().max() <= COND_TOL


def test_export_and_infer_end_to_end():
    """The export dict key for key, each value bit for bit the JAX
    export's, as tensors on the device; NVWaveNet on it generates the JAX
    scan's integers under the default stream of seed 0."""
    sd = make_state_dict()
    d = timport.export_weights_from_state_dict(sd, max_dilation=MAXD,
                                               device="cpu")
    jd = jimport.export_weights_from_state_dict(sd, max_dilation=MAXD)
    assert set(d) == set(jd)
    for k, v in d.items():
        if isinstance(v, list):
            assert len(v) == len(jd[k]), k
            for a, b in zip(v, jd[k]):
                assert a.device.type == "cpu" and np.array_equal(
                    as_np(a), b), k
        elif isinstance(v, torch.Tensor):
            assert np.array_equal(v.numpy(), jd[k]), k
        else:
            assert v == jd[k], k
    assert d["use_embed_tanh"] is False and not d["embedding_prev"].any()

    net = NVWaveNet(**d, device="cpu")
    assert (net.num_layers, net.R, net.S, net.A) == (L, R, S, A)
    rng = np.random.RandomState(5)
    mels = rng.uniform(-1, 1, (2, C, 4)).astype(np.float32)
    cond = timport.cond_input_from_state_dict(sd, mels, STRIDE, device="cpu")
    y = net.infer(cond, seed=0)
    T = 4 * STRIDE
    assert y.shape == (2, T) and np.array_equal(y, net.infer(cond, seed=0))
    cfg = WaveNetConfig(num_layers=L, R=R, S=S, A=A, max_dilation=MAXD,
                        tanh_embed=False)
    canon = net._engine(2, Impl.AUTO)._np_params
    _, y_jax, _ = jsg.generate(
        canon, jsg.init_state(cfg, 2),
        np.ascontiguousarray(cond.numpy().transpose(3, 2, 1, 0)),
        _selector_stream(0, 0, T, 2), cfg)
    assert int((y != np.asarray(y_jax)).sum()) == 0


def test_port_model_state_dict_round_trips():
    """The port's WaveNetTrain: its state_dict's export equals its own
    `export_weights` bit for bit, and the conditioning its
    `get_cond_input` within 1e-5 (channels first)."""
    model = twn.WaveNetTrain(**TINY)
    sd = model.state_dict()
    d = timport.export_weights_from_state_dict(sd, TINY["max_dilation"],
                                               device="cpu")
    want = twn.export_weights(model)
    for k, v in want.items():
        got = d[k]
        if isinstance(v, list):
            assert all(np.array_equal(as_np(a).reshape(b.shape), b)
                       for a, b in zip(got, v)), k
        elif isinstance(v, np.ndarray):
            assert np.array_equal(as_np(got).reshape(v.shape), v), k
        else:
            assert got == v, k
    rng = np.random.RandomState(1)
    mel = rng.uniform(-1, 1, (2, 6, TINY["n_cond_channels"])).astype(
        np.float32)
    cond = timport.cond_input_from_state_dict(
        sd, mel.transpose(0, 2, 1), TINY["upsamp_stride"], device="cpu")
    with torch.no_grad():
        ref = model.get_cond_input(torch.from_numpy(mel))    # [T, L, B, 2R]
    assert np.abs(cond.numpy() - ref.permute(3, 2, 1, 0).numpy()).max() \
        <= COND_TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            timport.export_weights_from_state_dict(sd, 4)
