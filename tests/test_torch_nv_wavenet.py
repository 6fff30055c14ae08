"""The reference user's wrapper of the port (`engine/nv_wavenet.py`,
`NVWaveNet`) mirroring tests/test_nv_wavenet_wrapper.py's four cases: the
same flax parameters carried into the port's model by `params_from_flax`,
exported by each package's `export_weights`, and driven through each
package's `NVWaveNet.infer` (the JAX one with its Pallas kernel in
interpret mode) with the reference's channels-first conditioning:
identical integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nv_wavenet_tpu.engine.nv_wavenet import Impl as JImpl
from nv_wavenet_tpu.engine.nv_wavenet import NVWaveNet as JNVWaveNet
from nv_wavenet_tpu.models import wavenet as jwn
from nv_wavenet_tpu_torch.engine import wavenet_infer as tinfer
from nv_wavenet_tpu_torch.engine.nv_wavenet import (Impl, NVWaveNet,
                                                    column_major,
                                                    interleave_lists)
from nv_wavenet_tpu_torch.models import wavenet as twn

from tests.test_train import TINY, tiny_batch


@pytest.fixture(scope="module")
def exported():
    """(the JAX export, the port's export of the same parameters, R, L)."""
    model = jwn.WaveNetTrain(**TINY)
    mel, audio = tiny_batch()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                        jnp.asarray(audio))
    tmodel = twn.WaveNetTrain(**TINY)
    tmodel.load_state_dict(twn.params_from_flax(
        jax.tree.map(np.asarray, params)))
    cfg = jwn.config_of(model)
    return (jwn.export_weights(params, model), twn.export_weights(tmodel),
            cfg.R, cfg.num_layers)


def cond_ref(R, L, B, T, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.5, 0.5, (2 * R, B, L, T)).astype(np.float32),
            rng.uniform(0, 1, (T, B)).astype(np.float32))


def test_wrapper_matches_the_jax_wrapper_via_export_weights(exported):
    jexp, texp, R, L = exported
    B, T = 2, 10
    cond, sel = cond_ref(R, L, B, T, 5)
    net = NVWaveNet(**texp, device="cpu", chunk_size=4)
    assert (net.R, net.S, net.A, net.num_layers) == (
        R, TINY["n_skip_channels"], TINY["n_out_channels"], L)
    y = net.infer(cond, Impl.PERSISTENT, selectors=sel)
    y_jax = JNVWaveNet(**jexp, interpret=True, chunk_size=4).infer(
        cond, JImpl.PERSISTENT, selectors=sel)
    assert y.dtype == np.int32
    assert int((y != np.asarray(y_jax)).sum()) == 0
    # the conditioning as a tensor, and MANYBLOCK (K4's plain version)
    assert np.array_equal(net.infer(torch.from_numpy(cond), Impl.MANYBLOCK,
                                    selectors=sel), y)


def test_wrapper_validates_cond_shape(exported):
    net = NVWaveNet(**exported[1], device="cpu")
    with pytest.raises(ValueError, match="channels"):
        net.infer(np.zeros((8, 1, 3, 4), np.float32), Impl.AUTO)
    bad = dict(exported[1], conv_end_weight=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="conv_end_weight"):
        NVWaveNet(**bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            NVWaveNet(**exported[1]).infer(np.zeros((2 * exported[2], 1,
                                                     exported[3], 4),
                                                    np.float32))


def test_wrapper_accepts_torch_style_3d_conv_weights(exported):
    """Conv1d weights with their trailing kernel dim of 1, as tensors (the
    reference's export): the same samples as the squeezed numpy export."""
    _, texp, R, L = exported
    torchy = dict(texp)
    for k in ("conv_out_weight", "conv_end_weight"):
        torchy[k] = torch.from_numpy(texp[k])[:, :, None]
    for k in ("res_weights", "skip_weights"):
        torchy[k] = [torch.from_numpy(w)[:, :, None] for w in texp[k]]
    cond, sel = cond_ref(R, L, 2, 6, 9)
    y1 = NVWaveNet(**texp, device="cpu", chunk_size=8).infer(
        cond, Impl.PERSISTENT, selectors=sel)
    y2 = NVWaveNet(**torchy, device="cpu", chunk_size=8).infer(
        cond, Impl.PERSISTENT, selectors=sel)
    assert np.array_equal(y1, y2)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert np.array_equal(column_major(w[:, :, None]), w.T)
    assert interleave_lists([1, 2], [3, 4]) == [1, 3, 2, 4]


def test_wrapper_fresh_selectors_per_call(exported):
    """selectors=None draws a fresh stream each call (seeds 0, 1, ... of
    the default stream, as the JAX wrapper); an explicit seed is
    reproducible and is `_selector_stream(seed, ...)`."""
    _, texp, R, L = exported
    cond, _ = cond_ref(R, L, 1, 8, 2)
    net = NVWaveNet(**texp, device="cpu", chunk_size=8)
    y1 = net.infer(cond, Impl.PERSISTENT)
    y2 = net.infer(cond, Impl.PERSISTENT)
    assert not np.array_equal(y1, y2)
    ya = net.infer(cond, Impl.PERSISTENT, seed=42)
    assert np.array_equal(ya, net.infer(cond, Impl.PERSISTENT, seed=42))
    for y, seed in ((y1, 0), (y2, 1), (ya, 42)):
        sel = tinfer._selector_stream(seed, 0, 8, 1)
        assert np.array_equal(y, net.infer(cond, Impl.PERSISTENT,
                                           selectors=sel))
