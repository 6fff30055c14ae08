"""The trainable model of the port (`nv_wavenet_tpu_torch/models/
wavenet.py`) against the JAX package's (`nv_wavenet_tpu/models/wavenet.py`)
at the tiny size of `tests/test_train.py`: the same flax parameters carried
across by `params_from_flax`, the same numpy inputs.

Tolerances: the forward, the conditioning and the upsampler within rtol
2e-4, atol 2e-5 (the convolutions sum in another order than XLA's); the
exports bit for bit (transposes of the same floats); the teacher-forced
train <-> infer equivalence through the port's own CPU generator at the
tolerance of `tests/test_train.py::test_teacher_forced_train_infer_
equivalence` (rtol 2e-4, atol 2e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nv_wavenet_tpu.models import wavenet as jwn
from nv_wavenet_tpu.train.data import Mel2Samp as JMel2Samp
from nv_wavenet_tpu.train.data import synthetic_clips as jsynthetic_clips
from nv_wavenet_tpu_torch.models import wavenet as twn
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from tests.test_train import TINY, TINY_DATA

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def case():
    """A tiny batch, the JAX model's parameters from PRNGKey(1) and its
    logits, and the port's model holding the same parameters."""
    ds = JMel2Samp(jsynthetic_clips(n_clips=2, length=1024), TINY_DATA)
    mel, audio = next(ds.batches(2))
    jmodel = jwn.WaveNetTrain(**TINY)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(mel),
                         jnp.asarray(audio))
    tree = jax.tree.map(np.asarray, params)
    tmodel = twn.WaveNetTrain(**TINY)
    tmodel.load_state_dict(twn.params_from_flax(tree))
    logits = np.asarray(jmodel.apply(params, jnp.asarray(mel),
                                     jnp.asarray(audio)))
    return dict(mel=mel, audio=audio, jmodel=jmodel, params=params,
                tree=tree, tmodel=tmodel, logits=logits)


def test_params_from_flax_covers_the_state_dict(case):
    sd = twn.params_from_flax(case["tree"])
    want = case["tmodel"].state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
        assert v.dtype == torch.float32, k


def test_forward_matches_jax(case):
    with torch.no_grad():
        got = case["tmodel"](torch.from_numpy(case["mel"]),
                             torch.from_numpy(case["audio"])).numpy()
    assert got.shape == case["logits"].shape
    assert np.all(got[:, 0] == 0.0)   # the zero-filled shift
    np.testing.assert_allclose(got, case["logits"], **TOL)


def test_cond_acts_and_cond_input_match_jax(case):
    jm, params, mel = case["jmodel"], case["params"], case["mel"]
    T = case["audio"].shape[1]
    tm, mel_t = case["tmodel"], torch.from_numpy(mel)
    with torch.no_grad():
        acts = tm._cond_acts(mel_t, T).numpy()
        cin = tm.get_cond_input(mel_t).numpy()
    want_acts = np.asarray(jm.apply(params, jnp.asarray(mel), T,
                                    method=jwn.WaveNetTrain._cond_acts))
    want_cin = np.asarray(jm.apply(params, jnp.asarray(mel),
                                   method=jwn.WaveNetTrain.get_cond_input))
    assert acts.shape == want_acts.shape and cin.shape == want_cin.shape
    np.testing.assert_allclose(acts, want_acts, **TOL)
    np.testing.assert_allclose(cin, want_cin, **TOL)
    with pytest.raises(ValueError, match="too short"):
        tm._cond_acts(mel_t[:, :2], T)


@pytest.mark.parametrize("B,F,C,D,K,S", [(2, 9, 7, 5, 12, 3),
                                         (1, 4, 16, 16, 32, 16)])
def test_mel_upsample_matches_jax(B, F, C, D, K, S):
    """The flip of the JAX kernel lives in the weight map: the same
    [window, C, D] kernel gives the same upsampled frames."""
    rng = np.random.RandomState(B + K)
    x = rng.randn(B, F, C).astype(np.float32)
    up = jwn.MelUpsample(features=D, window=K, stride=S)
    p = up.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.01, p)   # a nonzero bias as well
    want = np.asarray(up.apply(p, jnp.asarray(x)))
    k = np.asarray(p["params"]["kernel"])
    tup = twn.MelUpsample(C, D, K, S)
    with torch.no_grad():
        tup.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(k[::-1].transpose(1, 2, 0))))
        tup.bias.copy_(torch.from_numpy(np.array(p["params"]["bias"])))
        got = tup(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, (F - 1) * S + K, D)
    np.testing.assert_allclose(got, want, **TOL)


def test_export_canonical_and_weights_bit_for_bit(case):
    jm, params, tm = case["jmodel"], case["params"], case["tmodel"]
    want = jwn.export_canonical(params, jm)
    got = twn.export_canonical(tm)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_w = jwn.export_weights(params, jm)
    got_w = twn.export_weights(tm)
    assert set(got_w) == set(want_w)
    for k, v in want_w.items():
        if isinstance(v, list):
            assert len(got_w[k]) == len(v)
            for a, b in zip(got_w[k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got_w[k], v, err_msg=k)
        else:
            assert got_w[k] == v, k
    assert (dataclasses.asdict(twn.config_of(tm))
            == dataclasses.asdict(jwn.config_of(jm)))


def test_teacher_forced_train_infer_equivalence(case):
    """The exported model through the port's plain generator, teacher
    forced with the audio and fed the training conditioning: its logits at
    step s equal the training logits at s + 1 (the alignment of
    `tests/test_train.py:78-99`)."""
    tm, mel, audio = case["tmodel"], case["mel"], case["audio"]
    B, T = audio.shape
    with torch.no_grad():
        logits = tm(torch.from_numpy(mel), torch.from_numpy(audio)).numpy()
        cond = tm._cond_acts(torch.from_numpy(mel), T)     # [B, T, L, 2R]
    cond = cond.permute(1, 2, 0, 3).contiguous()            # [T, L, B, 2R]
    cfg = twn.config_of(tm)
    params = {k: torch.from_numpy(v)
              for k, v in twn.export_canonical(tm).items()}
    state = tsg.init_state(cfg, B, "cpu")._replace(
        y_cur=torch.from_numpy(audio[:, 0].astype(np.int32)))
    forced = torch.from_numpy(np.ascontiguousarray(audio[:, 1:].T)).to(
        torch.int32)
    _, _, za = tsg.generate(params, state, cond[:T - 1],
                            torch.zeros(T - 1, B), cfg, forced_y=forced,
                            return_za=True)
    np.testing.assert_allclose(za.numpy(),
                               np.transpose(logits[:, 1:], (1, 0, 2)), **TOL)


def test_init_draws_flax_distributions():
    """Each parameter's spread matches flax's initialiser of the same
    parameter (lecun-normal kernels truncated at 2 sigma, Embed's normal,
    zero biases) within 15% (a few thousand draws per tensor)."""
    big = dict(TINY, n_residual_channels=64, n_skip_channels=128)
    jm = jwn.WaveNetTrain(**big)
    ds = JMel2Samp(jsynthetic_clips(n_clips=1, length=1024), TINY_DATA)
    mel, audio = next(ds.batches(1))
    ref = twn.params_from_flax(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.asarray(mel),
                            jnp.asarray(audio))))
    got = twn.WaveNetTrain(**big)
    got.reset_parameters(torch.Generator().manual_seed(3))
    for k, v in got.state_dict().items():
        r = ref[k]
        if k.endswith("bias"):
            assert not v.any() and not r.any(), k
            continue
        assert float(v.std()) == pytest.approx(float(r.std()), rel=0.15), k
        # truncation: nothing past 2 sigma of the untruncated normal
        assert float(v.abs().max()) <= float(r.abs().max()) * 1.15 + 1e-6, k
    again = twn.WaveNetTrain(**big)
    again.reset_parameters(torch.Generator().manual_seed(3))
    for (k, a), b in zip(got.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_precision_scope_sets_and_restores_the_tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for start in (True, False):
            torch.backends.cudnn.allow_tf32 = start
            torch.backends.cuda.matmul.allow_tf32 = start
            for prec, inside in (("highest", False), ("default", True)):
                with twn.precision_scope(prec):
                    assert torch.backends.cudnn.allow_tf32 is inside
                    assert torch.backends.cuda.matmul.allow_tf32 is inside
                assert torch.backends.cudnn.allow_tf32 is start
                assert torch.backends.cuda.matmul.allow_tf32 is start
            with pytest.raises(RuntimeError):
                with twn.precision_scope("highest"):
                    raise RuntimeError("inside")
            assert torch.backends.cudnn.allow_tf32 is start
        with pytest.raises(ValueError, match="precision"):
            twn.WaveNetTrain(**TINY, precision="bf16")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
