"""The port's exact-math plain versions against the JAX package's numpy
twins and C++ twin: 0 bit mismatches on the dense sweep of
tests/test_exact_math.py.  Never against jitted jnp, which XLA:CPU contracts
into FMAs (ROADMAP fault R1).  On the CPU the kernel wrappers take the plain
versions, so they are held to the same bits."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.ops import exact_math as em
from nv_wavenet_tpu.utils import native
from nv_wavenet_tpu_torch.ops import exact_math as tem


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _mismatches(a, b) -> int:
    return int(np.sum(_bits(a) != _bits(b)))


@pytest.fixture(scope="module")
def dense_inputs():
    """The dense sweep of tests/test_exact_math.py, rebuilt from the same
    seed."""
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-95, 95, 200000),
        rng.uniform(-8, 8, 100000),
        rng.uniform(-0.6, 0.6, 100000),
        rng.uniform(-0.01, 0.01, 50000),
        np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, np.nextafter(0.5, 0.0),
                  np.nextafter(0.5, 1.0), 87.9, -86.9, -87.0, 88.0, 200.0,
                  -200.0, 50.0, -50.0, 1e-20, -1e-20, 2e-38, -2e-38]),
    ]).astype(np.float32)


FNS = [("exp", em.exp_np, tem.exp),
       ("tanh", em.tanh_np, tem.tanh),
       ("sigmoid", em.sigmoid_np, tem.sigmoid)]


@pytest.mark.parametrize("name,fn_np,fn_torch", FNS)
def test_plain_vs_numpy_bit_identical(dense_inputs, name, fn_np, fn_torch):
    a = fn_np(dense_inputs)
    b = fn_torch(torch.from_numpy(dense_inputs)).numpy()
    assert _mismatches(a, b) == 0, name


@pytest.mark.parametrize("name,fn_np,fn_torch", FNS)
def test_plain_vs_cpp_bit_identical(dense_inputs, name, fn_np, fn_torch):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    c = native.exact_fn_native(name, dense_inputs)
    b = fn_torch(torch.from_numpy(dense_inputs)).numpy()
    assert _mismatches(c, b) == 0, name


@pytest.mark.parametrize("name", ["exp", "tanh", "sigmoid"])
def test_wrapper_on_cpu_is_the_plain_version(dense_inputs, name):
    x = torch.from_numpy(dense_inputs)
    before = tem.EXACT_FN_KERNEL.launches
    y = tem.exact_fn(name, x)
    assert tem.EXACT_FN_KERNEL.launches == before
    assert _mismatches(tem.PLAIN_FNS[name](x).numpy(), y.numpy()) == 0


def test_recip_1p_bit_identical():
    e = np.random.RandomState(3).uniform(0, 1, 200000).astype(np.float32)
    e = np.concatenate([e, np.float32([0.0, 1.0, 0.5])])
    a = em._recip_1p_np(e)
    b = tem._recip_1p(torch.from_numpy(e)).numpy()
    assert _mismatches(a, b) == 0


def test_cumsum_and_softmax_pieces_bit_identical():
    za = np.random.RandomState(2).uniform(-6, 6, (64, 256)).astype(np.float32)
    e_np, cum_np = em.softmax_cumsum_np(za)
    e, cum = tem.softmax_cumsum(torch.from_numpy(za))
    assert _mismatches(e_np, e.numpy()) == 0
    assert _mismatches(cum_np, cum.numpy()) == 0
    assert _mismatches(em.fixed_tree_cumsum_np(e_np),
                       tem.fixed_tree_cumsum(torch.tensor(
                           np.asarray(e_np, np.float32))).numpy()) == 0
    assert _mismatches(em.softmax_p_np(e_np, cum_np),
                       tem.softmax_p(e, cum).numpy()) == 0


def test_sampler_bit_identical():
    """The canonical sampler (division-free, counting select, silence
    fallback): 0 mismatches against the numpy twin, including A = 512."""
    rng = np.random.RandomState(1)
    for A in (256, 512):
        za = rng.uniform(-6, 6, (4096, A)).astype(np.float32)
        sel = rng.uniform(0, 1, (4096, 1)).astype(np.float32)
        y_np = em.sample_from_logits_np(za, sel, 128)
        before = tem.SAMPLE_KERNEL.launches
        y = tem.sample_from_logits(torch.from_numpy(za), torch.from_numpy(sel),
                                   128)
        assert tem.SAMPLE_KERNEL.launches == before
        assert y.dtype == torch.int32
        assert int(np.sum(y.numpy() != y_np)) == 0
    # scan failure falls back to silence_bin exactly as the twin does
    za1 = np.zeros((1, 256), np.float32)
    sel1 = np.array([[np.float32(1.0) - np.float32(2 ** -25)]], np.float32)
    assert (tem.sample_from_logits(torch.from_numpy(za1),
                                   torch.from_numpy(sel1), 77).numpy()
            == em.sample_from_logits_np(za1, sel1, 77)).all()


def test_wrappers_reject_what_they_do_not_take():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="unknown exact function"):
        tem.exact_fn("log", x)
    with pytest.raises(ValueError):
        tem.exact_fn("exp", x.to("meta"))
    with pytest.raises(ValueError):
        tem.sample_from_logits(torch.zeros(2, 4), torch.zeros(2, 1,
                                                              device="meta"), 0)
