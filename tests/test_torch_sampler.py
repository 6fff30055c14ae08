"""K0b, the canonical sampler, on the CPU: the instance the wrapper picks
for each width (`ops/exact_math.sample_kernel`: the warp per row where A is
a multiple of 32 up to 1024, the block per row otherwise), the plain
version against the JAX package's numpy twin (`sample_from_logits_np`) on
rows at sel 0, at sel 1.0 (the silence fallback), of tied logits and with
-inf logits (sel 1.0 takes the silence bin where the fixed tree's
cum[A-1] is the row's largest partial sum), and a numpy model of the warp instance's select (the shared
warp prefix sum, the total from lane 31, one multiply, per-lane counts
summed) against the plain version.  Every comparison is exact: 0
mismatches.  The kernels themselves run on the card (`chip_smoke.py`
phase 4 holds each instance against the plain version, 0 mismatches).
"""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.ops import exact_math as jem
from nv_wavenet_tpu_torch.ops import exact_math as tem
from tests.test_torch_scorer_kernels import warp_prefix_sum

WIDTHS = (32, 250, 256, 1024, 1056)
SILENCE = 128


def rows(A: int, seed: int = 0):
    """za [64, A] and sel [64, 1] from a seed: rows 0-7 at sel 1.0, 8-15 at
    sel 0, 16-23 tied, 24-31 with every other logit -inf, 32-39 one -inf
    logit, the rest uniform draws."""
    rng = np.random.RandomState(seed + A)
    za = rng.uniform(-8, 8, (64, A)).astype(np.float32)
    sel = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    sel[:8] = 1.0
    sel[8:16] = 0.0
    za[16:24] = 0.25
    za[24:32, ::2] = -np.inf
    za[32:40, 0] = -np.inf
    return za, sel


def warp_select(za: np.ndarray, sel: np.ndarray, silence: int) -> np.ndarray:
    """sample_warp_kernel in numpy, row by row: the max, e from the plain
    exp, the warp scan, thr = sel * (lane 31's last register), each lane's
    count of c <= thr over its registers, their sum."""
    A = za.shape[1]
    out = np.empty(za.shape[0], np.int32)
    for i, (z, u) in enumerate(zip(za, sel[:, 0])):
        e = tem.exp(torch.from_numpy(z - np.float32(z.max()))).numpy()
        c = warp_prefix_sum(e).reshape(A // 32, 32)
        thr = np.float32(u) * c[-1, 31]
        n = int((c <= thr).sum(axis=0).sum())
        out[i] = n if n < A else silence
    return out


def test_instance_by_width():
    assert [tem.sample_kernel(A) is tem.SAMPLE_KERNEL for A in WIDTHS] == [
        True, False, True, True, False]
    assert all(tem.sample_kernel(A) is tem.SAMPLE_BLOCK_KERNEL
               for A in (1, 16, 257, 2048))
    assert tem.SAMPLE_KERNEL.symbol == "nvw_sample"
    assert tem.SAMPLE_BLOCK_KERNEL.symbol == "nvw_sample_block"
    assert tem.SAMPLE_KERNEL.source == tem.SAMPLE_BLOCK_KERNEL.source


@pytest.mark.parametrize("A", WIDTHS)
def test_plain_sampler_equals_the_jax_twin(A):
    za, sel = rows(A)
    launches = (tem.SAMPLE_KERNEL.launches, tem.SAMPLE_BLOCK_KERNEL.launches)
    y = tem.sample_from_logits(torch.from_numpy(za), torch.from_numpy(sel),
                               SILENCE).numpy()
    assert launches == (tem.SAMPLE_KERNEL.launches,
                        tem.SAMPLE_BLOCK_KERNEL.launches)
    assert y.dtype == np.int32
    np.testing.assert_array_equal(y, jem.sample_from_logits_np(za, sel,
                                                               SILENCE))
    # sel 1.0 counts every bin, and so takes the silence bin, unless the
    # fixed tree rounds some cum[i] above cum[A-1] (it is not monotone:
    # one row of 8 at A = 1024 counts 1023)
    assert (y[:8] == SILENCE).sum() >= 7
    assert (y[8:16] == 0).all()   # sel 0: cum[0] = e_0 > 0 counts no bin


@pytest.mark.parametrize("A", [32, 256, 1024])
def test_warp_select_model_equals_the_plain_sampler(A):
    za, sel = rows(A, seed=3)
    want = tem.sample_from_logits_plain(torch.from_numpy(za),
                                        torch.from_numpy(sel), SILENCE)
    np.testing.assert_array_equal(warp_select(za, sel, SILENCE),
                                  want.numpy())


def test_select_window_shape_goes_through_the_sampler():
    """speculative decode's select_window: [T, B, A] logits, [T, B]
    selectors, the same choices as the sampler row by row."""
    from nv_wavenet_tpu_torch.ops import speculative
    za, sel = rows(256, seed=5)
    y = speculative.select_window(torch.from_numpy(za).reshape(16, 4, 256),
                                  torch.from_numpy(sel).reshape(16, 4),
                                  SILENCE)
    np.testing.assert_array_equal(
        y.reshape(-1).numpy(), jem.sample_from_logits_np(za, sel, SILENCE))
