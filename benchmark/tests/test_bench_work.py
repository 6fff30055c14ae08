"""The yardstick pinned: the counts that the metrics divide by may not
move with the program."""

import pytest

from benchmark import harness, work

FLAGSHIP = harness.Spec().config("nvwavenet-perf-20L-64R-256S")
PYTORCH16 = harness.Spec().config("nvwavenet-pytorch-16L")


def test_k1_bound_at_the_flagship():
    # one 256-step launch of 16 rows: bound by its operations
    assert work.launch_bound_s(FLAGSHIP, 16, 256) * 1e3 == pytest.approx(
        0.1162276, rel=1e-6)
    assert work.row_step_ops(FLAGSHIP) == 1901184


def test_k5_bound_of_a_ragged_tick():
    # PERF.md's K5 row: a 160-step tick with 1,269 live row-steps
    assert work.launch_bound_s(FLAGSHIP, 16, 160, 1269, ragged=True) * 1e3 \
        == pytest.approx(0.0360090, rel=1e-5)


def test_step_cost_at_the_flagship():
    assert work.step_flops(FLAGSHIP) == 1802240.0


def test_training_forward_at_the_reference_config():
    w = PYTORCH16["wavenet_config"]
    fwd = work.train_forward_flops(w, 4, 16000, 200)
    assert fwd / 1e9 == pytest.approx(116.04, abs=0.01)
    assert work.train_step_flops(w, 4, 16000, 200) == 3 * fwd


def test_peaks_are_the_data_sheets():
    assert work.PEAK_FP32_FLOPS == 67e12
    assert work.PEAK_BYTES_PER_S == 3.35e12


def test_param_count_and_ring():
    assert work.param_count(FLAGSHIP) == 910592
    assert work.ring_size(FLAGSHIP) == 2 * 1023
