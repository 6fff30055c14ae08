"""The readers of the program's own spans and counters
(`program_trace.py`) on tiny traced runs on the CPU: every `program_span`
and `program_counter` metric of the serve and train cells reads a number,
the device-trace ones read nothing without a card, the feed's three
phases lie inside its call, and K5's counters give the dead share the
benchmark counts from outside.  Without a card the script refuses."""

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.tests import tiny
from nv_wavenet_tpu_torch.utils import tracing

CPU = torch.device("cpu")
SEED = 2**31 + 4243
NEW = {"perf20L-serve-ragged16": ("serve.stage_ms", "serve.prefold_ms",
                                  "serve.launch_ms", "serve.program_idle_ms",
                                  "serve.k5_dead_row_pct"),
       "pytorch16L-train-b4": ("train.forward_ms", "train.optimizer_ms",
                               "train.featurize_ms")}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return harness.Spec(tiny.make_root(str(tmp_path_factory.mktemp("root"))))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_the_programs_spans_and_counters(spec, cell,
                                                            monkeypatch):
    # the counters are the process's: this run's alone, as in a benchmark
    # process, not those of the tests before it; read besides as the
    # measured window opens and closes
    monkeypatch.setattr(tracing, "_COUNTS", {})
    at = {}
    for edge in ("open_window", "close_window"):
        def wrapped(self, _f=getattr(harness.Run, edge), _e=edge):
            at[_e] = tracing.counters()
            _f(self)
        monkeypatch.setattr(harness.Run, edge, wrapped)
    run, out = harness.run_in_process(spec, cell, SEED, 0.3, True, CPU)
    assert out["correct"] is True, out["compared"]
    kinds = {m["name"]: m["source"] for m in spec.metrics_of(cell, True)}
    for name in NEW[cell]:
        if kinds[name] in ("program_span", "program_counter"):
            v = out["metrics"][name]["value"]
            assert v >= 0, name
        else:
            assert name not in out["metrics"], name
    c = tracing.counters()
    if cell.startswith("pytorch16L"):
        assert out["metrics"]["train.featurize_ms"]["value"] == \
            pytest.approx(c["data.featurize_ns"] / c["data.featurized"] / 1e6)
    if cell.startswith("perf20L"):
        # K5's counters over the measured feeds are the benchmark's count
        # from the lengths it passed, exactly; the reader takes them over
        # the whole process (set-up and warm-up feeds too)
        for k in ("row_steps", "live_row_steps"):
            assert (at["close_window"]["k5." + k]
                    - at["open_window"].get("k5." + k, 0)) == run.counts[k], k
        assert out["metrics"]["serve.k5_dead_row_pct"]["value"] == \
            pytest.approx(100.0 * (c["k5.row_steps"] - c["k5.live_row_steps"])
                          / c["k5.row_steps"])
        t = program_trace.of(run)
        feeds = t["spans"]["feed_device"]
        phases = [t["spans"][n] for n in ("feed.stage", "feed.prefold",
                                          "feed.launch")]
        assert all(len(p) == len(feeds) for p in phases)
        for (a, b, th), *inner in zip(feeds, *phases):
            assert all(th == i[2] and a <= i[0] <= i[1] <= b for i in inner)
            assert inner[0][1] <= inner[1][0] and inner[1][1] <= inner[2][0]


def test_an_untraced_run_has_no_program_trace(spec):
    run, _ = harness.run_in_process(spec, "perf20L-serve-ragged16", SEED,
                                    0.1, False, CPU)
    assert program_trace.of(run) is None
    assert program_trace.span_ms(run, "feed.stage") is None


def test_the_cards_clock_is_moved_to_start_no_op_before_its_launch():
    us = 1e3   # a bin is 50 ms
    dev = [(100.0, 150.0, (200.0, 1)),            # starts 100 us early
           (300.0, 400.0, (250.0, 1)),
           (60 * us, 60 * us + 100, (59 * us, 1)),  # a sound bin
           (125 * us, 125 * us + 10, None)]       # a bin with no launch
    out, shift = program_trace.causal(dev, 0.0, 130 * us)
    assert shift == 100.0
    assert out[:2] == [(200.0, 250.0, (200.0, 1)), (400.0, 500.0, (250.0, 1))]
    assert out[2:] == dev[2:]
    assert program_trace.causal(dev[2:3], 0.0, 130 * us) == (dev[2:3], 0.0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_the_trace_of_a_cell_refuses_without_a_card(capsys):
    assert program_trace.main(["--workload", "perf20L-serve-ragged16",
                               "--seed", str(SEED), "--seconds", "1"]) == 2
    assert "needs 1 CUDA device" in capsys.readouterr().err
