"""The two cells of the wide vocoder and the latency tier at tiny sizes on
the CPU (the program's plain path): each runs `correct`, each planted fault
makes it not correct, a lower precision is seen by the wide cell's check,
and BENCHMARK.json holds their entries (appended, no value changed)."""

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny, tiny_kinds

CPU = torch.device("cpu")
SEED = 2**31 + 4242
CELLS = ("wide30L-offline-b16", "perf20L-latency-b16")
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return harness.Spec(tiny_kinds.make_root(
        str(tmp_path_factory.mktemp("root"))))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(spec, cell, trace):
    run, out = harness.run_in_process(spec, cell, SEED, 0.2, trace, CPU)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in spec.metrics_of(cell, trace)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want == {"gen_khz_per_utt", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half_batch", "unchanged"])
def test_a_planted_fault_is_not_correct(spec, cell, fault):
    _, out = harness.run_in_process(spec, cell, SEED, 0.2, False, CPU, fault)
    assert out["correct"] is False, out["compared"]


def test_the_wide_cells_engine_has_no_embedding_tanh(spec):
    run, out = harness.run_in_process(spec, CELLS[0], SEED, 0.1, False, CPU)
    assert run.engine_kw["tanh_embed"] is False and out["correct"]
    run, _ = harness.run_in_process(spec, CELLS[1], SEED, 0.1, False, CPU)
    assert run.engine_kw["priority"] == "latency"


def test_the_bf16_control_is_not_correct_in_the_wide_cell(tmp_path):
    root = tiny_kinds.make_root(str(tmp_path))
    path = os.path.join(root, "benchmark", "traffic", "offline-wide-b16.json")
    t = json.load(open(path))
    t["samples"] = 256
    json.dump(t, open(path, "w"))
    _, out = harness.run_in_process(harness.Spec(root), CELLS[0], SEED, 1.0,
                                    False, CPU, "bf16")
    assert out["correct"] is False, out["compared"]


def test_the_entries_are_appended():
    cfg = BENCH["configs"][-1]
    assert cfg["name"] == "kanbayashi-wavenet-30L-512R" and cfg["reduced"] == []
    assert [w["name"] for w in BENCH["workloads"][-2:]] == list(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"][-2:])
    file = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert (file["num_layers"], file["max_dilation"], file["R"], file["S"],
            file["A"], file["tanh_embed"]) == (30, 512, 512, 256, 256, False)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] in ("gen_khz_per_utt", "gen.kernel_roofline",
                         "gen.mfu_pct", "device_idle_pct.gen"):
            assert m["workloads"] == ["perf20L-offline-b16", *CELLS]
    wait = BENCH["per_layer"][-1]
    assert wait["name"] == "gen.wide_wait_pct"
    assert wait["workloads"] == [CELLS[0]]


def test_the_tiny_root_takes_every_kind(tmp_path):
    """`tiny.make_root` (through `benchmark/conftest.py`) retargets the new
    kinds too, so the older tests' roots hold every cell."""
    spec = harness.Spec(tiny.make_root(str(tmp_path)))
    for w in BENCH["workloads"]:
        kind = spec.traffic(w["traffic"])["kind"]
        assert kind in tiny_kinds.TRAFFIC
        harness.mix(kind)
