"""Whole runs of tiny cells on the CPU (the program's plain path): the line
they print, the check that passes them, the faults and the lower
precision that it fails, and a cell added by files alone."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, variants
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 4242   # past 32 signed bits, as large seeds are
KINDS = {"perf20L-offline-b16": "offline", "perf20L-serve-ragged16": "serve",
         "pytorch16L-train-b4": "train"}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return harness.Spec(tiny.make_root(str(tmp_path_factory.mktemp("root"))))


@pytest.mark.parametrize("cell", sorted(KINDS))
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_prints_its_line(spec, cell, trace):
    run, out = harness.run_in_process(spec, cell, SEED, 0.2, trace, CPU)
    assert out["correct"] is True, out["compared"]
    assert list(out)[-1] == "compared"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in spec.metrics_of(cell, trace)}
    got = set(out["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


# each fault a cell can have, planted under the timed path
FAULTS = [(c, f) for c in ("perf20L-offline-b16", "perf20L-serve-ragged16")
          for f in ("altered", "half_batch", "unchanged")] + \
         [("pytorch16L-train-b4", f)
          for f in ("altered", "half_batch", "unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(spec, cell, fault):
    _, out = harness.run_in_process(spec, cell, SEED, 0.2, False, CPU, fault)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("cell", ["perf20L-offline-b16",
                                  "perf20L-serve-ragged16"])
def test_the_bf16_control_is_not_correct(spec, cell):
    root = tiny.make_root(os.path.join(spec.root, "long"))
    for kind, key, n in (("offline", "samples", 256),
                         ("serve", "utt_max", 256)):
        path = os.path.join(root, "benchmark", "traffic",
                            spec.cell(cell)["traffic"] + ".json")
        t = json.load(open(path))
        if t["kind"] == kind:
            t[key] = n
            if kind == "serve":
                t["utt_min"], t["check_utterances"] = 128, 6
            json.dump(t, open(path, "w"))
    _, out = harness.run_in_process(harness.Spec(root), cell, SEED, 1.0,
                                    False, CPU, "bf16")
    assert out["correct"] is False, out["compared"]


def test_variants_are_named():
    assert variants.engine_kw("program") == {}
    with pytest.raises(ValueError):
        variants.engine_kw("nope")


def test_a_cell_added_by_files_alone(spec, tmp_path):
    """A new traffic file, metric reader and entries: no file edited."""
    root = tiny.make_root(str(tmp_path))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    t = dict(tiny.OFFLINE, batch=2, samples=16)
    with open(os.path.join(root, "benchmark", "traffic",
                           "offline-b2.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "benchmark", "metrics",
                           "gen.requests_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run.counts['requests'] / run.window_s\n")
    bench["workloads"].append({"name": "tiny-offline-b2",
                               "config": "tiny-gen", "traffic": "offline-b2",
                               "chips": 1, "why": "a dummy cell"})
    bench["per_layer"].append({"name": "gen.requests_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "generation step",
                               "moves": "gen_khz_per_utt",
                               "workloads": ["tiny-offline-b2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "gen_khz_per_utt":
            m["workloads"].append("tiny-offline-b2")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    s = harness.Spec(root)
    _, out = harness.run_in_process(s, "tiny-offline-b2", SEED, 0.1, True,
                                    CPU)
    assert out["correct"] and "gen.requests_per_s" in out["metrics"]


def test_no_jax_after_a_run_and_no_program_in_the_reference(tmp_path):
    """In a fresh process: every module of the benchmark imported and a
    tiny cell run; no module of JAX or of the JAX package is loaded
    (top-level names compared whole), and the reference alone loads
    nothing of the program."""
    code = f"""
import importlib, os, pkgutil, sys
sys.path.insert(0, {harness.ROOT!r})
import torch
torch.set_num_threads(1)
import benchmark.reference.wavenet_ref, benchmark.reference.train_ref
import benchmark.inputs, benchmark.work
prog = [n for n in sys.modules if n.split('.')[0] == 'nv_wavenet_tpu_torch']
assert not prog, prog
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):
    if '.tests' not in m.name and m.name != 'benchmark.run':
        importlib.import_module(m.name)
from benchmark import harness
from benchmark.tests import tiny
spec = harness.Spec(tiny.make_root({str(tmp_path)!r}))
for cell in {sorted(KINDS)!r}:
    harness.run_in_process(spec, cell, 7, 0.1, False, torch.device('cpu'))
bad = harness.forbidden_modules()
assert not bad, bad
assert 'nv_wavenet_tpu_torch' in sys.modules
print('clean')
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]


def test_the_reference_sources_import_nothing_of_the_program():
    here = os.path.join(harness.ROOT, "benchmark", "reference")
    for f in os.listdir(here):
        if f.endswith(".py"):
            text = open(os.path.join(here, f)).read()
            for name in ("nv_wavenet_tpu", "jax", "flax"):
                assert f"import {name}" not in text, (f, name)
                assert f"from {name}" not in text, (f, name)


def test_run_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, os.path.join(
        harness.ROOT, "benchmark", "run.py"), "--workload",
        "perf20L-offline-b16", "--seed", str(SEED), "--seconds", "1",
        "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("nv_wavenet_tpu_torch_probe_x", sys)
    try:
        assert "nv_wavenet_tpu_torch_probe_x" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["nv_wavenet_tpu_torch_probe_x"]
