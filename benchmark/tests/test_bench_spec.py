"""BENCHMARK.json against the benchmark's rules, and every name in it
leading to its file."""

import json
import math
import os
import re

import pytest

from benchmark import harness

REPO = harness.ROOT
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_four_card_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_a_full_check_fits_its_time_with_24_cells():
    s = BENCH["run_seconds"]
    total = (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    spec = harness.Spec()
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    harness.mix(traffic["kind"])
    assert cfg["reduced"] == next(c["reduced"] for c in BENCH["configs"]
                                  if c["name"] == w["config"])
    assert "assumed" in cfg and "source" in cfg
    for trace in (False, True):
        for m in spec.metrics_of(w["name"], trace):
            assert callable(harness.reader(m["name"]).read)


def test_config_files_lie_under_paths_and_differ():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("benchmark/") and os.path.isfile(
            os.path.join(REPO, f))


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    spec = harness.Spec()
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.metrics_of(w["name"], True), w["name"]


def test_each_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        target = e2e[m["moves"]].get("workloads", sorted(cells))
        for cell in m.get("workloads", target):
            assert cell in cells and cell in target, (m["name"], cell)


def test_one_layer_name_per_layer_word():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    # a layer's name is spelled one way: no two differ only in case/space
    norm = {re.sub(r"\s+", " ", x.lower()) for x in layers}
    assert len(norm) == len(layers)


def test_rooflines_and_mfu_are_shares():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"].endswith("_roofline") for m in BENCH["per_layer"])
    moved = {m["moves"] for m in BENCH["per_layer"]
             if m["name"].endswith("_roofline")}
    for e2e in moved:
        assert any("mfu" in m["name"] and m["moves"] == e2e
                   for m in BENCH["per_layer"]), e2e


def test_traffic_and_metric_files_are_named_from_names():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for dirpath, _, files in os.walk(os.path.join(REPO, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert allowed.match(rel), rel
    assert not math.isnan(BENCH["run_seconds"])
