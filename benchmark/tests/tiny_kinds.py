"""The tiny root of `tiny.py` for every traffic kind of the benchmark:
`tiny.make_root` retargets each cell of BENCHMARK.json by its traffic kind
from a table of the first three kinds ("offline", "serve", "train"); this
adds the kinds that came after it, each the offline kind's tiny traffic
under its own kind: "offline_wide" on a copy of the tiny generation config
with `tanh_embed` false (the wide vocoder's embedding), "latency" with a
limit of the tiny tier's own.  `benchmark/conftest.py` puts it in
`tiny.make_root`'s place."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.tests import tiny

GEN_WIDE = dict(tiny.GEN, name="tiny-gen-wide", tanh_embed=False)
# the latency tier is held to the TV contract, not bit for bit: at the tiny
# config its plain path reads gaps of 5.4e-4 to 6.4e-4 (three seeds), each
# planted fault 0.054 or more (PERF.md §4)
LATENCY_LIMIT = 0.01
TRAFFIC = {"offline": tiny.OFFLINE, "serve": tiny.SERVE, "train": tiny.TRAIN,
           "offline_wide": dict(tiny.OFFLINE, kind="offline_wide"),
           "latency": dict(tiny.OFFLINE, kind="latency",
                           limits={"widest_sel_gap": LATENCY_LIMIT})}
CONFIG_OF = {"train": "tiny-train", "offline_wide": "tiny-gen-wide"}


def make_root(path: str) -> str:
    """`tiny.make_root` over every kind of `TRAFFIC`."""
    os.makedirs(os.path.join(path, "benchmark"), exist_ok=True)
    shutil.copytree(os.path.join(tiny.REPO, "benchmark", "metrics"),
                    os.path.join(path, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    for d in ("configs", "traffic"):
        os.makedirs(os.path.join(path, "benchmark", d), exist_ok=True)
    b = json.load(open(os.path.join(tiny.REPO, "BENCHMARK.json")))
    files = {"tiny-gen": tiny.GEN, "tiny-train": tiny.TRAIN_CFG,
             "tiny-gen-wide": GEN_WIDE}
    for name, cfg in files.items():
        with open(os.path.join(path, "benchmark", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
    b["configs"] = [{"name": n, "source": "tiny",
                     "file": f"benchmark/configs/{n}.json", "reduced": [],
                     "why": "tiny"} for n in files]
    for w in b["workloads"]:
        kind = json.load(open(os.path.join(
            tiny.REPO, "benchmark", "traffic", w["traffic"] + ".json")))["kind"]
        w["config"] = CONFIG_OF.get(kind, "tiny-gen")
        w["chips"] = 1
        with open(os.path.join(path, "benchmark", "traffic",
                               w["traffic"] + ".json"), "w") as f:
            json.dump(dict(TRAFFIC[kind]), f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return path
