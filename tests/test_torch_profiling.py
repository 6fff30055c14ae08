"""The port's cost model (`utils/profiling.py`) and its perf
harness (`tools/perf.py`) on the CPU.

  * `step_cost` equals the JAX package's field for field (the same
    analytic count), at the flagship and at tests/test_speculative.py's
    config;
  * the floors and the roofline take the H100's constants (the peaks of
    NVIDIA's data sheet, P5's measured stage), never the TPU's;
  * `memory_report` shows K1, K4 and K6 against the card's shared memory
    and L2, and says where a kernel cannot run;
  * perf.py on `--device cpu` at the tiny config of tests/test_perf_cli.py
    gives one record, and a sweep that includes speculative decode.
"""

import json

import pytest
import torch

from nv_wavenet_tpu import config as jcfg
from nv_wavenet_tpu.utils import profiling as jprof
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.tools import perf
from nv_wavenet_tpu_torch.utils import profiling as tprof

from tests.test_speculative import CFG
from tests.test_torch_persistent import port_cfg

TINY = ["-l", "2", "-r", "32", "-s", "64", "-a", "256", "-d", "2",
        "-n", "16", "-t", "1", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are tiny: torch's intra-op threads cost more than
    they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("jax_cfg", [jcfg.FLAGSHIP_CONFIG, CFG],
                         ids=["flagship", "cfg"])
def test_step_cost_equals_jax(jax_cfg):
    got = tprof.step_cost(port_cfg(jax_cfg))
    ref = jprof.step_cost(jax_cfg)
    for field in ("flops_per_sample_per_utt", "weight_bytes",
                  "cond_bytes_per_sample_per_utt", "critical_path_matmuls"):
        assert getattr(got, field) == getattr(ref, field), field


def test_floors_take_the_h100_constants():
    cfg = tcfg.FLAGSHIP_CONFIG
    cost = tprof.step_cost(cfg)
    assert tprof.STAGE_NS != 200.0          # the TPU's constant
    assert cost.latency_floor_khz() == 1e6 / (43 * tprof.STAGE_NS)
    # K6's chain: 25 stages, and at P=128 split 8 ways layer l's product
    # over its 128 l earlier gate outputs takes ceil(l / 4) stages
    assert cost.fused_latency_floor_khz(cfg) == 1e6 / (61 * tprof.STAGE_NS)
    assert (cost.fused_latency_floor_khz(cfg, pack_gates=True)
            == 1e6 / (39 * tprof.STAGE_NS))
    flops = cost.flops_per_sample_per_utt
    assert cost.roofline_khz(16) == pytest.approx(
        min(67e12 / (flops * 16),
            3.35e12 / (cost.weight_bytes
                       + 16 * cost.cond_bytes_per_sample_per_utt)) / 1e3)


def test_memory_report():
    rep = tprof.memory_report(tcfg.FLAGSHIP_CONFIG, 16, 256)
    for key in ("weights", "ring buffer", "cond stream", "K1", "K4", "K6",
                "227", "of 50"):
        assert key in rep, key
    # R=36: K6 loads four columns at a time and cannot run
    small = tcfg.WaveNetConfig(num_layers=2, R=36, S=128, A=256,
                               max_dilation=2)
    assert "K6  cannot run" in tprof.memory_report(small, 1, 8)


def run_cli(capsys, args):
    perf.main(args)
    return capsys.readouterr().out


def test_perf_single_run_record(capsys):
    out = run_cli(capsys, TINY + ["-b", "2", "-m", "persistent", "-c", "8"])
    assert "Sample rate:" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["batch"] == 2 and rec["mode"] == "persistent"
    assert rec["device"] == "cpu" and rec["khz_per_utterance"] > 0


def test_perf_speculative_record(capsys):
    out = run_cli(capsys, TINY + ["-b", "1", "-m", "speculative", "-c", "8",
                                  "--spec_window", "8"])
    assert "avg committed run" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["mode"] == "speculative" and rec["khz_per_utterance"] > 0


def test_perf_sweep_includes_speculative(capsys):
    out = run_cli(capsys, TINY + ["--sweep", "--sweep_batches", "1,2",
                                  "--sweep_chunks", "8", "--spec_window", "8",
                                  "--spec_adaptive", "--sweep_modes",
                                  "persistent,fused_fast,speculative"])
    assert "Ranked by total throughput:" in out and "FAILED" not in out
    assert out.count("-> ") == 6
    assert "mode=speculative" in out and "adaptive branch=" in out
    best = json.loads(out.split("Best total:")[1].splitlines()[0])
    assert best["batch"] in (1, 2) and best["khz_total"] > 0
