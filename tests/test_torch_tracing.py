"""The port's tracing (`nv_wavenet_tpu_torch/utils/tracing.py`) on the CPU.

  * with no profiler running, `span` is one shared null context and no
    `record_function` is made on the feed, step or data path;
  * under `torch.profiler`, a ragged and a lockstep `feed_device` give
    `nvw:feed_device` holding `feed.stage`, `feed.prefold` and
    `feed.launch` in that order on one thread; a `train_step` gives
    `train.step` holding its forward, backward and optimizer; the data
    pipeline's worker holds `data.featurize` and `data.stage`, its consumer
    `data.wait`;
  * a ragged feed adds B x its longest row's steps and the sum of its
    lengths to K5's counters, and the mesh's collectives are spans and
    counters;
  * `trace` writes a Chrome trace.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.train import trainer
from nv_wavenet_tpu_torch.train.data import (DataConfig, Mel2Samp,
                                             synthetic_clips)
from nv_wavenet_tpu_torch.train.sharding import TrainMesh
from nv_wavenet_tpu_torch.utils import tracing

L, R, S, A, B = 2, 8, 16, 256, 3
TINY = dict(n_in_channels=256, n_layers=2, max_dilation=2,
            n_residual_channels=8, n_skip_channels=16, n_out_channels=256,
            n_cond_channels=8, upsamp_window=32, upsamp_stride=16)
TINY_DATA = DataConfig(segment_length=256, filter_length=64, hop_length=16,
                       win_length=64, n_mel_channels=8, mel_fmax=4000.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are tiny: torch's intra-op threads cost more than
    they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine():
    eng = WaveNetInfer(num_layers=L, max_dilation=2, R=R, S=S, A=A,
                       max_batch=B, chunk_size=8, device="cpu")
    cfg = eng.cfg
    eng.set_reference_weights(params_lib.random_reference_weights(cfg,
                                                                  seed=3))
    eng.begin_stream(B)
    return eng


def chunk(T, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.5, 0.5, (T, L, B, 2 * R)).astype(np.float32),
            rng.uniform(0, 1, (T, B)).astype(np.float32))


def train_state():
    return trainer.create_train_state(trainer.create_model(TINY),
                                      trainer.TrainConfig(), "cpu")


def batches(n):
    ds = Mel2Samp(synthetic_clips(n_clips=2, length=1024, seed=0),
                  TINY_DATA, seed=0)
    it = ds.batches(2)
    return [next(it) for _ in range(n)]


def profiled(fn):
    """The `nvw:` host ranges `fn()` leaves under a CPU profiler:
    (name without the prefix, start, end, thread)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return spans_of(prof)


def spans_of(prof):
    """By start."""
    return sorted(((e.name[len(tracing.PREFIX):], e.time_range.start,
                    e.time_range.end, e.thread) for e in prof.events()
                   if e.name.startswith(tracing.PREFIX)),
                  key=lambda s: s[1])


def inside(outer, spans):
    """The spans inside `outer`'s range on its thread, by start."""
    _, a, b, th = outer
    return [s for s in spans if s is not outer and s[3] == th
            and a <= s[1] and s[2] <= b]


def test_span_off_is_one_null_context_and_leaves_no_event():
    off = [tracing.span("feed.stage"), tracing.span("train.step", 7),
           tracing.span("other")]
    assert all(s is off[0] for s in off)
    assert isinstance(off[0], contextlib.nullcontext)
    with off[0]:
        pass

    def enter_off_spans():
        for s in off:
            with s:
                torch.ones(2).add_(1)
    assert profiled(enter_off_spans) == []


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        made.append(args[0])
        return real(*args, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = engine()
    cond, sel = chunk(6)
    eng.feed_device(cond, sel)
    eng.feed_device(cond, sel, lengths=np.array([6, 2, 0]))
    state = train_state()
    data = trainer._device_prefetch(iter(batches(2)), "cpu")
    for _ in range(2):
        mel, audio = next(data)
        trainer.train_step(state, mel, audio)
    data.close()
    assert made == []
    profiled(lambda: eng.feed_device(cond, sel))
    assert "nvw:feed_device" in made


@pytest.mark.parametrize("ragged", [True, False])
def test_feed_device_spans_nest_in_order(ragged):
    eng = engine()
    cond, sel = chunk(6, seed=1)
    lengths = np.array([5, 0, 3]) if ragged else None
    spans = profiled(lambda: eng.feed_device(cond, sel, lengths=lengths))
    feeds = [s for s in spans if s[0] == "feed_device"]
    assert len(feeds) == 1
    assert [s[0] for s in inside(feeds[0], spans)] == [
        "feed.stage", "feed.prefold", "feed.launch"]
    assert {s[3] for s in spans} == {feeds[0][3]}


def test_train_step_spans_nest_in_order():
    state = train_state()
    mel, audio = (torch.from_numpy(a) for a in batches(1)[0])
    spans = profiled(lambda: trainer.train_step(state, mel, audio))
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == 1
    assert [s[0] for s in inside(steps[0], spans)] == [
        "train.optimizer", "train.forward", "train.backward",
        "train.optimizer"]


def test_data_pipeline_spans_by_thread(tmp_path):
    with tracing.trace(str(tmp_path / "data.json")) as prof:
        with tracing.span("consumer"):
            pass
        data = trainer._device_prefetch(iter(batches(3)), "cpu")
        for _ in range(3):
            next(data)
        data.close()
    spans = spans_of(prof)
    (main,) = {s[3] for s in spans if s[0] == "consumer"}
    thread = {}
    for name, _, _, th in spans:
        thread.setdefault(name, set()).add(th)
    assert thread["data.wait"] == {main}
    assert len(thread["data.featurize"]) == 1
    assert thread["data.featurize"] == thread["data.stage"] != {main}
    assert len([s for s in spans if s[0] == "data.stage"]) >= 3


def test_a_ragged_feed_counts_k5_row_steps():
    eng = engine()
    cond, sel = chunk(6, seed=2)
    before = tracing.counters()
    eng.feed_device(cond, sel, lengths=np.array([3, 0, 5]))
    eng.feed_device(cond, sel, lengths=np.array([0, 0, 0]))
    after = tracing.counters()
    # K5 runs each row its own length: the launch lasts 5 steps, not 6
    assert after["k5.row_steps"] - before.get("k5.row_steps", 0) == B * 5
    assert (after["k5.live_row_steps"]
            - before.get("k5.live_row_steps", 0)) == 3 + 5


def test_mesh_collectives_are_spans_and_counters():
    mesh = TrainMesh(1)
    assert not hasattr(mesh, "stats") and not hasattr(mesh, "timing")
    t = torch.zeros(4, 5)
    before = tracing.counters()

    def collective():
        with mesh._count("halo", t):
            pass
    spans = profiled(collective)
    after = tracing.counters()
    assert [s[0] for s in spans] == ["mesh.halo"]
    assert after["mesh.halo"] - before.get("mesh.halo", 0) == 1
    assert (after["mesh.halo.bytes"]
            - before.get("mesh.halo.bytes", 0)) == 4 * 5 * 4


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "t" / "trace.json"
    with tracing.trace(str(path)):
        with tracing.span("marker", 1):
            torch.ones(8).add_(1)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "nvw:marker" for e in events)
