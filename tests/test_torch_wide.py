"""K1 card-wide on the CPU (`ops/persistent.py::wide_plan`, `wide_stream`,
`wide_model`, the route and the counters; the kernel,
`csrc/wide_generate.cu`, runs only on the card).

* The route names K1 card-wide for the wide vocoder (30 layers, R = 512,
  S = A = 256, no embedding tanh) at B = 16 in exact lockstep generation,
  and keeps the flagship and config 4 on the staged kernel and K5, the
  dumps and the low precisions on the generic one.
* The plan splits every product's columns over its CTAs once each (unevenly
  where the grid does not divide a width), fits the block, and its stream
  holds each CTA's slices of the canonical stacks.
* A plain model of the kernel's column slices (each CTA's slices read from
  the stream at the kernel's offsets, the ring written by each CTA's pair
  slice after the gate) equals the staged kernel's row model bit for bit in
  y, the ring and y_state, and `generate_plain` in y and y_state, at small
  wide geometries with uneven slices, over two chunks.
* The benchmark's wide reference (`benchmark/reference/wide_wavenet_ref.py`)
  agrees with the port's plain path without the embedding tanh: every
  selector inside its interval, in blocks of any size.
* The counters: the launch's host counters (its row-steps, grid barriers and
  clusters) and span, and the card's stamps read through
  `tracing.counters()` only when it is read; the A/B tool's call of an
  older tree's entry point.
* The engine folds cond + dil_b into the stale fold's storage (the wide
  cell's 32 GB prefold, freed and allocated anew, found no room on the card).
"""

import torch
import pytest

from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.utils import tracing

from tests.test_torch_staged import (CONFIG4, _fresh, _inputs, _params,
                                     _RowProducts, model_run)

WIDE = tcfg.WaveNetConfig(num_layers=30, R=512, S=256, A=256,
                          max_dilation=512, tanh_embed=False)
# small geometries run on a grid of a few SMs, so that slices are uneven
SMALL = [
    (tcfg.WaveNetConfig(num_layers=3, R=12, S=20, A=32, max_dilation=2,
                        silence_bin=16, tanh_embed=False), 3, 8),
    (tcfg.WaveNetConfig(num_layers=4, R=16, S=12, A=40, max_dilation=4,
                        silence_bin=20), 2, 3),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_route_takes_the_wide_kernel_for_the_wide_vocoder():
    route = tper.generation_route(WIDE, 16)
    assert route.kernel == "wide" and "Wprev" in route.note
    assert route.plan == tper.wide_plan(WIDE, 16)
    assert route.cuda_kernel() is tper.WIDE_KERNELS["exact"]
    assert route.cuda_kernel().source == "wide_generate.cu"
    assert tper.generation_route(WIDE, 16, mode="argmax").kernel == "wide"
    # what K1 card-wide does not run keeps its route
    assert tper.generation_route(WIDE, 16, ragged=True).kernel == "generic"
    assert tper.generation_route(WIDE, 16, dump=True).kernel == "generic"
    for prec in ("fast", "bf16"):
        assert tper.generation_route(WIDE, 16, prec).kernel == "generic"
    for mode in ("forced", "prng"):   # the first K4, on fp32 stacks
        route = tper.generation_route(WIDE, 16, mode=mode)
        assert route.kernel == "stream" and route.plan.storage == torch.float32
    assert tper.generation_route(WIDE, 16, stream_weights=True).kernel \
        == "stream"
    # the staged kernel's geometries stay on it
    for cfg, batch in ((tcfg.FLAGSHIP_CONFIG, 16), (CONFIG4, 64)):
        assert tper.generation_route(cfg, batch).kernel == "staged"


def test_plan_at_the_published_widths():
    plan = tper.wide_plan(WIDE, 16)
    assert plan.ctas == 128 and plan.ctas <= tper.SMS
    assert set(plan.cta_bytes) == {plan.stream_bytes // 128}
    # every weight but the embedding and the biases, once
    L, R, S, A = 30, 512, 256, 256
    assert plan.stream_bytes == 4 * (L * (4 * R * R + R * (R + S))
                                     + S * A + A * A)
    assert plan.smem_bytes <= tper.SMEM_PER_BLOCK - tper._STATIC_SMEM
    assert plan.threads == plan.chain_threads + plan.prev_threads + 32
    assert plan.threads <= tper.WIDE_MAX_THREADS
    assert plan.chain_slots >= 2 and plan.prev_slots == 2
    assert len(plan.kernel_args()) == 11


@pytest.mark.parametrize("cfg,batch,sms", SMALL)
def test_plan_splits_every_column_once(cfg, batch, sms):
    plan = tper.wide_plan(cfg, batch, sms=sms)
    assert plan.ctas <= sms
    for bounds, n in ((plan.pairs, cfg.R), (plan.rs, cfg.R + cfg.S),
                      (plan.out, cfg.A)):
        assert bounds[0] == 0 and bounds[-1] == n
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
    widths = {plan.rs[c + 1] - plan.rs[c] for c in range(plan.ctas)}
    assert len(widths) > 1   # uneven
    assert sum(plan.cta_bytes) == plan.stream_bytes
    assert plan.smem_bytes <= tper.SMEM_PER_BLOCK - tper._STATIC_SMEM


def test_plan_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="exact"):
        tper.wide_plan(WIDE, 16, "bf16")
    with pytest.raises(ValueError, match="modes"):
        tper.wide_plan(WIDE, 16, mode="forced")
    with pytest.raises(ValueError, match="multiples of 4"):
        tper.wide_plan(tcfg.WaveNetConfig(num_layers=2, R=10, S=16, A=32,
                                          max_dilation=2, silence_bin=16), 2)
    with pytest.raises(ValueError, match="slot"):   # A = 2048's end slice
        tper.wide_plan(tcfg.WaveNetConfig(num_layers=20, R=64, S=256,
                                          A=2048, max_dilation=512), 4)
    with pytest.raises(ValueError, match="shared memory"):
        tper.wide_plan(WIDE, 64)


@pytest.mark.parametrize("cfg,batch,sms", SMALL)
def test_stream_holds_each_ctas_slices(cfg, batch, sms):
    plan = tper.wide_plan(cfg, batch, sms=sms)
    p = _params(cfg)
    stream = tper.wide_stream(p, cfg, plan)
    R, pos = cfg.R, 0

    def take(K, n):
        nonlocal pos
        q = stream[pos:pos + K * n].view(K // 4, n, 4)
        pos += K * n
        return q.permute(0, 2, 1).reshape(K, n)
    for c in range(plan.ctas):
        p0, p1 = plan.pairs[c], plan.pairs[c + 1]
        cols = [i for u in range(p0, p1) for i in (u, R + u)]
        for l in range(cfg.num_layers):
            assert torch.equal(take(R, len(cols)), p["dil_w"][l, :R][:, cols])
            assert torch.equal(take(R, len(cols)), p["dil_w"][l, R:][:, cols])
            q0, q1 = plan.rs[c], plan.rs[c + 1]
            assert torch.equal(take(R, q1 - q0), p["rs_w"][l][:, q0:q1])
        a0, a1 = plan.out[c], plan.out[c + 1]
        assert torch.equal(take(cfg.S, a1 - a0), p["out_w"][:, a0:a1])
        assert torch.equal(take(cfg.A, a1 - a0), p["end_w"][:, a0:a1])
    assert pos == stream.numel()


@pytest.mark.parametrize("mode", ["sample", "argmax"])
@pytest.mark.parametrize("cfg,batch,sms", SMALL)
def test_model_of_the_slices_equals_the_plain_versions(cfg, batch, sms, mode):
    """Two chunks (7 + 5 steps, the second from t0 = 7): the column-slice
    model against the staged row model (the same sums, one row at a time)
    bit for bit, and `generate_plain` in y and y_state."""
    plan = tper.wide_plan(cfg, batch, sms=sms)
    params = _params(cfg, seed=9)
    stream = tper.wide_stream(params, cfg, plan)
    cond, sel = _inputs(cfg, batch, 12, seed=4)
    cond_pre = cond + params["dil_b"][None, :, None, :]
    prod = _RowProducts(params, cfg)
    got, row, plain = _fresh(cfg, batch, "exact"), _fresh(cfg, batch,
                                                          "exact"), \
        _fresh(cfg, batch, "exact")
    for t0, n in ((0, 7), (7, 5)):
        cp = cond_pre[t0:t0 + n].contiguous()
        s = sel[t0:t0 + n].contiguous()
        y, _, _ = tper.wide_model(cfg, plan, stream, params, t0, cp, s,
                                  *got, n, mode)
        y_row, _, _, _ = model_run(cfg, params, prod,
                                   torch.full((batch,), t0), cp, s, *row,
                                   torch.full((batch,), n), mode)
        y_plain = tper.generate_plain(cfg, params, t0, cp, s, *plain, n,
                                      mode)[0]
        assert torch.equal(y, y_row) and torch.equal(y, y_plain)
    assert torch.equal(got[0], row[0])           # the ring, bit for bit
    assert torch.equal(got[1], row[1]) and torch.equal(got[1], plain[1])
    assert torch.allclose(got[0], plain[0], rtol=1e-5, atol=1e-6)


def test_a_stream_of_another_layout_changes_the_model():
    """Mutation check: the model reads the stream, not the params."""
    cfg, batch, sms = SMALL[0]
    plan = tper.wide_plan(cfg, batch, sms=sms)
    params = _params(cfg, seed=9)
    stream = tper.wide_stream(params, cfg, plan)
    bad = stream.clone()
    n = cfg.R * 2 * (plan.pairs[1] - plan.pairs[0])
    bad[n:2 * n] = stream[:n]   # CTA 0's layer-0 Wcur replaced by its Wprev
    cond, sel = _inputs(cfg, batch, 6, seed=4)
    cond_pre = cond + params["dil_b"][None, :, None, :]
    outs = []
    for s_ in (stream, bad):
        st = _fresh(cfg, batch, "exact")
        tper.wide_model(cfg, plan, s_, params, 0, cond_pre, sel, *st, 6)
        outs.append(st[0])
    assert not torch.equal(*outs)


@pytest.mark.parametrize("block", [5, 64])
def test_wide_reference_agrees_with_the_port_without_tanh(block):
    from benchmark.reference import wide_wavenet_ref
    cfg = SMALL[0][0]
    bcfg = {"num_layers": cfg.num_layers, "R": cfg.R, "S": cfg.S,
            "A": cfg.A, "max_dilation": cfg.max_dilation}
    B, T = 3, 40
    params = _params(cfg, seed=3)
    cond, sel = _inputs(cfg, B, T, seed=8)
    cond_pre = cond + params["dil_b"][None, :, None, :]
    ring, y_state = _fresh(cfg, B, "exact")
    y = tper.generate_plain(cfg, params, 0, cond_pre, sel, ring, y_state,
                            T)[0]
    za = wide_wavenet_ref.teacher_forced_logits(
        params, bcfg, cond, y, silence=cfg.silence_bin, block=block)
    gaps = wide_wavenet_ref.selector_gaps(za, y, sel)
    assert gaps["widest_gap"] == 0.0 and gaps["samples"] == T * B
    whole = wide_wavenet_ref.teacher_forced_logits(
        params, bcfg, cond, y, silence=cfg.silence_bin, block=T)
    assert torch.allclose(za, whole, rtol=0, atol=1e-5)
    # a served sample changed reads a gap
    y2 = y.clone()
    y2[9, 1] = (y2[9, 1] + 5) % cfg.A
    za2 = wide_wavenet_ref.teacher_forced_logits(
        params, bcfg, cond, y2, silence=cfg.silence_bin, block=block)
    assert wide_wavenet_ref.selector_gaps(za2, y2, sel)["widest_gap"] > 1e-3


class _Stub:
    """A kernel that records its arguments and reports the launch's cluster
    size as the C side does (no card here)."""

    def __init__(self, cluster=1):
        self.calls = []
        self.cluster = cluster

    def __call__(self, *args):
        self.calls.append(args)
        args[-1].contents.value = self.cluster


def test_the_launch_counts_its_row_steps_and_opens_its_span(monkeypatch):
    cfg, batch, sms = SMALL[0]
    plan = tper.wide_plan(cfg, batch, sms=sms)
    stub = _Stub()
    monkeypatch.setitem(tper.WIDE_KERNELS, "exact", stub)
    monkeypatch.setattr(tper, "_WIDE_STATS", {})
    params = _params(cfg)
    cond, sel = _inputs(cfg, batch, 9, seed=1)
    ring, y_state = _fresh(cfg, batch, "exact")
    scratch = torch.empty(plan.scratch_floats)
    sync = torch.zeros(1, dtype=torch.int32)
    sched = tper.fifo_schedule(cfg, "cpu")
    before = tracing.counters()
    spans = []
    real = tracing.span
    monkeypatch.setattr(tracing, "span",
                        lambda name, id=None: spans.append(name) or real(name))
    plan_arr = tper._plan_array(plan)
    for n in (9, 4, 0):
        tper._launch_wide(cfg, plan_arr, params, torch.zeros(4), scratch,
                          sync, sched, 3, cond, sel, ring, y_state, n,
                          "sample", 0)
    after = tracing.counters()
    assert after["gen.wide.launches"] - before.get("gen.wide.launches", 0) \
        == 2
    assert after["gen.wide.row_steps"] - before.get("gen.wide.row_steps", 0) \
        == batch * 13
    assert spans == ["gen.wide.launch"] * 2 and len(stub.calls) == 2
    args = stub.calls[0]
    assert args[14:24] == (3, 9, batch, cfg.num_layers, cfg.R, cfg.S, cfg.A,
                           0, cfg.silence_bin, 0)
    assert args[13] == tper._wide_stats(torch.device("cpu")).data_ptr()
    monkeypatch.setattr(tper, "WIDE_STAMPS", False)
    tper._launch_wide(cfg, plan_arr, params, torch.zeros(4), scratch, sync,
                      sched, 0, cond, sel, ring, y_state, 2, "argmax", 0)
    assert stub.calls[-1][13] is None and stub.calls[-1][23] == 1


@pytest.mark.parametrize("cluster", [8, 4, 1])
def test_the_launch_counts_its_barriers_and_clusters(monkeypatch, cluster):
    """2L + 2 grid barriers a step, and the clusters a launch ran in: G over
    the cluster size the launch reports; a call of no steps counts
    nothing."""
    cfg, batch = SMALL[1][0], SMALL[1][1]
    plan = tper.wide_plan(cfg, batch, sms=8)
    assert plan.ctas == 8
    monkeypatch.setitem(tper.WIDE_KERNELS, "exact", _Stub(cluster))
    monkeypatch.setattr(tper, "_WIDE_STATS", {})
    cond, sel = _inputs(cfg, batch, 9, seed=1)
    ring, y_state = _fresh(cfg, batch, "exact")
    plan_arr = tper._plan_array(plan)
    keys = ("gen.wide.barriers", "gen.wide.clusters")
    for n in (9, 0):
        before = tracing.counters()
        tper._launch_wide(cfg, plan_arr, _params(cfg), torch.zeros(4),
                          torch.empty(plan.scratch_floats),
                          torch.zeros(1, dtype=torch.int32),
                          tper.fifo_schedule(cfg, "cpu"), 0, cond, sel, ring,
                          y_state, n, "sample", 0)
        after = tracing.counters()
        got = [after.get(k, 0) - before.get(k, 0) for k in keys]
        assert got == ([n * (2 * cfg.num_layers + 2), plan.ctas // cluster]
                       if n else [0, 0])


def test_the_ab_tool_calls_each_tree_with_its_own_arguments():
    """tools/wide_ab.py cuts this tree's arguments to the other tree's entry
    point: this tree's has one a ctypes argument type, an entry point
    without the trailing cluster-size pointer one fewer."""
    import pathlib
    from nv_wavenet_tpu_torch.tools import wide_ab
    from nv_wavenet_tpu_torch.utils import build
    text = (pathlib.Path(build.CSRC_DIR) / "wide_generate.cu").read_text()
    n = len(tper.WIDE_KERNELS["exact"].argtypes)
    assert wide_ab.entry_arity(text) == n
    older = text.replace(", void* stream, int* cluster)", ", void* stream)")
    assert older != text and wide_ab.entry_arity(older) == n - 1


def test_the_cards_stamps_are_read_with_the_counters(monkeypatch):
    monkeypatch.setattr(tper, "_WIDE_STATS", {})
    assert "gen.wide.wait_cycles" not in tracing.counters()
    st = tper._wide_stats(torch.device("cpu"))
    st += torch.arange(len(tper.WIDE_STATS)) * 10
    c = tracing.counters()
    assert c["gen.wide.wait_cycles"] == 0 and c["gen.wide.cta_cycles"] == 10
    assert c["gen.wide.stream_wait_cycles"] == 20
    assert set(tper.WIDE_STATS) <= set(c)
    st[1] += 90   # read anew each time
    assert tracing.counters()["gen.wide.cta_cycles"] == 100


def test_the_engine_refolds_into_the_stale_prefolds_storage():
    """set_inputs drops cond + dil_b; the next fold writes the new values
    into the old buffer (the wide cell's 32 GB prefold, freed and allocated
    anew, may not find room again), exactly as a fresh fold would."""
    import numpy as np
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    cfg = tcfg.WaveNetConfig(num_layers=2, R=8, S=16, A=256,
                             max_dilation=2, tanh_embed=False)
    eng = WaveNetInfer(num_layers=cfg.num_layers, max_dilation=2, R=cfg.R,
                       S=cfg.S, A=cfg.A, max_batch=2, device="cpu",
                       tanh_embed=False)
    eng.set_canonical_params({k: v.numpy() for k, v in
                              _params(cfg, seed=2).items()})
    rng = np.random.RandomState(4)
    conds = [rng.uniform(-0.5, 0.5, (6, cfg.num_layers, 2, 2 * cfg.R))
             .astype(np.float32) for _ in range(3)]
    eng.set_inputs(conds[0])
    eng.run(6, 2)
    first = eng._cond_pre
    eng.set_inputs(conds[1])
    eng.run(6, 2)
    assert eng._cond_pre.data_ptr() == first.data_ptr()
    dil_b = eng._value_params()["dil_b"]
    assert torch.equal(eng._cond_pre, torch.from_numpy(conds[1])
                       + dil_b[None, :, None, :])
    eng.set_inputs(conds[2][:4])   # another shape: a buffer of its own
    eng.run(4, 2)
    assert eng._cond_pre.shape[0] == 4
