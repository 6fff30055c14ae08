"""The port's streaming serving path on the CPU: `begin_stream`/`feed` with
per-row ragged `lengths` (the plain version of kernel K5), slot handover by
`reset_utterances`, `export_state`/`import_state` and the sampling
temperature, against the JAX engine run as its own tests run it
(`interpret=True`, `Impl.PERSISTENT`), the numpy golden model and single-row
port engines, on the same numpy inputs from a seed.  Samples are held to
exact integer equality; the carried FIFO ring, where compared, to the xt
ladder (1e-2, atol 3e-4).

Small configs as the JAX package's tests use (6 layers, R=32).  With
dilations up to 8 and a few samples per tick, a FIFO phase error shows only
after several ticks, so the schedules cross many slot boundaries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu.ops import persistent as jper
from nv_wavenet_tpu_torch.engine import wavenet_infer as tinfer
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import persistent as tper

from tests.test_golden_vs_scan import make_case, rel_close
from tests.test_low_precision import hot_case
from tests.test_torch_persistent import port_cfg, unpack_ring

CFG = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=8)
CFG4 = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)


def port_engine(cfg, B, ref_w=None, **kw):
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=8, device="cpu", **kw)
    if ref_w is not None:
        eng.set_reference_weights(ref_w)
    return eng


def jax_engine(cfg, B, ref_w):
    eng = jinfer.WaveNetInfer(num_layers=cfg.num_layers,
                              max_dilation=cfg.max_dilation, R=cfg.R,
                              S=cfg.S, A=cfg.A, max_batch=B,
                              implementation=jinfer.Impl.PERSISTENT,
                              chunk_size=8, interpret=True)
    eng.set_reference_weights(ref_w)
    return eng


def golden(cfg, ref_w, cond, sel):
    T, _, B, _ = cond.shape
    g = WaveNetGolden(cfg, max_batch=B, max_samples=max(T, 1))
    g.set_reference_weights(ref_w)
    g.set_inputs(cond, sel)
    return g.run(T, B)


def row_streams(cfg, rng, totals):
    """Per-row conditioning [n_b, L, 2R] and selectors [n_b]."""
    conds = [rng.uniform(-0.5, 0.5, (n, cfg.num_layers, 2 * cfg.R))
             .astype(np.float32) for n in totals]
    sels = [rng.uniform(0, 1, n).astype(np.float32) for n in totals]
    return conds, sels


def tick_inputs(cfg, conds, sels, pos, lens):
    """One tick's [max len, L, B, 2R] chunk and [max len, B] selectors: row
    b's next lens[b] steps from position pos[b] of its own stream, zeros
    past its length."""
    B, Tm = len(lens), int(max(lens))
    c = np.zeros((Tm, cfg.num_layers, B, 2 * cfg.R), np.float32)
    s = np.zeros((Tm, B), np.float32)
    for b, n in enumerate(lens):
        c[:n, :, b] = conds[b][pos[b]:pos[b] + n]
        s[:n, b] = sels[b][pos[b]:pos[b] + n]
    return c, s


def serve(eng, cfg, conds, sels, sched, inject=True, pos=None):
    """Feed a per-row schedule [ticks, B]; returns each row's samples and
    the rows' positions after the schedule."""
    B = sched.shape[1]
    pos = np.zeros(B, np.int64) if pos is None else pos.copy()
    outs = [[] for _ in range(B)]
    for lens in sched:
        c, s = tick_inputs(cfg, conds, sels, pos, lens)
        y = eng.feed(c, s if inject else None, lengths=lens)
        assert y.shape == (B, int(lens.max()))
        for b in range(B):
            outs[b].append(y[b, :lens[b]])
            assert not y[b, lens[b]:].any()
        pos += lens
    return [np.concatenate(o) if o else np.zeros(0, np.int32)
            for o in outs], pos


def alone(cfg, ref_w, cond_row, sel_row):
    """Row generated alone: a fresh single-row port engine, one feed.
    Returns its samples and its ring [ring_size, R] (at its clock)."""
    eng = port_engine(cfg, 1, ref_w)
    eng.begin_stream(1)
    y = (eng.feed(cond_row[:, :, None], sel_row[:, None])[0] if len(cond_row)
         else np.zeros(0, np.int32))
    return y, eng.export_state()["ring"][:, 0]


def hot_weights(cfg, seed):
    """Trained-scale weights (tests/test_low_precision.py::hot_case): a
    peaked output distribution, so a wrong FIFO read changes samples."""
    return hot_case(cfg, 1, 1, seed)[3]


# ----------------------------------------------------------------------
# lockstep feeds
# ----------------------------------------------------------------------

FEEDS = (5, 1, 8, 3)


@pytest.fixture(scope="module")
def lockstep_case():
    """tests/test_engine.py::test_streaming_feed_matches_full_run's case, fed
    (5, 1, 8, 3) through the JAX engine with injected and with default
    selectors (one engine, so each feed shape compiles once)."""
    B, T = 3, sum(FEEDS)
    ref_w, cond, sel = make_case(CFG4, B, T, seed=61)
    eng = jax_engine(CFG4, B, ref_w)
    ys = {}
    for inject in (True, False):
        eng.begin_stream(B)
        outs, off = [], 0
        for n in FEEDS:
            outs.append(eng.feed(cond[off:off + n],
                                 sel[off:off + n] if inject else None))
            off += n
        ys[inject] = np.concatenate(outs, axis=1)
    return ref_w, cond, sel, ys


def feed_port(ref_w, cond, sel, chunks, **kw):
    eng = port_engine(CFG4, cond.shape[2], ref_w, **kw)
    eng.begin_stream(cond.shape[2])
    outs, off = [], 0
    for n in chunks:
        outs.append(eng.feed(cond[off:off + n],
                             None if sel is None else sel[off:off + n]))
        off += n
    return np.concatenate(outs, axis=1)


def test_feed_schedule_matches_jax_engine_and_golden(lockstep_case):
    ref_w, cond, sel, ys = lockstep_case
    y = feed_port(ref_w, cond, sel, FEEDS)
    assert np.array_equal(y, golden(CFG4, ref_w, cond, sel))
    assert np.array_equal(y, ys[True])


def test_default_selectors_chunk_invariant_and_equal_jax(lockstep_case):
    ref_w, cond, _, ys = lockstep_case
    y = feed_port(ref_w, cond, None, FEEDS)
    assert np.array_equal(y, ys[False])
    for chunks in ((17,), (3, 3, 3, 3, 3, 2), (1,) * 17):
        assert np.array_equal(feed_port(ref_w, cond, None, chunks), y)
    # one default stream across input modes: set_inputs(cond) + run()
    eng = port_engine(CFG4, 3, ref_w)
    eng.set_inputs(cond)
    assert np.array_equal(eng.run(17, 3), y)


# ----------------------------------------------------------------------
# per-row ragged feeds
# ----------------------------------------------------------------------

RAGGED_TICKS, SNAP_TICK = 4, 2


@pytest.fixture(scope="module")
def ragged_case():
    """tests/test_ragged_feed.py::test_ragged_feed_matches_per_row_engines'
    schedules through the JAX engine's ragged feed, injected and default
    selectors; the JAX snapshot and row clocks after tick SNAP_TICK of the
    injected run; the JAX ring at the end of it."""
    B = 3
    rng = np.random.RandomState(71)
    ref_w = params_lib.random_reference_weights(CFG, seed=71)
    sched = np.stack([rng.randint(0, 7, size=B) for _ in range(RAGGED_TICKS)])
    conds, sels = row_streams(CFG, rng, sched.sum(axis=0))
    eng = jax_engine(CFG, B, ref_w)
    out = {"ref_w": ref_w, "sched": sched, "conds": conds, "sels": sels}
    for inject in (True, False):
        eng.begin_stream(B)
        ys, pos = [], np.zeros(B, np.int64)
        for k, lens in enumerate(sched):
            if k == SNAP_TICK and inject:
                out["jax_snap"] = eng.export_state()
                out["jax_clocks"] = eng._stream_t_row.copy()
            c, s = tick_inputs(CFG, conds, sels, pos, lens)
            ys.append(eng.feed(c, s if inject else None, lengths=lens))
            pos += lens
        out[inject] = ys
        if inject:
            out["jax_ring"] = unpack_ring(CFG, eng.export_state()["ring"])
    return out


@pytest.mark.parametrize("inject", [True, False])
def test_ragged_feed_matches_jax_and_rows_alone(ragged_case, inject):
    """Row b of a ragged-fed batch equals the JAX engine's ragged feed tick
    by tick, and the same row generated alone in a single-row port engine
    (the default stream is keyed on (clock, batch row), so the lone engine
    is injected with row b's default values)."""
    r = ragged_case
    sched, conds, sels = r["sched"], r["conds"], r["sels"]
    B = sched.shape[1]
    eng = port_engine(CFG, B, r["ref_w"])
    eng.begin_stream(B)
    pos = np.zeros(B, np.int64)
    for lens, y_j in zip(sched, r[inject]):
        c, s = tick_inputs(CFG, conds, sels, pos, lens)
        y = eng.feed(c, s if inject else None, lengths=lens)
        assert np.array_equal(y, y_j)
        pos += lens
    assert np.array_equal(eng._stream_t_row, pos)
    if inject:
        assert rel_close(r["jax_ring"], eng.export_state()["ring"], 1e-2,
                         atol=3e-4)
    for b in range(B):
        n = int(pos[b])
        sel_b = (sels[b] if inject else
                 tinfer._selector_stream(eng.sampling_seed, 0, n, B)[:, b])
        got = np.concatenate([y[b, :lens[b]] for y, lens
                              in zip(r[inject], sched)])
        y_alone, ring_alone = alone(CFG, r["ref_w"], conds[b], sel_b)
        assert np.array_equal(got, y_alone)
        if inject:
            assert rel_close(ring_alone, eng.export_state()["ring"][:, b],
                             1e-2, atol=3e-4)


def test_jax_snapshot_imports_and_continues_equal(ragged_case):
    """A JAX snapshot taken mid-desync, converted (unpack_ring plus the JAX
    engine's row clocks), continues in the port exactly as the JAX engine
    went on; its ring equals the port's own at the same clocks."""
    r = ragged_case
    sched, conds, sels = r["sched"], r["conds"], r["sels"]
    B = sched.shape[1]
    snap = r["jax_snap"]
    conv = {"ring": unpack_ring(CFG, snap["ring"]), "y_state": snap["y_state"],
            "stream_t_row": r["jax_clocks"], "stream_t": snap["stream_t"],
            "stream_batch": snap["stream_batch"]}
    assert len(set(r["jax_clocks"])) > 1        # taken while desynced

    own = port_engine(CFG, B, r["ref_w"])
    own.begin_stream(B)
    _, pos = serve(own, CFG, conds, sels, sched[:SNAP_TICK])
    mine = own.export_state()
    assert np.array_equal(mine["stream_t_row"], conv["stream_t_row"])
    assert np.array_equal(mine["y_state"], conv["y_state"])
    assert rel_close(conv["ring"], mine["ring"], 1e-2, atol=3e-4)

    eng = port_engine(CFG, B, r["ref_w"])
    eng.import_state(conv)
    for lens, y_j in zip(sched[SNAP_TICK:], r[True][SNAP_TICK:]):
        c, s = tick_inputs(CFG, conds, sels, pos, lens)
        assert np.array_equal(eng.feed(c, s, lengths=lens), y_j)
        pos += lens


def test_ragged_then_realigned_routes_back_to_lockstep(monkeypatch):
    """Once the row clocks realign, a feed without lengths runs lockstep
    (K1's path, not `_feed_ragged`) and the stream equals the uninterrupted
    one and the golden model."""
    B, T = 2, 18
    rng = np.random.RandomState(73)
    ref_w = params_lib.random_reference_weights(CFG, seed=73)
    cond = rng.uniform(-0.5, 0.5, (T, CFG.num_layers, B, 2 * CFG.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)
    un = port_engine(CFG, B, ref_w)
    un.begin_stream(B)
    y_un = un.feed(cond, sel)
    assert np.array_equal(y_un, golden(CFG, ref_w, cond, sel))

    eng = port_engine(CFG, B, ref_w)
    ragged_calls = []
    feed_ragged = eng._feed_ragged
    monkeypatch.setattr(eng, "_feed_ragged",
                        lambda *a: ragged_calls.append(a) or feed_ragged(*a))
    eng.begin_stream(B)
    conds = [cond[:, :, b] for b in range(B)]
    sels = [sel[:, b] for b in range(B)]
    outs, pos = serve(eng, CFG, conds, sels, np.array([[5, 2], [3, 6]]))
    assert list(pos) == [8, 8] and len(ragged_calls) == 2
    y_tail = eng.feed(cond[8:], sel[8:])
    assert len(ragged_calls) == 2                 # realigned: lockstep
    for b in range(B):
        assert np.array_equal(np.concatenate([outs[b], y_tail[b]]), y_un[b])


def test_ragged_handover_mid_stream():
    """tests/test_ragged_feed.py::test_ragged_handover_mid_stream against
    the JAX engine: row 1 is reset mid-desync and starts a new utterance
    from clock 0 while row 0 goes on."""
    B = 2
    rng = np.random.RandomState(79)
    ref_w = params_lib.random_reference_weights(CFG, seed=79)
    condA = rng.uniform(-0.5, 0.5, (14, CFG.num_layers, 1, 2 * CFG.R)
                        ).astype(np.float32)
    condB = rng.uniform(-0.5, 0.5, (9, CFG.num_layers, 1, 2 * CFG.R)
                        ).astype(np.float32)
    c = np.zeros((6, CFG.num_layers, B, 2 * CFG.R), np.float32)
    c[:6, :, 0] = condA[:6, :, 0]
    c[:3, :, 1] = rng.uniform(-0.5, 0.5, (3, CFG.num_layers, 2 * CFG.R))
    c2 = np.zeros((9, CFG.num_layers, B, 2 * CFG.R), np.float32)
    c2[:8, :, 0] = condA[6:, :, 0]
    c2[:9, :, 1] = condB[:, :, 0]

    ys = {}
    for name, eng in (("jax", jax_engine(CFG, B, ref_w)),
                      ("port", port_engine(CFG, B, ref_w))):
        eng.begin_stream(B)
        y1 = eng.feed(c, lengths=np.array([6, 3]))
        eng.reset_utterances([1])
        y2 = eng.feed(c2, lengths=np.array([8, 9]))
        ys[name] = (y1, y2)
    for a, b in zip(ys["jax"], ys["port"]):
        assert np.array_equal(a, b)
    y1, y2 = ys["port"]
    sel0 = tinfer._selector_stream(0, 0, 14, B)[:, 0]
    assert np.array_equal(np.concatenate([y1[0, :6], y2[0, :8]]),
                          alone(CFG, ref_w, condA[:, :, 0], sel0)[0])
    sel1 = tinfer._selector_stream(0, 0, 9, B)[:, 1]
    assert np.array_equal(y2[1, :9],
                          alone(CFG, ref_w, condB[:, :, 0], sel1)[0])


# ----------------------------------------------------------------------
# slot handover, resets and the R3 sequence
# ----------------------------------------------------------------------

def test_reset_utterances_continuous_batching():
    """tests/test_engine.py::test_reset_utterances_continuous_batching: a
    reset row behaves as a fresh start while the others go on; the snapshot
    shows the reset row zeroed and the others kept."""
    cfg = WaveNetConfig(num_layers=8, R=32, S=128, A=256, max_dilation=8)
    B, T1, T2 = 3, 13, 11
    ref_w, cond, sel = make_case(cfg, B, T1 + T2, seed=41)
    eng = port_engine(cfg, B, ref_w)
    eng.begin_stream(B)
    before = eng.export_state()      # zero ring before any sample
    y1 = eng.feed(cond[:T1], sel[:T1])
    kept = eng.export_state()
    eng.reset_utterances([2])
    st = eng.export_state()
    assert np.all(st["ring"][:, 2] == 0) and np.all(st["y_state"][:, 2] == 128)
    assert np.array_equal(st["ring"][:, :2], kept["ring"][:, :2])
    assert np.any(st["ring"][:, :2] != before["ring"][:, :2])
    assert np.array_equal(st["y_state"][:, :2], kept["y_state"][:, :2])
    assert list(st["stream_t_row"]) == [T1, T1, 0]
    y2 = eng.feed(cond[T1:], sel[T1:])      # desynced rows: K5's path

    y_full = golden(cfg, ref_w, cond, sel)
    assert np.array_equal(np.concatenate([y1, y2], 1)[:2], y_full[:2])
    y_fresh = golden(cfg, ref_w, cond[T1:], sel[T1:])
    assert np.array_equal(y2[2], y_fresh[2])


def test_full_reset_then_partial_reset_r3():
    """Fault R3 of the JAX engine (ROADMAP.md): after a full-batch
    `reset_utterances` its lockstep feed takes t0 from a stream counter
    that kept the old count, so the ring is written at another phase than
    the row clocks (reset to 0) say, and a later partial reset sends the
    batch down the ragged path with that ring.  The JAX engine is therefore
    not the oracle here: every utterance is held to the golden model and to
    a fresh single-row port engine.  The port keys the lockstep feed's t0 on
    the common row clock."""
    B = 3
    rng = np.random.RandomState(83)
    ref_w = hot_weights(CFG, 83)
    # utterances: u0 per row before the full reset (5 samples), u1 per row
    # from the full reset on, and u2 for row 1 from the partial reset on
    u1_len, u2_len = 30, 17
    c0, s0 = row_streams(CFG, rng, [5] * B)
    c1, s1 = row_streams(CFG, rng, [u1_len] * B)
    c2, s2 = row_streams(CFG, rng, [u2_len])

    eng = port_engine(CFG, B, ref_w)
    eng.begin_stream(B)
    eng.feed(*tick_inputs(CFG, c0, s0, [0] * B, [5] * B))
    eng.reset_utterances(range(B))                 # full-batch reset
    assert list(eng._stream_t_row) == [0] * B
    ys = [[] for _ in range(B)]
    pos = np.zeros(B, np.int64)
    for n in (3, 4):                               # aligned: lockstep
        y = eng.feed(*tick_inputs(CFG, c1, s1, pos, [n] * B))
        for b in range(B):
            ys[b].append(y[b])
        pos += n
    eng.reset_utterances([1])                      # partial reset
    conds = [c1[0], c2[0], c1[2]]
    sels = [s1[0], s2[0], s1[2]]
    pos[1] = 0
    u2 = []
    sched = np.array([[5, 3, 2], [1, 6, 7], [8, 4, 3], [2, 4, 6]])
    for lens in sched:                             # desynced: ragged
        y = eng.feed(*tick_inputs(CFG, conds, sels, pos, lens),
                     lengths=lens)
        for b in (0, 2):
            ys[b].append(y[b, :lens[b]])
        u2.append(y[1, :lens[1]])
        pos += lens

    ring = eng.export_state()["ring"]
    for b, c, s, got in ((0, c1[0], s1[0], ys[0]), (1, c2[0], s2[0], u2),
                         (2, c1[2], s1[2], ys[2])):
        got = np.concatenate(got)
        n = len(got)
        ref = golden(CFG, ref_w, c[:n, :, None], s[:n, None])[0]
        assert np.array_equal(got, ref)
        y_alone, ring_alone = alone(CFG, ref_w, c[:n], s[:n])
        assert np.array_equal(got, y_alone)
        assert rel_close(ring_alone, ring[:, b], 1e-2, atol=3e-4)


# ----------------------------------------------------------------------
# snapshots: R7 and the round trip
# ----------------------------------------------------------------------

def test_snapshot_mid_desync_resumes_exactly_r7():
    """Fault R7 of the JAX engine (ROADMAP.md): its snapshot holds one
    stream counter and no row clocks, so a stream restored while its rows
    are desynced resumes lockstep at the largest clock, and every row that
    lagged reads its FIFOs at the wrong phase.  The port's snapshot holds
    each row's clock: a fresh engine restored mid-desync goes on exactly as
    the uninterrupted one, default selectors included (they are keyed on
    the row clocks)."""
    B = 3
    rng = np.random.RandomState(89)
    ref_w = hot_weights(CFG, 89)
    conds, sels = row_streams(CFG, rng, [40] * B)
    first = np.array([[5, 2, 7], [3, 0, 4]])
    then = np.array([[6, 6, 6], [3, 3, 3], [1, 5, 2]])

    def run(migrate):
        eng = port_engine(CFG, B, ref_w)
        eng.begin_stream(B)
        outs, pos = serve(eng, CFG, conds, sels, first, inject=False)
        if migrate:
            snap = eng.export_state()
            assert len(set(snap["stream_t_row"])) > 1
            eng = port_engine(CFG, B, ref_w)
            eng.import_state({k: np.array(v) for k, v in snap.items()})
        # desynced rows, no lengths: still per-row clocks
        ys = [eng.feed(tick_inputs(CFG, conds, sels, pos, [6] * B)[0])]
        pos += 6
        more, pos = serve(eng, CFG, conds, sels, then[1:], inject=False,
                          pos=pos)
        return outs, ys, more, pos, eng.export_state()["ring"]

    want, got = run(False), run(True)
    for a, b in zip(want[:3], got[:3]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert np.array_equal(want[3], got[3])
    assert np.array_equal(want[4], got[4])
    # and the uninterrupted stream is each row generated alone
    for b in range(B):
        n = int(got[3][b])
        sel_b = tinfer._selector_stream(0, 0, n, B)[:, b]
        row = np.concatenate([got[0][b], got[1][0][b], got[2][b]])
        y_alone, ring_alone = alone(CFG, ref_w, conds[b][:n], sel_b)
        assert np.array_equal(row, y_alone)
        assert rel_close(ring_alone, got[4][:, b], 1e-2, atol=3e-4)


def test_export_import_round_trip_stream_and_run_partial():
    """tests/test_engine.py::test_export_import_state_resumes_stream_exactly
    on the port: a stream continued in a fresh engine from its snapshot, and
    a run_partial continuation restored over a warm state, equal the
    uninterrupted run."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=64, A=256, max_dilation=4)
    B, T = 3, 14
    ref_w = params_lib.random_reference_weights(cfg, seed=91)
    rng = np.random.RandomState(9)
    cond = rng.uniform(-0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R)
                       ).astype(np.float32)

    e0 = port_engine(cfg, B, ref_w)
    e0.begin_stream(B)
    y_full = np.concatenate([e0.feed(cond[:6]), e0.feed(cond[6:])], axis=1)
    e1 = port_engine(cfg, B, ref_w)
    e1.begin_stream(B)
    y_a = e1.feed(cond[:6])
    snap = e1.export_state()
    assert set(snap) == {"ring", "y_state", "stream_t_row", "stream_t",
                         "stream_batch"}
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    assert snap["ring"].shape == (cfg.ring_size, B, cfg.R)
    assert list(snap["stream_t_row"]) == [6] * B and int(snap["stream_t"]) == 6
    e2 = port_engine(cfg, B, ref_w)
    e2.import_state({k: v.copy() for k, v in snap.items()})
    y_b = e2.feed(cond[6:])
    assert np.array_equal(np.concatenate([y_a, y_b], axis=1), y_full)

    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)
    e3 = port_engine(cfg, B, ref_w)
    e3.set_inputs(cond, sel)
    y_ref = e3.run(T, B)
    e4 = port_engine(cfg, B, ref_w)
    e4.set_inputs(cond, sel)
    e4.run_partial(0, 5, B)
    snap2 = e4.export_state()
    assert int(snap2["stream_t"]) == -1
    e5 = port_engine(cfg, B, ref_w)
    e5.set_inputs(cond, sel)
    e5.run_partial(0, 5, B)
    e5.import_state(snap2)
    assert np.array_equal(e5.run_partial(5, T - 5, B), y_ref[:, 5:])
    with pytest.raises(RuntimeError, match="begin_stream"):
        e5.feed(cond[:2])


# ----------------------------------------------------------------------
# temperature
# ----------------------------------------------------------------------

def test_sampling_temperature():
    """tests/test_engine.py::test_sampling_temperature on the port, and
    equal to the JAX engine at T=4."""
    B, T = 2, 12
    params, cond, sel, _ = hot_case(CFG, B, T, seed=47)
    canon = {k: np.asarray(v) for k, v in params.items()}

    def run(temp=None, mode="sample", eng=None):
        if eng is None:
            kw = {} if temp is None else {"temperature": temp}
            eng = port_engine(CFG, B, **kw)
            eng.set_canonical_params(canon)
        eng.set_inputs(cond, sel)
        return eng.run(T, B, mode=mode)

    y1 = run()
    eng1 = port_engine(CFG, B, temperature=1.0)
    eng1.set_canonical_params(canon)
    assert np.array_equal(run(eng=eng1), y1)
    for k in ("end_w", "end_b"):                  # T=1 is a bit no-op
        assert np.array_equal(eng1._device_params()[k].numpy(), canon[k])
    assert np.array_equal(run(0.01), run(mode="argmax"))
    y4 = run(4.0)
    assert not np.array_equal(y4, y1)

    eng = port_engine(CFG, B)
    eng.set_canonical_params(canon)
    assert np.array_equal(run(eng=eng), y1)
    dil_w = eng._device_params()["dil_w"]
    eng.set_temperature(4.0)                      # after upload
    assert eng._device_params()["dil_w"] is dil_w  # only end_w/end_b move
    assert np.array_equal(run(eng=eng), y4)
    eng.set_temperature(1.0)
    assert np.array_equal(run(eng=eng), y1)

    je = jinfer.WaveNetInfer(num_layers=CFG.num_layers,
                             max_dilation=CFG.max_dilation, R=CFG.R, S=CFG.S,
                             A=CFG.A, max_batch=B,
                             implementation=jinfer.Impl.PERSISTENT,
                             chunk_size=4, interpret=True, temperature=4.0)
    je.set_canonical_params(canon)
    je.set_inputs(cond, sel)
    assert np.array_equal(je.run(T, B), y4)


# ----------------------------------------------------------------------
# the plain K5 against the JAX ragged kernel
# ----------------------------------------------------------------------

def test_plain_ragged_generator_matches_jax_ragged_kernel():
    """The plain version of K5 against `make_persistent_generator(
    ragged=True, interpret=True)` with `rotate_ring_phase` around it, over
    two calls whose rows start from different clocks: exact y and y_state,
    the ring within the xt ladder after unpack_ring."""
    B, T = 3, 8
    rng = np.random.RandomState(97)
    ref_w = params_lib.random_reference_weights(CFG, seed=97)
    canon = params_lib.to_canonical(ref_w, CFG)
    calls = (np.array([5, 2, 7]), np.array([3, 8, 0]))
    conds = [rng.uniform(-0.5, 0.5, (T, CFG.num_layers, B, 2 * CFG.R))
             .astype(np.float32) for _ in calls]
    sels = [rng.uniform(0, 1, (T, B)).astype(np.float32) for _ in calls]

    gen_j = jper.make_persistent_generator(CFG, B, T, mode="sample",
                                           interpret=True, prefold_cond=True,
                                           ragged=True)
    pj = {k: jnp.asarray(v) for k, v in canon.items()}

    @jax.jit
    def jax_call(cond, sel, ring, y_state, t0_row, nvr):
        cond_pre = cond + pj["dil_b"][None, :, None, :]
        ring_l = jper.rotate_ring_phase(CFG, ring, t0_row, +1)
        y, ring_l, ys = gen_j(pj, jnp.zeros(1, jnp.int32), cond_pre, sel,
                              ring_l, y_state, n_valid=jnp.max(nvr),
                              n_valid_row=nvr)
        return y, jper.rotate_ring_phase(CFG, ring_l, t0_row, -1), ys

    pcfg = port_cfg(CFG)
    pt = tparams.canonical_to_torch(canon, "cpu")
    gen_t = tper.make_persistent_generator(pcfg, B, ragged=True)
    ring_j = jper.init_ring(CFG, B)
    ys_j = jnp.full((2, B), CFG.silence_bin, jnp.int32)
    ring_t = tper.init_ring(pcfg, B, "cpu")
    ys_t = torch.full((2, B), CFG.silence_bin, dtype=torch.int32)
    clocks = np.zeros(B, np.int64)
    launches = tper.RAGGED_KERNELS["exact"].launches
    for lens, cond, sel in zip(calls, conds, sels):
        y_j, ring_j, ys_j = jax_call(cond, sel, ring_j, ys_j,
                                     clocks.astype(np.int32),
                                     lens.astype(np.int32))
        cond_pre = (torch.from_numpy(cond)
                    + pt["dil_b"][None, :, None, :]).contiguous()
        y_t, _, _ = gen_t(pt, torch.from_numpy(clocks), cond_pre,
                          torch.from_numpy(sel), ring_t, ys_t,
                          torch.from_numpy(lens.astype(np.int32)))
        # the JAX kernel leaves y unwritten past the longest row's steps
        n = int(lens.max())
        assert np.array_equal(np.asarray(y_j)[:n], y_t.numpy()[:n])
        assert not y_t[n:].any()
        assert np.array_equal(np.asarray(ys_j), ys_t.numpy())
        assert rel_close(unpack_ring(CFG, ring_j), ring_t.numpy(), 1e-2,
                         atol=3e-4)
        clocks += lens
    assert tper.RAGGED_KERNELS["exact"].launches == launches   # CPU: no kernel


def test_lockstep_is_the_ragged_case_with_shared_clocks():
    """The plain loop with per-row clocks all equal and every length T is
    bit-identical to the lockstep loop: y, y_state and the ring."""
    B, T = 3, 11
    ref_w, cond, sel = make_case(CFG, B, T, seed=5)
    pcfg = port_cfg(CFG)
    pt = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, CFG),
                                    "cpu")
    cond_pre = (torch.from_numpy(cond)
                + pt["dil_b"][None, :, None, :]).contiguous()
    outs = []
    for ragged in (False, True):
        ring = tper.init_ring(pcfg, B, "cpu")
        ys = torch.full((2, B), CFG.silence_bin, dtype=torch.int32)
        gen = tper.make_persistent_generator(pcfg, B, ragged=ragged)
        for t0, n in ((0, 4), (4, T - 4)):
            args = (pt, t0, cond_pre[t0:t0 + n], torch.from_numpy(sel[t0:t0 + n]),
                    ring, ys)
            if ragged:
                y = gen(pt, torch.full((B,), t0, dtype=torch.int64), *args[2:],
                        torch.full((B,), n, dtype=torch.int32))[0]
            else:
                y = gen(*args)[0]
            outs.append((y, ring, ys))
    for a, b in zip(outs[:2], outs[2:]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ----------------------------------------------------------------------
# errors
# ----------------------------------------------------------------------

def test_serving_errors():
    ref_w = params_lib.random_reference_weights(CFG, seed=1)
    eng = port_engine(CFG, 2, ref_w)
    cond = np.zeros((4, CFG.num_layers, 2, 2 * CFG.R), np.float32)
    with pytest.raises(RuntimeError, match="begin_stream"):
        eng.feed(cond)
    with pytest.raises(RuntimeError, match="state"):
        eng.reset_utterances([0])
    with pytest.raises(ValueError, match="max_batch"):
        eng.begin_stream(3)
    eng.begin_stream(2)
    for bad in ([5, 2], [-1, 2], [1, 2, 3], [1.0, 2.0], [[1, 2]]):
        with pytest.raises(ValueError, match="lengths"):
            eng.feed(cond, lengths=np.array(bad))
    with pytest.raises(ValueError, match="sample"):
        eng.feed(cond, mode="argmax", lengths=np.array([4, 2]))
    with pytest.raises(ValueError, match="sample"):
        eng.feed(cond, mode="prng", lengths=np.array([4, 2]))
    with pytest.raises(ValueError, match="sample"):
        eng.feed(cond, mode="forced", lengths=np.array([4, 2]))
    with pytest.raises(ValueError, match="symbols"):
        eng.feed(cond, np.full((4, 2), 0.5, np.float32), mode="forced")
    with pytest.raises(ValueError, match="cond_chunk"):
        eng.feed(cond[:, :, :1])
    with pytest.raises(ValueError, match="out of range"):
        eng.reset_utterances([2])
    with pytest.raises(ValueError, match="out of range"):
        eng.reset_utterances([])
    assert list(eng._stream_t_row) == [0, 0]      # nothing above advanced
    y = eng.feed(cond, lengths=np.array([0, 0]))  # every length 0
    assert y.shape == (2, 0) and list(eng._stream_t_row) == [0, 0]
    assert eng.feed(cond[:0]).shape == (2, 0)
    y = eng.feed(cond, mode="argmax")             # aligned: lockstep argmax
    assert y.shape == (2, 4)
    snap = eng.export_state()
    with pytest.raises(ValueError, match="snapshot"):
        port_engine(CFG, 1, ref_w).import_state(snap)
    with pytest.raises(ValueError, match="stream_t_row"):
        eng.import_state({**snap, "stream_t_row": np.array([4, -1])})
    for t in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="temperature"):
            port_engine(CFG, 1, temperature=t)
        with pytest.raises(ValueError, match="temperature"):
            eng.set_temperature(t)
