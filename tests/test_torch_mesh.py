"""Batch-sharded generation of the port (`parallel/mesh.py` and
`WaveNetInfer(mesh=...)`) on meshes of CPU devices, mirroring
tests/test_parallel.py's nine cases: every shard's rows equal the
single-device run, the numpy golden model and the JAX package bit for bit
(integers), the dumps within the reference ladder (xt/skip 1e-2 with atol
3e-4, zs/za 1e-4 with atol 2e-5, p 1e-3) and the scorer's p bit for bit
against the unsharded engine.  Also: ragged feeds and speculative decode
raise under a mesh, each shard launches inside its own device (a fake that
records the runtime's current device), the shards' prng keys, and one case
against the JAX mesh engine (`data_mesh(4)`, interpret mode)."""

import contextlib

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu.ops import scan_generate as jsg
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.parallel import mesh as tmesh

from tests.test_golden_vs_scan import rel_close
from tests.test_torch_generate import port_cfg

CPU = torch.device("cpu")


def cpu_mesh(n):
    return tmesh.data_mesh(n, [CPU] * n)


def case(cfg, batch, samples, seed):
    ref_w = params_lib.random_reference_weights(cfg, seed=seed)
    rng = np.random.RandomState(seed)
    cond = rng.uniform(-0.5, 0.5, (samples, cfg.num_layers, batch, 2 * cfg.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (samples, batch)).astype(np.float32)
    return ref_w, cond, sel


def golden_y(cfg, ref_w, cond, sel):
    T, _, B, _ = cond.shape
    golden = WaveNetGolden(cfg, B, T)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    return golden, golden.run(T, B)


def engine(cfg, batch, mesh=None, **kw):
    kw.setdefault("device", None if mesh is not None else "cpu")
    return WaveNetInfer(num_layers=cfg.num_layers,
                        max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                        A=cfg.A, max_batch=batch, chunk_size=8, mesh=mesh,
                        **kw)


def test_sharded_plain_matches_single_device():
    """`sharded_generate_plain` over 8 shards against the JAX scan on one
    device: the same integers."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=8)
    B, T = 8, 12
    ref_w, cond, sel = case(cfg, B, T, 17)
    jparams = params_lib.to_canonical(ref_w, cfg)
    _, y_jax, _ = jsg.generate(jparams, jsg.init_state(cfg, B), cond, sel,
                               cfg)
    params = tparams.canonical_to_torch(jparams, "cpu")
    state, y = tmesh.sharded_generate_plain(params, port_cfg(cfg),
                                            cpu_mesh(8), cond, sel)
    assert np.array_equal(y.numpy(), np.asarray(y_jax))
    assert state.t == T and tuple(state.ring.shape) == (
        port_cfg(cfg).ring_size, B, cfg.R)


def test_sharded_generator_matches_single_device():
    """The sharded generator at 4 shards (2 rows each) against the
    single-device generator and the golden model: the integers, the carried
    ring and y_state, and forced p_seq concatenated on its batch axis."""
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    pcfg = port_cfg(cfg)
    B, T = 8, 8
    ref_w, cond, sel = case(cfg, B, T, 17)
    _, y_gold = golden_y(cfg, ref_w, cond, sel)
    params = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, cfg),
                                        "cpu")
    cond_pre = torch.from_numpy(cond) + params["dil_b"][None, :, None, :]

    def fresh(b):
        return (tper.init_ring(pcfg, b, CPU),
                torch.full((2, b), pcfg.silence_bin, dtype=torch.int32))
    ring1, ys1 = fresh(B)
    y1 = tper.make_persistent_generator(pcfg, B)(
        params, 0, cond_pre, torch.from_numpy(sel), ring1, ys1)[0]
    mesh = cpu_mesh(4)
    gen = tmesh.make_sharded_persistent_generator(pcfg, mesh, 2)
    states = [fresh(2) for _ in range(4)]
    y, rings, yss = gen(tmesh.replicate(mesh, params), 0,
                        tmesh.stage(mesh, cond_pre, 2),
                        tmesh.stage(mesh, sel, 1), [s[0] for s in states],
                        [s[1] for s in states])
    assert np.array_equal(y.numpy(), y1.numpy())
    assert np.array_equal(y.numpy().T, y_gold)
    assert torch.equal(torch.cat(rings, 1), ring1)
    assert torch.equal(torch.cat(yss, 1), ys1)
    assert gen.route.kernel == "staged" and len(gen.generators) == 1

    forced = torch.from_numpy(np.ascontiguousarray(y_gold.T, np.float32))
    p1 = tper.make_persistent_generator(pcfg, B, mode="forced")(
        params, 0, cond_pre, forced, *fresh(B))[-1]
    genf = tmesh.make_sharded_persistent_generator(pcfg, mesh, 2,
                                                   mode="forced")
    states = [fresh(2) for _ in range(4)]
    out = genf(tmesh.replicate(mesh, params), 0,
               tmesh.stage(mesh, cond_pre, 2), tmesh.stage(mesh, forced, 1),
               [s[0] for s in states], [s[1] for s in states])
    assert torch.equal(out[-1], p1)


def test_data_mesh_shapes():
    assert cpu_mesh(8).shape["data"] == 8
    m = tmesh.data_mesh(4, [CPU] * 8)
    assert m.shape["data"] == 4 and m.devices == (CPU,) * 4
    assert [s.index for s in m.shards] == [0, 1, 2, 3]
    assert m.local_devices == (CPU,) and m.process_count == 1
    with pytest.raises(ValueError, match="outside"):
        tmesh.data_mesh(3, [CPU, CPU])
    with pytest.raises(ValueError, match="index"):
        tmesh.DataMesh([torch.device("cuda")], streams=[None])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.data_mesh()
    parts = tmesh.stage(m, np.arange(24, dtype=np.float32).reshape(3, 8), 1)
    assert [tuple(p.shape) for p in parts] == [(3, 2)] * 4
    assert np.array_equal(tmesh.fetch_local(m, parts, 1),
                          np.arange(24).reshape(3, 8))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.stage(m, np.zeros((3, 6), np.float32), 1)


@pytest.mark.parametrize("impl", [Impl.AUTO, Impl.MANYBLOCK])
def test_mesh_engine_matches_golden_exactly(impl):
    """The mesh engine (4 CPU shards) through ragged run_chunks (5 + 5 + 2)
    against the golden model, PERSISTENT (K1) and MANYBLOCK (K4)."""
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    B, T = 8, 12
    ref_w, cond, sel = case(cfg, B, T, 51)
    _, y_gold = golden_y(cfg, ref_w, cond, sel)
    eng = engine(cfg, B, cpu_mesh(4), implementation=impl)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    assert np.array_equal(eng.run_chunks(5, lambda *_: None, T, B), y_gold)


def test_mesh_engine_streaming_feed():
    cfg = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4)
    B, T = 8, 10
    ref_w, cond, sel = case(cfg, B, T, 81)
    _, y_gold = golden_y(cfg, ref_w, cond, sel)
    eng = engine(cfg, B, cpu_mesh(4))
    eng.set_reference_weights(ref_w)
    eng.begin_stream(B)
    outs, off = [], 0
    for n in (4, 3, 3):
        outs.append(eng.feed(cond[off:off + n], sel[off:off + n]))
        off += n
    assert np.array_equal(np.concatenate(outs, axis=1), y_gold)


def test_mesh_engine_scoring_matches_single_device():
    """score over 8 shards: p_seq equal to the single-device scorer's bit
    for bit, and the handoff to a sharded feed exact."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4)
    B, T1, T2 = 8, 9, 7
    ref_w, cond, sel = case(cfg, B, T1 + T2, 83)

    def make(mesh):
        eng = engine(cfg, B, mesh)
        eng.set_reference_weights(ref_w)
        eng.begin_stream(B)
        return eng
    y1 = make(None).feed(cond[:T1], sel[:T1])
    single = make(None)
    p_single = single.score(cond[:T1], y1)
    y2_single = single.feed(cond[T1:], sel[T1:])
    sharded = make(cpu_mesh(8))
    p_mesh = sharded.score(cond[:T1], y1)
    assert np.array_equal(p_mesh, p_single)
    assert np.array_equal(sharded.feed(cond[T1:], sel[T1:]), y2_single)


@pytest.mark.parametrize("impl", [Impl.AUTO, Impl.MANYBLOCK])
def test_mesh_engine_dump_activations(impl):
    """The dumps concatenate on their batch axes: every getter as the
    golden model's within the reference ladder."""
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    B, T = 8, 8
    ref_w, cond, sel = case(cfg, B, T, 57)
    golden, y_gold = golden_y(cfg, ref_w, cond, sel)
    eng = engine(cfg, B, cpu_mesh(4), implementation=impl)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    assert np.array_equal(eng.run(T, B, dump_activations=True), y_gold)
    for l in range(cfg.num_layers):
        assert rel_close(golden.get_xt_out(l), eng.get_xt_out(l), 1e-2,
                         atol=3e-4)
        assert rel_close(golden.get_skip_out(l), eng.get_skip_out(l), 1e-2,
                         atol=3e-4)
    assert rel_close(golden.get_zs(), eng.get_zs(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_za(), eng.get_za(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_p(), eng.get_p(), 1e-3)
    assert np.allclose(eng.get_p().sum(-1), 1.0, atol=1e-5)


def test_mesh_engine_int8_stream_matches_single_device():
    """MANYBLOCK int8 under a mesh: the single-device int8 engine's integers
    and the JAX package's int8 oracle's (the JAX scan on the round-tripped
    weights)."""
    from nv_wavenet_tpu.utils.oracles import int8_dequant_scan_oracle
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    B, T = 8, 12
    ref_w, cond, sel = case(cfg, B, T, 61)

    def run(mesh):
        eng = engine(cfg, B, mesh, implementation=Impl.MANYBLOCK,
                     stream_quant="int8")
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        return eng.run(T, B)
    y_mesh = run(cpu_mesh(4))
    assert np.array_equal(y_mesh, run(None))
    assert np.array_equal(y_mesh, int8_dequant_scan_oracle(cfg, ref_w, cond,
                                                           sel))


def test_mesh_engine_state_export_import():
    """A sharded stream resumed from export_state in a fresh mesh engine
    equals the uninterrupted one; the snapshot is an unsharded engine's."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=64, A=256, max_dilation=4)
    B, T = 8, 12
    ref_w, cond, sel = case(cfg, B, T, 71)

    def mk(mesh=cpu_mesh(4)):
        eng = engine(cfg, B, mesh)
        eng.set_reference_weights(ref_w)
        return eng
    e0 = mk()
    e0.begin_stream(B)
    y_full = np.concatenate([e0.feed(cond[:7], sel[:7]),
                             e0.feed(cond[7:], sel[7:])], axis=1)
    e1 = mk()
    e1.begin_stream(B)
    y_a = e1.feed(cond[:7], sel[:7])
    snap = e1.export_state()
    e2 = mk()
    e2.import_state(snap)
    assert np.array_equal(np.concatenate([y_a, e2.feed(cond[7:], sel[7:])],
                                         axis=1), y_full)
    plain = mk(None)
    plain.begin_stream(B)
    plain.feed(cond[:7], sel[:7])
    ref = plain.export_state()
    assert all(np.array_equal(snap[k], ref[k]) for k in ref)


def test_mesh_raises_where_the_jax_mesh_does():
    cfg = WaveNetConfig(num_layers=4, R=32, S=64, A=256, max_dilation=4)
    B, T = 8, 8
    ref_w, cond, sel = case(cfg, B, T, 3)
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        engine(cfg, B, tmesh.data_mesh(3, [CPU] * 3))
    eng = engine(cfg, B, cpu_mesh(4))
    eng.set_reference_weights(ref_w)
    with pytest.raises(ValueError, match="pad the utterance batch"):
        eng.begin_stream(6)
    with pytest.raises(ValueError, match="pad the utterance batch"):
        eng.set_inputs(cond[:, :, :6], sel[:, :6])
    eng.set_inputs(cond, sel)
    with pytest.raises(ValueError, match="differs from"):
        eng.run(T, 4)
    with pytest.raises(ValueError, match="speculative decode: single-process"):
        eng.run_speculative(T, B)
    eng.begin_stream(B)
    with pytest.raises(ValueError, match="ragged feeds: single-process"):
        eng.feed(cond[:4], sel[:4], lengths=[4, 3, 4, 4, 4, 4, 4, 4])
    with pytest.raises(ValueError, match="mesh's first device"):
        engine(cfg, B, cpu_mesh(4), device="cuda:0")


def test_each_shard_launches_inside_its_own_device(monkeypatch):
    """The kernels configure and launch on the runtime's current device, so
    every shard's launch must run inside torch.cuda.device(its device) and
    on its own stream, all queued before any result is gathered.  A fake
    runtime records the current device and stream at each launch of a mesh
    over cuda:0, cuda:1, cuda:1."""
    current = {"device": None, "stream": None}
    events = []

    class FakeStream:
        def __init__(self, name):
            self.name = name

        def wait_stream(self, other):
            events.append(("wait", self.name, other.name))

    @contextlib.contextmanager
    def fake_device(dev):
        old, current["device"] = current["device"], torch.device(dev).index
        yield
        current["device"] = old

    @contextlib.contextmanager
    def fake_stream(stream):
        old, current["stream"] = current["stream"], stream.name
        yield
        current["stream"] = old

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "stream", fake_stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream(f"default{dev.index}"))
    devs = [torch.device("cuda", i) for i in (0, 1, 1)]
    mesh = tmesh.DataMesh(devs, streams=[FakeStream(f"s{k}")
                                         for k in range(3)])

    def fake_generator(cfg, batch, **kw):
        def generate(params, t0, c, s, ring, ys, n_valid=None, seed=0):
            events.append(("launch", current["device"], current["stream"],
                           params, seed))
            return c[0, 0, :, :1].T.to(torch.int32), ring, ys

        def prepare(params, dev):
            events.append(("prepare", current["device"], dev.index))
        generate.prepare, generate.route = prepare, None
        return generate
    monkeypatch.setattr(tmesh.persistent, "make_persistent_generator",
                        fake_generator)
    cfg = port_cfg(WaveNetConfig(num_layers=2, R=4, S=8, A=8,
                                 max_dilation=2))
    gen = tmesh.make_sharded_persistent_generator(cfg, mesh, 1)
    cond = [torch.full((1, 2, 1, 8), float(k)) for k in range(3)]
    y = gen({d: f"params{d.index}" for d in devs}, 0, cond, [None] * 3,
            [None] * 3, [None] * 3, seed=5)[0]
    assert y.tolist() == [[0, 1, 2]]
    assert [e for e in events if e[0] == "prepare"] == [
        ("prepare", 0, 0), ("prepare", 1, 1)]
    launches = [e for e in events if e[0] == "launch"]
    assert launches == [("launch", k, f"s{i}", f"params{k}",
                         tmesh.shard_key(5, i))
                        for i, k in enumerate((0, 1, 1))]
    order = [e[:2] for e in events if e[0] in ("launch", "wait")]
    # each shard's stream waits for its device's stream, launches, and only
    # then do the devices' streams wait for the shards'
    assert order == [("wait", "s0"), ("launch", 0), ("wait", "s1"),
                     ("launch", 1), ("wait", "s2"), ("launch", 1),
                     ("wait", "default0"), ("wait", "default1"),
                     ("wait", "default1")]


def test_shard_prng_keys():
    """Mode prng under a mesh: shard k's rows equal an unsharded engine of
    its rows seeded with `shard_key(seed, k)`; the shards' draws differ;
    the keys of one seed are distinct and shard 0 keeps the seed."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=64, A=256, max_dilation=4)
    B, T = 8, 10
    ref_w, cond, sel = case(cfg, B, T, 9)
    eng = engine(cfg, B, cpu_mesh(4))
    eng.set_reference_weights(ref_w)
    eng.sampling_seed = 1234
    eng.set_inputs(cond, sel)
    y = eng.run(T, B, mode="prng")
    for k in range(4):
        one = engine(cfg, 2)
        one.set_reference_weights(ref_w)
        one.sampling_seed = tmesh.shard_key(1234, k)
        one.set_inputs(cond[:, :, 2 * k:2 * k + 2], sel[:, 2 * k:2 * k + 2])
        assert np.array_equal(one.run(T, 2, mode="prng"), y[2 * k:2 * k + 2])
    # the same conditioning on every row: only the keys tell shards apart
    same = np.repeat(cond[:, :, :1], B, axis=2)
    eng.set_inputs(same, sel)
    y_same = eng.run(T, B, mode="prng")
    assert not np.array_equal(y_same[0], y_same[2])
    keys = {tmesh.shard_key(7, k) for k in range(1024)}
    assert len(keys) == 1024 and tmesh.shard_key(7, 0) == 7
    assert tmesh.shard_key(2 ** 64 - 1, 1) == (
        tmesh.SHARD_KEY_STEP - 1) % 2 ** 64


def test_mesh_engine_matches_the_jax_mesh_engine():
    """The port's mesh engine against the JAX package's (`data_mesh(4)` of
    virtual CPU devices, the Pallas kernel in interpret mode) with the
    default selector stream: a run, then a stream with feeds around a
    `reset_utterances` of two rows (which keeps their clock under a mesh,
    as the JAX engine does): 0 integer mismatches."""
    from nv_wavenet_tpu.engine.wavenet_infer import WaveNetInfer as JaxInfer
    from nv_wavenet_tpu.parallel import mesh as jmesh
    cfg = WaveNetConfig(num_layers=4, R=32, S=64, A=256, max_dilation=4)
    B, T = 8, 8
    ref_w, cond, _ = case(cfg, B, 2 * T, 33)

    def drive(eng):
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond[:T])
        y = eng.run(T, B)
        eng.begin_stream(B)
        y1 = eng.feed(cond[:5])
        eng.reset_utterances([1, 6])
        return y, np.concatenate([y1, eng.feed(cond[5:])], axis=1)
    jax_eng = JaxInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=8, interpret=True,
                       mesh=jmesh.data_mesh(4))
    y_jax, s_jax = drive(jax_eng)
    y_port, s_port = drive(engine(cfg, B, cpu_mesh(4)))
    assert int((y_port != y_jax).sum()) == 0
    assert int((s_port != s_jax).sum()) == 0
