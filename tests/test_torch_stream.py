"""The port's weight-streaming path (kernel K4's plain version, the storage
helpers, `Impl.MANYBLOCK` and the `weight_dtype`/`stream_*` knobs) on the
CPU, against the JAX package: its quantizer, its streaming kernel in
interpret mode (tests/test_streaming_kernel.py::run_stream), its engine,
its int8 oracle and the golden model.  Integers exact; the FIFO ring within
the xt ladder (1e-2, atol 3e-4); distributions under int8 within the TV
bounds of tests/test_streaming_kernel.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu.ops import persistent as jper
from nv_wavenet_tpu.utils import oracles as joracles
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import score_parallel as tsp
from nv_wavenet_tpu_torch.utils import oracles as toracles

from tests.test_golden_vs_scan import make_case, rel_close
from tests.test_low_precision import hot_case, tv
from tests.test_streaming_kernel import CONFIGS, run_stream
from tests.test_torch_persistent import port_cfg, unpack_ring

CFG = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
STORAGE_KW = {"fp32": {}, "bf16": {"weight_dtype": torch.bfloat16},
              "int8": {"stream_quant": True}}


def torch_params(params):
    return tparams.canonical_to_torch(
        {k: np.asarray(v, np.float32) for k, v in params.items()}, "cpu")


def port_stream(cfg, params, cond, sel, batch, t0=0, state=None, **kw):
    """The port's generator with stream_weights=True on the CPU (plain K4),
    cond_pre folded from the storage's dil_b; returns y [B, T], ring,
    y_state (the state, updated in place, is `state` when given)."""
    pcfg = port_cfg(cfg)
    tp = torch_params(params)
    view = tper.value_view(tp, kw.get("weight_dtype", torch.float32),
                           kw.get("stream_quant", False))
    if state is None:
        state = (tper.init_ring(pcfg, batch, "cpu"),
                 torch.full((2, batch), pcfg.silence_bin, dtype=torch.int32))
    gen = tper.make_persistent_generator(pcfg, batch, stream_weights=True,
                                         **kw)
    cond_pre = (torch.from_numpy(np.asarray(cond))
                + view["dil_b"][None, :, None, :]).contiguous()
    out = gen(tp, t0, cond_pre, torch.from_numpy(np.asarray(sel)), *state)
    return out[0].numpy().T, out[1], out[2]


def port_engine(cfg, batch, ref_w, impl=Impl.MANYBLOCK, **kw):
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=batch, implementation=impl,
                       chunk_size=8, device="cpu", **kw)
    eng.set_reference_weights(ref_w)
    return eng


# ----------------------------------------------------------------------
# storage helpers
# ----------------------------------------------------------------------

def test_quantize_dequantize_and_bf16_view_bit_equal_jax():
    ref_w, _, _ = make_case(CFG, 1, 1, seed=3)
    params = params_lib.to_canonical(ref_w, CFG)
    params["dil_w"][2, :, 5] = 0.0          # a zero column: s = 1
    params["rs_w"][1, :, 7] = 0.0
    jq = jper.quantize_stream_weights({k: jnp.asarray(v)
                                       for k, v in params.items()})
    tq = tper.quantize_stream_weights(torch_params(params))
    for j, t in zip(jq, tq):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        assert np.array_equal(j.view(np.uint8), t.numpy().view(np.uint8))
    assert float(tq[1][2, 5]) == 1.0 and float(tq[3][1, 7]) == 1.0
    jd = jper.dequantize_stream_params({k: jnp.asarray(v)
                                        for k, v in params.items()})
    td = tper.dequantize_stream_params(torch_params(params))
    views = (tper.value_view(torch_params(params), stream_quant=True),
             tper.value_view(torch_params(params), torch.bfloat16))
    for k in tparams.PARAM_ORDER:
        assert np.array_equal(np.asarray(jd[k]).view(np.int32),
                              td[k].numpy().view(np.int32)), k
        assert torch.equal(views[0][k], td[k]), k
        bf = np.asarray(jnp.asarray(params[k], jnp.bfloat16)
                        .astype(jnp.float32))
        assert np.array_equal(bf.view(np.int32),
                              views[1][k].numpy().view(np.int32)), k
    # the int8 stacks change; fp32 leaves the params as they are
    assert not torch.equal(td["dil_w"], torch_params(params)["dil_w"])
    fp = torch_params(params)
    assert tper.value_view(fp) is fp


@pytest.mark.parametrize("cfg,batch,samples,chunk", CONFIGS)
def test_plain_stream_matches_jax_streaming_kernel(cfg, batch, samples, chunk):
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=53)
    params = params_lib.to_canonical(ref_w, cfg)
    y_j, ring_j, ys_j = run_stream(
        cfg, {k: jnp.asarray(v) for k, v in params.items()}, cond, sel,
        batch, chunk)
    launches = tper.STREAM_KERNELS["exact"].launches
    y, ring, ys = port_stream(cfg, params, cond, sel, batch)
    assert tper.STREAM_KERNELS["exact"].launches == launches   # CPU: no kernel
    assert np.array_equal(y_j, y)
    assert np.array_equal(np.asarray(ys_j), ys.numpy())
    assert rel_close(unpack_ring(cfg, ring_j), ring.numpy(), 1e-2, atol=3e-4)


@pytest.mark.parametrize("storage", ["int8", "bf16"])
def test_low_bit_storage_matches_jax_streaming_kernel(storage):
    """On hot weights: int8 against the JAX int8 streaming kernel, bf16
    against the JAX bf16 one."""
    B, T = 2, 16
    params, cond, sel, _ = hot_case(CFG, B, T, seed=19)
    params = {k: np.array(v) for k, v in params.items()}
    jkw = ({"stream_quant": True} if storage == "int8"
           else {"weight_dtype": jnp.bfloat16})
    y_j, ring_j, ys_j = run_stream(
        CFG, {k: jnp.asarray(v) for k, v in params.items()}, cond, sel, B, 8,
        **jkw)
    y, ring, ys = port_stream(CFG, params, cond, sel, B,
                              **STORAGE_KW[storage])
    assert np.array_equal(y_j, y)
    assert np.array_equal(np.asarray(ys_j), ys.numpy())
    assert rel_close(unpack_ring(CFG, ring_j), ring.numpy(), 1e-2, atol=3e-4)
    _, ring32, _ = port_stream(CFG, params, cond, sel, B)
    assert not torch.equal(ring32, ring)     # the storage is a real change


@pytest.mark.parametrize("gs,prefetch", [(1, False), (3, False), (8, True),
                                         (4, True)])
def test_stream_schedule_is_plumbing(gs, prefetch):
    """stream_group_size and stream_prefetch change no value: an 11 + 8
    split under every schedule equals the golden model (the JAX variants'
    test), and the CPU launches no kernel."""
    B = 2
    ref_w, cond, sel = make_case(CFG, B, 19, seed=73)
    golden = WaveNetGolden(CFG, max_batch=B, max_samples=19)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    y_gold = golden.run(19, B)
    params = params_lib.to_canonical(ref_w, CFG)
    kw = dict(stream_group_size=gs, stream_prefetch=prefetch)
    launches = tper.STREAM_KERNELS["exact"].launches
    y1, ring, ys = port_stream(CFG, params, cond[:11], sel[:11], B, **kw)
    y2, _, _ = port_stream(CFG, params, cond[11:], sel[11:], B, t0=11,
                           state=(ring, ys), **kw)
    assert np.array_equal(y_gold, np.concatenate([y1, y2], axis=1))
    assert tper.STREAM_KERNELS["exact"].launches == launches


# ----------------------------------------------------------------------
# K4's shared-memory plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg,batch", [
    (WaveNetConfig(num_layers=20, R=64, S=256, A=256, max_dilation=512), 16),
    (WaveNetConfig(num_layers=40, R=128, S=256, A=256, max_dilation=128), 64),
    (WaveNetConfig(num_layers=4, R=32, S=128, A=1024, max_dilation=4), 200)])
def test_stream_plan_fits_and_maps_group_size_to_lookahead(cfg, batch):
    pcfg = port_cfg(cfg)
    for storage in (torch.float32, torch.bfloat16, torch.int8):
        eb = torch.empty((), dtype=storage).element_size()
        plans = {g: tper.stream_plan(pcfg, batch, storage, g)
                 for g in (1, 2, 3, 8, 100)}
        for g, p in plans.items():
            R, S, A = cfg.R, cfg.S, cfg.A
            assert cfg.R % p.rows_per_stage == 0
            assert p.stage_bytes % 128 == 0
            assert p.stage_bytes >= max(4 * R, R + S) * p.rows_per_stage * eb
            assert 2 <= p.stages
            assert (p.smem_bytes >= p.stages * p.stage_bytes
                    + (7 * R + S + 4 * A) * 4)
            assert p.smem_bytes + 1024 <= tper.SMEM_PER_BLOCK
            per_layer = 2 * R // p.rows_per_stage
            assert p.group_layers == min(g, cfg.num_layers)
            assert p.clamped == (p.stages < p.group_layers * per_layer + 1)
            assert p.lookahead_layers == (p.stages - 1) / per_layer
            assert p.waves == -(-batch // 132)
            # one more stage would not fit when the plan was clamped
            if p.clamped:
                assert ((p.stages + 1) * (p.stage_bytes + 8) + 16
                        + (7 * R + S + 4 * A) * 4 + 1024
                        > tper.SMEM_PER_BLOCK)
        stages = [plans[g].stages for g in (1, 2, 3, 8, 100)]
        assert stages == sorted(stages)          # G sets the lookahead
    # two fp32 flagship layers do not fit: one stage is the whole of
    # Wprev + Wcur or of rs_w, two of them
    p = tper.stream_plan(port_cfg(CONFIGS[0][0]), 1, torch.float32)
    assert p.stages >= 2


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def test_engine_manyblock_streams_and_matches_golden(monkeypatch):
    """`Impl.MANYBLOCK` builds streaming generators and equals the golden
    model through ragged run_chunks (the JAX engine's test)."""
    B, T = 2, 15
    ref_w, cond, sel = make_case(CFG, B, T, seed=71)
    golden = WaveNetGolden(CFG, max_batch=B, max_samples=T)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    y_gold = golden.run(T, B)
    built = []
    make = tper.make_persistent_generator
    monkeypatch.setattr(tper, "make_persistent_generator",
                        lambda *a, **kw: built.append(kw) or make(*a, **kw))
    eng = port_engine(CFG, B, ref_w)
    eng.set_inputs(cond, sel)
    kernels = (tper.STREAM_KERNELS["exact"], tper.PERSISTENT_KERNELS["exact"])
    launches = [k.launches for k in kernels]
    y = eng.run_chunks(7, lambda yc, off, n: None, T, B)
    assert np.array_equal(y_gold, y)
    assert built and all(kw["stream_weights"] for kw in built)
    assert launches == [k.launches for k in kernels]
    for mode in ("argmax", "prng"):
        y_m = eng.run(T, B, mode=mode)
        ref = port_engine(CFG, B, ref_w, impl=Impl.PERSISTENT)
        ref.set_inputs(cond, sel)
        assert np.array_equal(y_m, ref.run(T, B, mode=mode)), mode


def test_engine_stream_quant_int8_matches_oracles():
    """WaveNetInfer(stream_quant='int8') under MANYBLOCK equals the port's
    int8 oracle and the JAX package's, and only under MANYBLOCK does int8
    take effect (the JAX engine's rule)."""
    B, T = 2, 24
    _, cond, sel, ref_w = hot_case(CFG, B, T, seed=83)
    eng = port_engine(CFG, B, ref_w, stream_quant="int8")
    eng.set_inputs(cond, sel)
    y = eng.run(T, B)
    y_port = toracles.int8_dequant_scan_oracle(port_cfg(CFG), ref_w, cond,
                                               sel)
    assert np.array_equal(y, y_port)
    assert np.array_equal(y, joracles.int8_dequant_scan_oracle(CFG, ref_w,
                                                               cond, sel))
    res = port_engine(CFG, B, ref_w, impl=Impl.PERSISTENT,
                      stream_quant="int8")
    fp = port_engine(CFG, B, ref_w, impl=Impl.PERSISTENT)
    for e in (res, fp):
        e.set_inputs(cond, sel)
    assert np.array_equal(res.run(T, B), fp.run(T, B))
    rings = [e.export_state()["ring"] for e in (res, fp, eng)]
    assert np.array_equal(rings[0], rings[1])
    assert not np.array_equal(rings[2], rings[1])   # int8 changed values


@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_engine_bf16_weights_match_jax_engine(temperature):
    """weight_dtype=bfloat16, with and without a temperature: the port's
    MANYBLOCK and PERSISTENT engines equal the JAX engine's bf16 kernel
    (interpret mode) in every integer; temperature is applied before the
    bf16 rounding, as there."""
    B, T = 2, 16
    _, cond, sel, ref_w = hot_case(CFG, B, T, seed=29)
    jeng = jinfer.WaveNetInfer(num_layers=CFG.num_layers,
                               max_dilation=CFG.max_dilation, R=CFG.R,
                               S=CFG.S, A=CFG.A, max_batch=B,
                               implementation=jinfer.Impl.PERSISTENT,
                               chunk_size=8, weight_dtype=jnp.bfloat16,
                               temperature=temperature, interpret=True)
    jeng.set_reference_weights(ref_w)
    jeng.set_inputs(cond, sel)
    y_j = jeng.run(T, B)
    ys = {}
    for impl in (Impl.MANYBLOCK, Impl.PERSISTENT):
        eng = port_engine(CFG, B, ref_w, impl=impl,
                          weight_dtype=torch.bfloat16,
                          temperature=temperature)
        eng.set_inputs(cond, sel)
        ys[impl] = eng.run(T, B)
        assert np.array_equal(y_j, ys[impl]), impl
    fp = port_engine(CFG, B, ref_w, temperature=temperature)
    fp.set_inputs(cond, sel)
    fp.run(T, B)
    assert not np.array_equal(fp.export_state()["ring"],
                              eng.export_state()["ring"])


def test_int8_stream_distribution_close_to_fp32():
    """The int8 TV bound of tests/test_streaming_kernel.py on the port's
    forced mode: the plain K4 under int8 driven through the fp32 free run's
    symbols, against the fp32 forced distributions."""
    B, T = 4, 64
    params, cond, sel, _ = hot_case(CFG, B, T, seed=7)
    params = torch_params({k: np.array(v) for k, v in params.items()})
    pcfg = port_cfg(CFG)

    def forced_p(sym, **kw):
        view = tper.value_view(params, stream_quant=kw.get("stream_quant",
                                                           False))
        gen = tper.make_persistent_generator(pcfg, B, mode="forced",
                                             stream_weights=True, **kw)
        cond_pre = (torch.from_numpy(cond)
                    + view["dil_b"][None, :, None, :]).contiguous()
        ring = tper.init_ring(pcfg, B, "cpu")
        ys = torch.full((2, B), pcfg.silence_bin, dtype=torch.int32)
        out = gen(params, 0, cond_pre, sym, ring, ys)
        assert torch.equal(out[0], sym.to(torch.int32))
        p = out[-1].double().numpy()
        return p / p.sum(-1, keepdims=True)

    free = tper.make_persistent_generator(pcfg, B, stream_weights=True)
    ring = tper.init_ring(pcfg, B, "cpu")
    ys = torch.full((2, B), pcfg.silence_bin, dtype=torch.int32)
    y = free(params, 0, (torch.from_numpy(cond)
                         + params["dil_b"][None, :, None, :]).contiguous(),
             torch.from_numpy(sel), ring, ys)[0]
    sym = y.to(torch.float32)
    t = tv(forced_p(sym), forced_p(sym, stream_quant=True))
    msg = f"int8 mean TV {t.mean():.4f} max {t.max():.4f}"
    assert t.mean() < 0.05 and t.max() < 0.4, msg
    assert t.max() > 0, msg


def test_score_then_feed_under_int8_is_exact_r9():
    """Fault R9 of the JAX engine (ROADMAP.md): its scorer keeps the fp32
    stacks on an int8 MANYBLOCK engine, so the state a score leaves is not
    the one the int8 generator would have left.  The port scores with the
    int8 values: the FIFO ring after scoring a window equals the ring after
    generating it, up to the summation order of the CPU's products (2.4e-7
    here; the fp32 stacks leave it 5e-3 away), and a feed after the score
    continues one int8 generation over the whole window sample for
    sample.  Hot weights."""
    B, T1, T2 = 4, 32, 96
    _, cond, sel, ref_w = hot_case(CFG, B, T1 + T2, seed=91)
    eng = port_engine(CFG, B, ref_w, stream_quant="int8")
    eng.begin_stream(B)
    y_head = eng.feed(cond[:T1], sel[:T1])
    ring_gen = eng.export_state()["ring"]
    y_tail = eng.feed(cond[T1:], sel[T1:])
    eng.begin_stream(B)
    eng.score(cond[:T1], y_head)
    assert list(eng._stream_t_row) == [T1] * B
    assert np.abs(eng.export_state()["ring"] - ring_gen).max() < 1e-5
    assert np.array_equal(eng.feed(cond[T1:], sel[T1:]), y_tail)


def test_stream_argument_checks():
    pcfg = port_cfg(CFG)
    make = tper.make_persistent_generator
    with pytest.raises(ValueError, match="stream_quant"):
        make(pcfg, 1, stream_weights=True, stream_quant=True,
             weight_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ragged"):
        make(pcfg, 1, ragged=True, stream_weights=True)
    with pytest.raises(ValueError, match="weight_dtype"):
        make(pcfg, 1, weight_dtype=torch.float16)
    with pytest.raises(ValueError, match="stream_group_size"):
        make(pcfg, 1, stream_weights=True, stream_group_size=0)
    # past 1024 output columns (fault F3, closed): the first K4's general
    # instance
    big = port_cfg(WaveNetConfig(num_layers=2, R=512, S=256, A=256,
                                 max_dilation=2))
    route = make(big, 1, stream_weights=True).route
    assert route.kernel == "stream" and route.plan.general
    wide = port_cfg(WaveNetConfig(num_layers=2, R=32, S=128, A=16384,
                                  max_dilation=2))
    with pytest.raises(ValueError, match="two stages"):
        tper.stream_plan(wide, 1, torch.float32)
    # rows that are not whole 16-byte units: padded (F3)
    odd = port_cfg(WaveNetConfig(num_layers=2, R=36, S=100, A=256,
                                 max_dilation=2))
    plan = tper.stream_plan(odd, 1, torch.int8)
    assert plan.general and (plan.dil_stride, plan.rs_stride) == (80, 144)

    kw = dict(num_layers=6, max_dilation=4, R=32, S=128, A=256, max_batch=2,
              device="cpu")
    with pytest.raises(ValueError, match="stream_quant"):
        WaveNetInfer(stream_quant="int4", **kw)
    with pytest.raises(ValueError, match="stream_quant"):
        WaveNetInfer(stream_quant="int8", weight_dtype=torch.bfloat16, **kw)
    WaveNetInfer(**{**kw, "R": 512}, implementation=Impl.MANYBLOCK)   # F3
    ref_w, cond, sel = make_case(CFG, 2, 8, seed=5)
    eng = port_engine(CFG, 2, ref_w)
    eng.begin_stream(2)
    with pytest.raises(ValueError, match="MANYBLOCK"):
        eng.feed(cond, sel, lengths=[8, 3])
    eng.feed(cond[:4], sel[:4])
    eng.reset_utterances([0])                  # desynced row clocks
    with pytest.raises(ValueError, match="MANYBLOCK"):
        eng.feed(cond[:4], sel[:4])


def test_score_uses_the_storage_values():
    """score_device hands the scorer the storage's values: under int8 the
    dequantized stacks, under bf16 the rounded parameters."""
    B, T = 2, 6
    _, cond, sel, ref_w = hot_case(CFG, B, T, seed=5)
    y = np.random.RandomState(0).randint(0, 256, (B, T))
    for kw, view_kw in ((dict(stream_quant="int8"), dict(stream_quant=True)),
                        (dict(weight_dtype=torch.bfloat16),
                         dict(weight_dtype=torch.bfloat16))):
        eng = port_engine(CFG, B, ref_w, **kw)
        eng.begin_stream(B)
        p = eng.score(cond, y)
        view = tper.value_view(eng._device_params(), **view_kw)
        score = tsp.make_parallel_scorer(port_cfg(CFG), B)
        ring = tper.init_ring(port_cfg(CFG), B, "cpu")
        ys = torch.full((2, B), 128, dtype=torch.int32)
        p_ref = score(view, 0, torch.from_numpy(cond),
                      torch.from_numpy(y.T.copy()), ring, ys)[0]
        np.testing.assert_allclose(p, p_ref.permute(1, 0, 2).numpy(),
                                   atol=1e-6, rtol=0)
