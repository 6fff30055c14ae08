"""The port's collapsed-chain tier on the CPU (`ops/fused_chain.py`: the
fold and the plain version of kernel K6; the engine's `fuse_chain`,
`fuse_pack`, `fast_math` and `priority`) against the JAX package: its fold,
its fused kernel and its engine in interpret mode, its scan generator.

The case is the hot case of tests/test_low_precision.py (6 layers, R=32,
S=128, A=256, max_dilation 8; B=8, T=64; trained-scale weights, p_max
~0.85), as tests/test_fused_chain.py uses it.  Tolerances and why:
  * the fold: 1e-6 absolute per element; the port and XLA sum the same
    products of O(0.1) values in another order (~1e-8 apart);
  * port vs JAX fused kernel: forced p within 2e-5, the ring within 1e-4 of
    the unpacked JAX ring: both compute the same fold in fp32 and differ
    only in the summation order of their products (~1e-7 relative);
    sampled and argmax symbols agree on >= 99% (the JAX bar for fused vs
    exact, tests/test_fused_chain.py:65-90; measured here: all);
  * the TV contract against the exact path (tests/test_fused_chain.py
    :55-62, tests/test_low_precision.py:168-178): fp32 fused max TV < 5e-4;
    bf16 weights mean < 0.02, max < 0.15; fast_math mean < 0.025, p99 <
    0.10, max < 0.20, and TV > 0 against fp32 fused (fast_math really
    rounds: JAX on the CPU computes DEFAULT as fp32, so only the port's
    test sees it);
  * chunking, prng, the handoff to the exact generator, the engine's
    routing, its fast_math dispatches off K6 against the plain "fast"
    generator and its fallback where K6 cannot run: exact (same
    computation in the same order).
The cluster K6 (csrc/fused_chain.cu, a card-only kernel): its plan and route
for the flagship, config 4 and every geometry these tests use, the first
K6 where the cluster plan raises, its stream's column slices, and its plain
model of the sums (`fused_chain.cluster_model`), held to the plain K6 and
the JAX interpret kernel (forced p within 2e-5, symbols >= 99%), to the TV
contract, and to itself across a split and pack_gates bit for bit; a
stream with one G block zeroed must break the fp32 TV bound.
The JAX interpret-mode runs are made once, in the module fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.ops import fused_chain as jfc
from nv_wavenet_tpu.ops import persistent as jper
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import fused_chain as tfc
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg

from tests.test_low_precision import (CFG, free_run_forced, hot_case,
                                      scan_forced_probs, tv)
from tests.test_torch_persistent import port_cfg, unpack_ring

B, T, SPLIT = 8, 64, 24
PCFG = port_cfg(CFG)
PRNG_SEED = 5


def jax_engine(params, cond, sel):
    eng = jinfer.WaveNetInfer(
        num_layers=CFG.num_layers, max_dilation=CFG.max_dilation, R=CFG.R,
        S=CFG.S, A=CFG.A, max_batch=B, implementation=jinfer.Impl.PERSISTENT,
        chunk_size=8, fuse_chain=True)
    eng.set_canonical_params({k: np.asarray(v) for k, v in params.items()})
    eng.set_inputs(cond, sel)
    return eng


@pytest.fixture(scope="module")
def case():
    """The hot case, its fp32 trajectory and distributions (JAX scan), the
    JAX fused kernel in interpret mode in every mode, and the JAX engine's
    fused run and fused -> exact handoff."""
    params, cond, sel, ref_w = hot_case(CFG, B, T, seed=7)
    forced = np.ascontiguousarray(free_run_forced(CFG, params, cond, sel))
    p32 = scan_forced_probs(CFG, params, cond, sel, forced, jnp.float32)[:T]
    jax_runs = {}
    for mode in ("sample", "argmax", "forced"):
        gen = jfc.make_fused_generator(CFG, B, 8, mode=mode, interpret=True)
        s_in = forced.astype(np.float32) if mode == "forced" else sel
        out = gen(params, np.array([0]), jnp.asarray(cond), jnp.asarray(s_in),
                  jper.init_ring(CFG, B),
                  jnp.full((2, B), CFG.silence_bin, jnp.int32), n_valid=T)
        jax_runs[mode] = [np.asarray(o) for o in out]
    eng = jax_engine(params, cond, sel)
    y_eng = eng.run(T, B)
    y_handoff = np.concatenate(
        [eng.run_partial(0, SPLIT, B),
         eng.run_partial(SPLIT, T - SPLIT, B, dump_activations=True)], 1)
    tp = tparams.canonical_to_torch(
        {k: np.asarray(v, np.float32) for k, v in params.items()}, "cpu")
    return dict(params=params, tp=tp, ref_w=ref_w, cond=cond, sel=sel,
                forced=forced, p32=p32, jax=jax_runs, y_eng=y_eng,
                y_handoff=y_handoff)


def fresh(batch=B):
    return (tper.init_ring(PCFG, batch, "cpu"),
            torch.full((2, batch), PCFG.silence_bin, dtype=torch.int32))


def port_fused(c, mode="sample", sel=None, state=None, t0=0, n=None,
               **kw):
    """The port's fused generator on the CPU over raw cond (fbias carries
    dil_b, as the JAX kernel's default); returns its outputs."""
    gen = tfc.make_fused_generator(PCFG, B, mode=mode, **kw)
    s_in = c["sel"] if sel is None else sel
    sl = slice(t0, T if n is None else t0 + n)
    state = fresh() if state is None else state
    return gen(c["tp"], t0, torch.from_numpy(c["cond"][sl]),
               torch.from_numpy(np.ascontiguousarray(s_in[sl])), *state,
               seed=PRNG_SEED)


def forced_probs(out) -> np.ndarray:
    p = out[-1].numpy().astype(np.float64)
    return p / p.sum(-1, keepdims=True)


def port_engine(c, **kw):
    eng = WaveNetInfer(num_layers=CFG.num_layers,
                       max_dilation=CFG.max_dilation, R=CFG.R, S=CFG.S,
                       A=CFG.A, max_batch=B, chunk_size=8, device="cpu", **kw)
    eng.set_reference_weights(c["ref_w"])
    eng.set_inputs(c["cond"], c["sel"])
    return eng


# ----------------------------------------------------------------------
# the fold and the plain K6 against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("prefold", [False, True])
def test_prepare_weights_match_jax_fold(case, pack, prefold):
    j = jfc.prepare_weights(case["params"], CFG, prefold, jnp.float32, pack)
    t = tfc.prepare_weights(case["tp"], PCFG, prefold, torch.float32, pack)
    shapes = tfc.folded_shapes(PCFG, pack)
    for k, a, b in zip(tfc.FOLDED_ORDER, j, t):
        assert tuple(b.shape) == shapes[k] == a.shape, k
        assert b.is_contiguous() and b.dtype == torch.float32, k
        err = float(np.abs(np.asarray(a) - b.numpy()).max())
        assert err < 1e-6, f"{k}: max abs err {err:.3g}"


@pytest.mark.parametrize("mode", ["forced", "sample", "argmax"])
def test_plain_matches_jax_interpret_kernel(case, mode):
    j_y, j_ring, j_ys = case["jax"][mode][:3]
    s_in = case["forced"].astype(np.float32) if mode == "forced" else None
    launches = sum(k.launches for k in tfc.FUSED_KERNELS.values())
    out = port_fused(case, mode, sel=s_in)
    assert sum(k.launches for k in tfc.FUSED_KERNELS.values()) == launches
    y = out[0].numpy()
    agree = float(np.mean(y == j_y))
    assert agree >= 0.99, f"{mode}: agreement {agree:.4f}"
    assert np.array_equal(out[2].numpy(), j_ys)
    ring_err = float(np.abs(unpack_ring(CFG, j_ring) - out[1].numpy()).max())
    assert ring_err < 1e-4, f"{mode}: ring max abs err {ring_err:.3g}"
    if mode == "forced":
        assert np.array_equal(y, case["forced"])
        p_err = float(np.abs(case["jax"]["forced"][3] - out[3].numpy()).max())
        assert p_err < 2e-5, f"p max abs err {p_err:.3g}"


def test_fp32_fused_within_tv_of_port_exact_path(case):
    """The fold's reassociation only: fused p against the port's exact
    forced generator (plain K2) on the same symbols."""
    cond_pre = (torch.from_numpy(case["cond"])
                + case["tp"]["dil_b"][None, :, None, :]).contiguous()
    sym = torch.from_numpy(case["forced"].astype(np.float32))
    exact = tper.make_persistent_generator(PCFG, B, mode="forced")(
        case["tp"], 0, cond_pre, sym, *fresh())
    p_exact = forced_probs(exact)
    p_fused = forced_probs(port_fused(case, "forced", sel=case["forced"]
                                      .astype(np.float32)))
    t = tv(p_exact, p_fused)
    assert t.max() < 5e-4, f"max TV {t.max():.2e}"
    assert np.abs(p_exact - p_fused).max() < 5e-4


@pytest.mark.parametrize("kw,bounds", [
    (dict(weight_dtype=torch.bfloat16), (0.02, None, 0.15)),
    (dict(fast_math=True), (0.025, 0.10, 0.20)),
    (dict(fast_math=True, pack_gates=True), (0.025, 0.10, 0.20)),
], ids=["bf16_weights", "fast_math", "fast_math_packed"])
def test_low_precision_tiers_meet_the_tv_contract(case, kw, bounds):
    """Against the fp32 exact path (JAX scan) on the teacher-forced
    trajectory; the positive control: each tier's p differs from fp32
    fused, so the rounding is really applied."""
    sym = case["forced"].astype(np.float32)
    p = forced_probs(port_fused(case, "forced", sel=sym, **kw))
    t = tv(case["p32"], p)
    mean_b, p99_b, max_b = bounds
    msg = (f"{kw}: mean TV {t.mean():.5f} p99 {np.percentile(t, 99):.5f} "
           f"max {t.max():.5f}")
    assert t.mean() < mean_b and t.max() < max_b, msg
    assert p99_b is None or np.percentile(t, 99) < p99_b, msg
    p_fp32 = forced_probs(port_fused(case, "forced", sel=sym))
    assert tv(p_fp32, p).max() > 0, "the low-precision tier changed nothing"


@pytest.mark.parametrize("fast", [False, True])
def test_prng_equals_sample_fed_philox(case, fast):
    sel = tsg.prng_uniform_sel(PRNG_SEED, np.arange(T), B)
    a, b = fresh(), fresh()
    y_p = port_fused(case, "prng", state=a, fast_math=fast)[0]
    y_s = port_fused(case, "sample", sel=sel, state=b, fast_math=fast)[0]
    assert torch.equal(y_p, y_s)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("pack,fast", [(False, False), (True, True)])
def test_split_24_40_equals_one_run(case, pack, fast):
    one, two = fresh(), fresh()
    y = port_fused(case, state=one, pack_gates=pack, fast_math=fast)[0]
    ys = [port_fused(case, state=two, n=SPLIT, pack_gates=pack,
                     fast_math=fast)[0],
          port_fused(case, state=two, t0=SPLIT, pack_gates=pack,
                     fast_math=fast)[0]]
    assert torch.equal(torch.cat(ys), y)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def test_fused_run_hands_state_to_exact_generator(case):
    """Fused for 24 steps, then the port's exact generator on the carried
    ring and y_state for 40: the JAX engine's fused run_partial followed by
    a dump run_partial (which it routes to the exact kernel)."""
    state = fresh()
    y1 = port_fused(case, state=state, n=SPLIT)[0]
    cond_pre = (torch.from_numpy(case["cond"][SPLIT:])
                + case["tp"]["dil_b"][None, :, None, :]).contiguous()
    y2 = tper.make_persistent_generator(PCFG, B)(
        case["tp"], SPLIT, cond_pre, torch.from_numpy(case["sel"][SPLIT:]),
        *state)[0]
    assert np.array_equal(torch.cat([y1, y2]).numpy().T, case["y_handoff"])


def test_plan_and_inputs_are_checked(case):
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    with pytest.raises(ValueError, match="multiple of 8"):
        tfc.fused_plan(WaveNetConfig(num_layers=2, R=36, S=128, A=256,
                                     max_dilation=2))
    with pytest.raises(ValueError, match="shared memory"):
        tfc.make_fused_generator(WaveNetConfig(num_layers=60, R=256, S=256,
                                               A=256, max_dilation=8), 1)
    with pytest.raises(ValueError, match="mode"):
        tfc.make_fused_generator(PCFG, B, mode="beam")
    plan = tfc.fused_plan(PCFG, pack_gates=True)
    assert plan.row_stride == CFG.R and tfc.fused_plan(PCFG).row_stride == 128
    weights = tfc.prepare_weights(case["tp"], PCFG, False)
    gen = tfc.make_fused_generator(PCFG, B)
    cond = torch.from_numpy(case["cond"][:4])
    sel = torch.from_numpy(case["sel"][:4])
    with pytest.raises(ValueError, match="g_pack"):   # pack mismatch
        tfc.make_fused_generator(PCFG, B, pack_gates=True)(
            weights, 0, cond, sel, *fresh())
    with pytest.raises(ValueError, match="cond"):
        gen(weights, 0, cond.double(), sel, *fresh())
    with pytest.raises(ValueError, match="n_valid"):
        gen(weights, 0, cond, sel, *fresh(), n_valid=5)
    with pytest.raises(ValueError, match="symbols"):
        tfc.make_fused_generator(PCFG, B, mode="forced")(
            weights, 0, cond, sel + 0.5, *fresh())
    # a prepared tuple and the canonical params give the same run
    assert torch.equal(gen(weights, 0, cond, sel, *fresh())[0],
                       gen(case["tp"], 0, cond, sel, *fresh())[0])


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------

def test_engine_fuse_chain_agrees_with_jax_engine(case):
    y = port_engine(case, fuse_chain=True).run(T, B)
    agree = float(np.mean(y == case["y_eng"]))
    assert agree >= 0.99, f"agreement {agree:.4f}"
    assert float(np.mean(y == case["forced"].T)) >= 0.99


@pytest.mark.parametrize("kw", [dict(priority="latency"),
                                dict(fuse_chain=True, fuse_pack=True)],
                         ids=["latency", "fuse_pack"])
def test_engine_dump_runs_the_exact_kernel(case, kw):
    """Dumps leave the fused kernel and drop the fast_math priority set:
    bit-equal to a default engine's dump run, samples and getters."""
    eng, ref = port_engine(case, **kw), port_engine(case)
    assert np.array_equal(eng.run(T, B, dump_activations=True),
                          ref.run(T, B, dump_activations=True))
    for get in ("get_p", "get_za", "get_zs"):
        assert np.array_equal(getattr(eng, get)(), getattr(ref, get)())
    assert np.array_equal(eng.get_xt_out(3), ref.get_xt_out(3))


def test_priority_tiers(case):
    eng = port_engine(case, priority="latency")
    assert eng.fuse_chain and eng.fast_math
    assert eng._effective_fast_math(False) and not eng._effective_fast_math(True)
    y_lat = eng.run(T, B)
    assert np.array_equal(y_lat, port_engine(case, fuse_chain=True,
                                             fast_math=True).run(T, B))
    exact = port_engine(case, priority="exact")
    assert not (exact.fuse_chain or exact.fast_math)
    assert np.array_equal(exact.run(T, B), port_engine(case).run(T, B))
    # the fold follows the weights' temperature: a fresh engine at T=0.8
    eng.set_temperature(0.8)
    assert np.array_equal(eng.run(T, B), port_engine(
        case, priority="latency", temperature=0.8).run(T, B))


def test_lockstep_feeds_13_6_45_equal_the_run(case):
    eng = port_engine(case, priority="latency")
    y_run = eng.run(T, B)
    eng.begin_stream(B)
    outs, off = [], 0
    for n in (13, 6, 45):
        outs.append(eng.feed(case["cond"][off:off + n],
                             case["sel"][off:off + n]))
        off += n
    assert np.array_equal(np.concatenate(outs, 1), y_run)


@pytest.mark.parametrize("where", ["no_fuse_chain", "dump", "ragged",
                                   "manyblock"])
def test_fast_math_dispatches_run(case, where):
    """fast_math off K6: each dispatch that once raised (ROADMAP item 10b)
    now runs K1's step with fast_math: its samples and ring equal the plain
    generator's in precision "fast" on the same symbols, and its ring (and
    with the dump its p and za) differ from the exact engine's, so the
    rounding is real."""
    kw = {"no_fuse_chain": dict(fast_math=True),
          "dump": dict(fuse_chain=True, fast_math=True),
          "ragged": dict(priority="latency"),
          "manyblock": dict(priority="latency",
                            implementation=Impl.MANYBLOCK)}[where]
    n = 8
    eng, ref = port_engine(case, **kw), port_engine(case)
    lens = np.arange(B) % n if where == "ragged" else np.full(B, n)
    if where == "ragged":
        for e in (eng, ref):
            e.begin_stream(B)
            e.feed(case["cond"][:n], case["sel"][:n], lengths=lens)
        y = None
    else:
        y = eng.run(n, B, dump_activations=where == "dump")
        ref.run(n, B, dump_activations=where == "dump")
    ring = eng.export_state()["ring"]
    gen = tper.make_persistent_generator(PCFG, B, fast_math=True,
                                         ragged=where == "ragged")
    plain_ring, plain_ys = fresh()
    cond_pre = (torch.from_numpy(case["cond"][:n])
                + case["tp"]["dil_b"][None, :, None, :]).contiguous()
    sel = torch.from_numpy(case["sel"][:n])
    if where == "ragged":
        y_p = gen(case["tp"], torch.zeros(B, dtype=torch.int64), cond_pre,
                  sel, plain_ring, plain_ys,
                  torch.from_numpy(lens.astype(np.int32)))[0]
    else:
        y_p = gen(case["tp"], 0, cond_pre, sel, plain_ring, plain_ys)[0]
        assert np.array_equal(y, y_p.numpy().T)
    assert np.array_equal(ring, plain_ring.numpy())
    assert not np.array_equal(ring, ref.export_state()["ring"])
    if where == "dump":
        for get in ("get_p", "get_za"):
            assert not np.array_equal(getattr(eng, get)(),
                                      getattr(ref, get)())


# the geometries K6 rejects: R not a multiple of 8; activations past 227 KB
K6_REJECTS = {"L2_R36": dict(num_layers=2, R=36, S=128, A=256,
                             max_dilation=2),
              "L60_R256": dict(num_layers=60, R=256, S=256, A=256,
                               max_dilation=8)}


@pytest.mark.parametrize("geometry", list(K6_REJECTS))
def test_fuse_chain_falls_back_where_k6_cannot_run(geometry, capsys):
    """Fault F1 (ROADMAP.md): a geometry K6 cannot run no longer raises in
    the constructor.  As the JAX engine (tests/test_fused_chain.py
    ::test_fuse_chain_vmem_fallback), fuse_chain sends every dispatch to
    the exact kernels and says so once; priority="latency" keeps its
    fast_math there.  make_fused_generator itself still raises."""
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    g = K6_REJECTS[geometry]
    cfg = WaveNetConfig(**g)
    with pytest.raises(ValueError):
        tfc.make_fused_generator(cfg, 1)
    rng = np.random.RandomState(5)
    Bg, Tg = 2, 4
    ref_w = tparams.random_reference_weights(cfg, seed=5)
    cond = rng.uniform(-0.5, 0.5, (Tg, cfg.num_layers, Bg, 2 * cfg.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (Tg, Bg)).astype(np.float32)

    def run(**kw):
        eng = WaveNetInfer(max_batch=Bg, chunk_size=Tg, device="cpu", **g,
                           **kw)
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        return eng, eng.run(Tg, Bg)

    fused, y = run(fuse_chain=True)
    assert "fuse_chain disabled" in capsys.readouterr().out
    assert np.array_equal(y, run()[1])
    latency, y_lat = run(priority="latency")
    assert latency.fast_math and latency._precision(False) == "fast"
    assert np.array_equal(y_lat, run(fast_math=True)[1])
    assert all(k[-1] == "fast" for k in latency._gens)


def test_unknown_priority_raises():
    with pytest.raises(ValueError, match="priority"):
        WaveNetInfer(num_layers=2, max_dilation=2, R=32, S=128, A=256,
                     device="cpu", priority="throughput")


# ----------------------------------------------------------------------
# the cluster K6 (csrc/fused_chain.cu): its plan, route, stream and a plain
# model of its sums, in its order (`fused_chain.cluster_model`)
# ----------------------------------------------------------------------

TM = 16   # steps of the model's runs: it sums term by term


def model_run(c, mode="sample", sel=None, state=None, t0=0, n=TM, pack=False,
              stream=None, **kw):
    """The cluster K6's model on the CPU over raw cond, steps [t0, t0+n)."""
    prec = tsg.precision(kw.get("compute_dtype", torch.float32),
                         kw.get("fast_math", False))
    w = tfc.prepare_weights(c["tp"], PCFG, False, pack_gates=pack, **kw)
    plan = tfc.cluster_plan(PCFG, B, prec)
    if stream is None:
        stream = tfc.cluster_stream(w, PCFG, plan, pack)
    s_in = c["sel"] if sel is None else sel
    state = fresh() if state is None else state
    sl = slice(t0, t0 + n)
    return tfc.cluster_model(PCFG, plan, stream, w, t0,
                             torch.from_numpy(c["cond"][sl]),
                             torch.from_numpy(np.ascontiguousarray(s_in[sl])),
                             *state, n, mode, PRNG_SEED, prec)


def test_cluster_model_matches_plain_and_jax_interpret_kernel(case):
    """The model's reassociation against the plain K6 and the JAX fused
    kernel in interpret mode: forced p within 2e-5 of both and max TV <
    5e-4 against the fp32 exact path (the fp32 fused contract); sampled
    and argmax symbols >= 99% equal to the JAX kernel's."""
    torch.set_num_threads(1)
    sym = case["forced"].astype(np.float32)
    out = model_run(case, "forced", sel=sym)
    p = forced_probs(out)
    plain = port_fused(case, "forced", sel=sym, n=TM)
    assert np.abs(out[3].numpy() - plain[3].numpy()).max() < 2e-5
    assert np.abs(out[3].numpy()
                  - case["jax"]["forced"][3][:TM]).max() < 2e-5
    t = tv(case["p32"][:TM], p)
    assert t.max() < 5e-4, f"max TV {t.max():.2e}"
    assert np.array_equal(out[0].numpy(), case["forced"][:TM])
    for mode in ("sample", "argmax"):
        y = model_run(case, mode)[0].numpy()
        agree = float(np.mean(y == case["jax"][mode][0][:TM]))
        assert agree >= 0.99, f"{mode}: agreement {agree:.4f}"


@pytest.mark.parametrize("kw,bounds", [
    (dict(fast_math=True), (0.025, 0.10, 0.20)),
    (dict(compute_dtype=torch.bfloat16), (0.025, 0.10, 0.20)),
], ids=["fast_math", "bf16"])
def test_cluster_model_low_precisions_meet_the_tv_contract(case, kw, bounds):
    """fast_math and compute_dtype=bf16 in the model: forced p within 2e-5
    of the plain K6 of the same precision, the TV bounds against fp32."""
    torch.set_num_threads(1)
    sym = case["forced"].astype(np.float32)
    state = (tper.init_ring(PCFG, B, "cpu", tsg.ring_dtype(
        tsg.precision(kw.get("compute_dtype", torch.float32),
                      kw.get("fast_math", False)))),
             torch.full((2, B), PCFG.silence_bin, dtype=torch.int32))
    state2 = (state[0].clone(), state[1].clone())
    out = model_run(case, "forced", sel=sym, state=state, **kw)
    plain = port_fused(case, "forced", sel=sym, n=TM, state=state2, **kw)
    assert np.abs(out[3].numpy() - plain[3].numpy()).max() < 2e-5
    t = tv(case["p32"][:TM], forced_probs(out))
    mean_b, p99_b, max_b = bounds
    assert t.mean() < mean_b and t.max() < max_b
    assert np.percentile(t, 99) < p99_b


def test_cluster_model_split_and_pack_gates_are_bit_equal(case):
    """A 7 + 9 split equals one call bit for bit (y, ring, y_state), and
    pack_gates on equals off (the stream holds only the real rows)."""
    torch.set_num_threads(1)
    one, two, packed = fresh(), fresh(), fresh()
    y = model_run(case, state=one, fast_math=True)[0]
    ys = [model_run(case, state=two, n=7, fast_math=True)[0],
          model_run(case, state=two, t0=7, n=TM - 7, fast_math=True)[0]]
    assert torch.equal(torch.cat(ys), y)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    yp = model_run(case, state=packed, pack=True, fast_math=True)[0]
    assert torch.equal(yp, y) and torch.equal(packed[0], one[0])
    w = tfc.prepare_weights(case["tp"], PCFG, False)
    wp = tfc.prepare_weights(case["tp"], PCFG, False, pack_gates=True)
    plan = tfc.cluster_plan(PCFG, B)
    assert torch.equal(tfc.cluster_stream(w, PCFG, plan),
                       tfc.cluster_stream(wp, PCFG, plan, True))


@pytest.mark.parametrize("block", ["g_0_2", "g_1_2"])
def test_cluster_model_that_drops_a_g_term_fails(case, block):
    """Mutation check of the model test: zeroing one h_j G_{j,m} term's
    slice in the stream (G_{0,2}, off the chain; G_{1,2}, on it) breaks the
    fp32 TV contract against the exact path."""
    torch.set_num_threads(1)
    w = tfc.prepare_weights(case["tp"], PCFG, False)
    plan = tfc.cluster_plan(PCFG, B)
    stream = tfc.cluster_stream(w, PCFG, plan).clone()
    m = {"g_0_2": 3, "g_1_2": 4}[block]   # OFF_0's first block; CRIT_2
    o = sum(K * W for K, W in plan.matrices[:m])
    K, W = plan.matrices[m]
    stream[:, o:o + K * W].view(tfc.CLUSTER, K, W)[:, :, :plan.widths[0]] = 0
    sym = case["forced"].astype(np.float32)
    t = tv(case["p32"][:TM], forced_probs(model_run(case, "forced", sel=sym,
                                                    stream=stream)))
    assert t.max() > 5e-4


# the geometries the cluster K6 runs: (config, batch, rows a group)
CLUSTER_GEOMETRIES = [
    (dict(num_layers=20, R=64, S=256, A=256, max_dilation=512), 16, 2),
    (dict(num_layers=20, R=64, S=256, A=256, max_dilation=512), 1, 1),
    (dict(num_layers=40, R=128, S=256, A=256, max_dilation=128), 64, 2),
    (dict(num_layers=20, R=64, S=128, A=256, max_dilation=8), 4, 2),
    (dict(num_layers=6, R=32, S=128, A=256, max_dilation=8), 8, 2),
    (dict(num_layers=2, R=32, S=128, A=256, max_dilation=2), 3, 1),
]


@pytest.mark.parametrize("prec", tsg.PRECISIONS)
@pytest.mark.parametrize("g,batch,rows", CLUSTER_GEOMETRIES)
def test_cluster_plan_and_route(g, batch, rows, prec):
    """The cluster plan holds the flagship (B = 16 and 1), config 4, and
    every geometry the K6 tests use; its ring, widths and stream sizes are
    the kernel's (csrc/fused_chain.cu check), and the route names it."""
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    cfg = WaveNetConfig(**g)
    plan = tfc.cluster_plan(cfg, batch, prec)
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    eb = 4   # the stream is fp32 in every precision
    assert (plan.cluster, plan.rows, plan.groups) == (8, rows, batch // rows)
    assert plan.widths == (R // 4, S // 8, -(-R // 32) * 4, A // 8)
    assert len(plan.matrices) == 2 * L + 3
    assert plan.step_bytes == sum(K * W for K, W in plan.matrices) * eb
    assert plan.chunks == sum(-(-K // p) for (K, _), p in
                              zip(plan.matrices, plan.piece_rows))
    for (K, W), p in zip(plan.matrices, plan.piece_rows):
        assert W % 4 == 0 and K % 4 == 0 and p % 4 == 0 or p == K
        assert 4 <= p and p * W * eb <= plan.slot_bytes
    assert plan.slot_bytes % 128 == 0 and plan.slots >= (3 if rows > 1 else 2)
    assert plan.smem_bytes + tper._STATIC_SMEM <= tper.SMEM_PER_BLOCK
    route = tfc.fused_route(cfg, batch, prec)
    assert route.kernel == "cluster" and route.note is None
    assert route.plan == plan
    for mode in tsg.MODES:
        assert route.cuda_kernel(mode, prec) is tfc.FUSED_KERNELS[
            (tfc._SEL[mode], prec)]
    assert tfc.make_fused_generator(
        cfg, batch, **PREC_KW[prec]).route.kernel == "cluster"


PREC_KW = {"exact": {}, "fast": dict(fast_math=True),
           "bf16": dict(compute_dtype=torch.bfloat16)}


def test_route_takes_the_first_k6_where_the_cluster_plan_raises():
    """R a multiple of 8 but not of 16, S or A not of 32: the first K6,
    with the cluster plan's error as the note; K6_REJECTS stay rejected by
    both."""
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    for g, why in ((dict(num_layers=2, R=40, S=128, A=256), "R = 40"),
                   (dict(num_layers=3, R=32, S=136, A=256), "S = 136"),
                   (dict(num_layers=3, R=32, S=128, A=200), "A = 200")):
        cfg = WaveNetConfig(**g, max_dilation=2)
        with pytest.raises(ValueError, match=why):
            tfc.cluster_plan(cfg, 2)
        for prec in tsg.PRECISIONS:
            route = tfc.fused_route(cfg, 2, prec)
            assert route.kernel == "first" and why in route.note
            assert route.plan == tfc.fused_plan(cfg)
            assert route.cuda_kernel("forced", prec) is \
                tfc.FIRST_FUSED_KERNELS[("forced", prec)]
            gen = tfc.make_fused_generator(cfg, 2, **PREC_KW[prec])
            assert gen.route.kernel == "first"
    for g in K6_REJECTS.values():
        cfg = WaveNetConfig(**g)
        for prec in tsg.PRECISIONS:
            with pytest.raises(ValueError):
                tfc.fused_route(cfg, 1, prec)


def test_cluster_stream_holds_each_ctas_columns_of_the_fold(case):
    """CTA c's slice of every matrix is the fold's columns the kernel
    assigns it: u_l's pairs (i, R + i), i in [c R/8, (c+1) R/8), S/8 of
    Wskip, R/8 of Wres (zero-padded), A/8 of out_w and end_w."""
    w = tfc.prepare_weights(case["tp"], PCFG, False)
    plan = tfc.cluster_plan(PCFG, B, "fast")
    wf = tfc.prepare_weights(case["tp"], PCFG, False, fast_math=True)
    stream = tfc.cluster_stream(wf, PCFG, plan)
    assert stream.dtype == torch.float32 and stream.shape[0] == 8
    assert torch.equal(stream, torch.cat([m.reshape(8, -1) for m in
                                          tfc.cluster_slices(wf, PCFG)], 1))
    slices = tfc.cluster_slices(w, PCFG)
    L, R, S, A = PCFG.num_layers, PCFG.R, PCFG.S, PCFG.A
    h = R // 8
    wu, ws, wr, wa = tfc.cluster_widths(PCFG)
    (_, wprev, wres, _, g_pack, wcur_cat, wskip_cat, _, _, out_w, _, end_w,
     _) = w
    P = tfc._row_stride(R)
    for c in range(8):
        cu = list(range(c * h, (c + 1) * h)) + list(range(R + c * h,
                                                          R + (c + 1) * h))
        assert torch.equal(slices[0][c][:, :wu], wprev[0][:, cu])
        assert torch.equal(slices[1][c][:, wu:2 * wu],
                           wcur_cat[:, 2 * R + torch.tensor(cu)])
        g12 = g_pack[P * 2:P * 2 + R]   # block (j=1, l=2)
        assert torch.equal(slices[4][c], g12[:, cu])
        off0 = slices[3][c]             # [G_{0,2} .. G_{0,L-1} | skip | res]
        g03 = g_pack[P * 3:P * 3 + R]   # block (j=0, l=3)
        assert torch.equal(off0[:, wu:2 * wu], g03[:, cu])
        tail = off0[:, (L - 2) * wu:]
        assert torch.equal(tail[:, :ws], wskip_cat[:R, c * ws:(c + 1) * ws])
        assert torch.equal(tail[:, ws:ws + h], wres[0][:, c * h:(c + 1) * h])
        assert not tail[:, ws + h:].any()
        assert torch.equal(slices[-2][c], out_w[:, c * wa:(c + 1) * wa])
        assert torch.equal(slices[-1][c], end_w[:, c * wa:(c + 1) * wa])
    assert wr == -(-h // 4) * 4


def test_cluster_model_fma_rounds_once():
    """The model's FMA (`fused_chain._fma`) is a * b + c rounded once to
    fp32, as __fmaf_rn, also where the fp64 sum lands on a midpoint of two
    fp32 values (c = 1, a * b within 2^-53 of 2^-24): held to the exact sum
    (fractions) rounded to nearest, ties to even."""
    from fractions import Fraction
    rng = np.random.RandomState(5)
    a = (1 + rng.randint(0, 1 << 23, 4000) / 2.0 ** 23).astype(np.float32)
    b = (2.0 ** -24 / a.astype(np.float64)).astype(np.float32)
    c = np.ones_like(a)
    got = tfc._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()

    def round_once(x: Fraction) -> np.float32:
        f = np.float32(float(x))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
    want = np.array([round_once(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    s = a.astype(np.float64) * b.astype(np.float64) + 1.0
    ties = int(np.sum(s == 1 + 2.0 ** -24))
    assert ties >= 50    # the double-rounding cases were reached
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
