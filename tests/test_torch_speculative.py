"""Speculative exact decode on the CPU (`ops/speculative.py` and the
engine's `run_speculative`) against the JAX package: its scan generator
(the exact reference of tests/test_speculative.py), its commit arithmetic
and branch choice, and its engine's `run` and `run_speculative` in
interpret mode.

The config is tests/test_speculative.py's (6 layers, R=32, S=128, A=256,
max_dilation 4).  Every comparison of samples and carried state is exact:
the verify pass computes K1's step in K1's order and the draft moves only
the number of rounds (the port's plain draft rounds its operands to bf16
under fast_math, the JAX draft on the CPU does not, so rounds may differ,
never samples).  The commit arithmetic is float32 on both sides, held to
rtol 1e-6 (numpy's and XLA's expm1 may differ in the last ulp).  The JAX
engines run once, in the module fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.models import params as jparams
from nv_wavenet_tpu.ops import speculative as jspec
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import fused_chain as tfc
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import speculative as tspec

from tests.test_speculative import CFG, case, exact_reference
from tests.test_torch_persistent import port_cfg

PCFG = port_cfg(CFG)
ENG_B, ENG_T, ENG_WINDOW = 2, 48, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are tiny: torch's intra-op threads cost more than
    they save (about 4x here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_params(params):
    return tparams.canonical_to_torch(
        {k: np.asarray(v, np.float32) for k, v in params.items()}, "cpu")


def fresh(B):
    return (tper.init_ring(PCFG, B, "cpu"),
            torch.full((2, B), PCFG.silence_bin, dtype=torch.int32))


def draft_weights(params):
    return tfc.prepare_weights(torch_params(params), PCFG, False,
                               fast_math=True)


def reference_and_more(params, cond, sel, seed):
    """The JAX scan's samples [T + 8, B] over the window and 8 more steps
    drawn from `seed`, and those steps' inputs."""
    B = sel.shape[1]
    rng = np.random.RandomState(seed)
    cond2 = rng.uniform(-1, 1, (8, CFG.num_layers, B, 2 * CFG.R)
                        ).astype(np.float32)
    sel2 = rng.uniform(0, 1, (8, B)).astype(np.float32)
    y_all, _ = exact_reference(CFG, params, np.concatenate([cond, cond2]),
                               np.concatenate([sel, sel2]))
    return y_all, cond2, sel2


def continue_exact(params, t0, cond2, sel2, ring, ys):
    """8 steps of the exact plain generator from a carried state."""
    tp = torch_params(params)
    cond_pre = torch.from_numpy(cond2) + tp["dil_b"][None, :, None, :]
    return tper.make_persistent_generator(PCFG, sel2.shape[1])(
        tp, t0, cond_pre.contiguous(), torch.from_numpy(sel2), ring,
        ys)[0].numpy()


# (B, T, K, seed, the draft's rs_w offset, chunks): tests/test_speculative.py
# :48-107, 274-279
SPEC_CASES = {
    "default": (1, 48, 8, 11, 0.0, None),
    "garbage_draft": (2, 30, 8, 3, 0.5, None),
    "chunked": (3, 41, 16, 29, 0.0, [10, 1, 30]),
    "window_exceeds_T": (1, 10, 16, 5, 0.0, None),
}


@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_speculative_matches_scan_reference(name):
    """y and the carried y_state equal the JAX scan bit for bit, and the
    carried ring continues generation exactly."""
    B, T, K, seed, offset, chunks = SPEC_CASES[name]
    params, cond, sel = case(CFG, B, T, seed=seed)
    y_all, cond2, sel2 = reference_and_more(params, cond, sel, seed + 1)
    y_ref = y_all[:T]
    bad = dict(params, rs_w=params["rs_w"] + offset)
    gen = tspec.make_speculative_generator(PCFG, B, K)
    tp, folded = torch_params(params), draft_weights(bad)
    ring, ys = fresh(B)
    outs, t0, rounds = [], 0, 0
    for n in chunks or [T]:
        y, ring, ys, r = gen(tp, folded, t0,
                             torch.from_numpy(cond[t0:t0 + n]),
                             torch.from_numpy(sel[t0:t0 + n]), ring, ys)
        outs.append(y.numpy())
        rounds += r
        t0 += n
    y = np.concatenate(outs)
    assert np.array_equal(y, y_ref)
    assert np.array_equal(ys.numpy(), y_ref[-2:])
    if offset:
        assert rounds > T // K, rounds     # corrections happened
    assert np.array_equal(continue_exact(params, T, cond2, sel2, ring, ys),
                          y_all[T:])


# costs that force each branch (they steer speed only): a round's cost
# independent of K (a longer window commits more); a negative V0, which
# makes the smaller window cheaper per step; the exact kernel nearly free;
# and a run too short to probe
BRANCH_COSTS = {0: (1.0, 0.0, 1e9), 1: (-1.0, 1.0, 1e9),
                2: (1e9, 1e9, 0.001), -1: tspec.DEFAULT_COST}


@pytest.mark.parametrize("branch", list(BRANCH_COSTS))
def test_adaptive_branch_is_exact(branch):
    B, K = 2, 8
    T = 56 if branch != -1 else 40
    params, cond, sel = case(CFG, B, T, seed=41)
    y_all, cond2, sel2 = reference_and_more(params, cond, sel, 9)
    tp = torch_params(params)
    k1 = tper.make_persistent_generator(PCFG, B)

    def exact(t0, cond, sel, ring, ys):
        cond_pre = cond + tp["dil_b"][None, :, None, :]
        return k1(tp, t0, cond_pre.contiguous(), sel.contiguous(), ring,
                  ys)[0]

    gen = tspec.make_adaptive_generator(PCFG, B, K, exact, probe_window=K,
                                        cost=BRANCH_COSTS[branch])
    ring, ys = fresh(B)
    y, ring, ys, rounds, got = gen(tp, draft_weights(params), 0,
                                   torch.from_numpy(cond),
                                   torch.from_numpy(sel), ring, ys)
    assert got == branch
    assert np.array_equal(y.numpy(), y_all[:T])
    assert np.array_equal(continue_exact(params, T, cond2, sel2, ring, ys),
                          y_all[T:])


def test_commit_arithmetic_matches_jax():
    for K in (1, 8, 64, 128, 256):
        for r in (0.5, 1.0, 3.0, 35.0, 180.0, 1e4, 1e9):
            np.testing.assert_allclose(
                tspec.expected_commit(K, r),
                float(jspec.expected_commit(K, jnp.float32(r))), rtol=1e-6)
        for c in (0.5, 1.0, 2.0, 0.5 * K, 0.9 * K, 0.96 * K, K):
            np.testing.assert_allclose(
                tspec.invert_commit(K, c),
                float(jspec.invert_commit(K, jnp.float32(c))), rtol=1e-6)


def jax_branch(K, Kp, Tp, rounds, cost):
    """The branch choice of nv_wavenet_tpu/ops/speculative.py:236-246."""
    V0, V1, E0 = [jnp.float32(v) for v in cost]
    commit = jnp.float32(Tp) / jnp.maximum(rounds, 1).astype(jnp.float32)
    r_hat = jspec.invert_commit(Kp, commit)

    def rate(Kb):
        return jspec.expected_commit(Kb, r_hat) / (V0 + V1 * jnp.float32(Kb))

    return int(jnp.argmax(jnp.stack([rate(K), rate(max(K // 2, 1)),
                                     jnp.float32(1.0) / E0])))


@pytest.mark.parametrize("cost", [jspec.DEFAULT_COST, tspec.DEFAULT_COST,
                                  (145.0, 7.34, 200.0), (0.001, 1.0, 1e9)],
                         ids=["jax_default", "port_default", "window",
                              "half"])
def test_branch_choice_matches_jax(cost):
    K, Kp = 256, 64
    Tp = 4 * Kp
    for rounds in (1, 2, 3, 4, 5, 6, 8, 12, 20, 40, 100, 256):
        assert tspec.choose_branch(K, Kp, Tp, rounds, cost) == jax_branch(
            K, Kp, Tp, jnp.int32(rounds), cost), rounds


def test_flagship_default_cost_picks_exact():
    """At the flagship the measured H100 costs make the exact kernel the
    fastest branch for every probe result (every committed run length the
    probe can read), at the default window and half of it."""
    assert tcfg.FLAGSHIP_CONFIG.num_layers == 20
    for K in (256, 128):
        Kp = min(64, K)
        for rounds in range(1, 4 * Kp + 1):
            assert tspec.choose_branch(K, Kp, 4 * Kp, rounds) == 2, (K, rounds)


TIERS = {"fp32": {}, "bf16_weights_t07": dict(temperature=0.7)}


def engine_case():
    ref_w = jparams.random_reference_weights(CFG, seed=77,
                                             scale=1.0 / np.sqrt(CFG.R))
    rng = np.random.RandomState(4)
    cond = rng.uniform(-1, 1, (ENG_T, CFG.num_layers, ENG_B, 2 * CFG.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (ENG_T, ENG_B)).astype(np.float32)
    return ref_w, cond, sel


def geometry(cfg):
    return dict(num_layers=cfg.num_layers, max_dilation=cfg.max_dilation,
                R=cfg.R, S=cfg.S, A=cfg.A)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's run() on each tier, and its fixed-window
    run_speculative on fp32 only (its adaptive tier, and its fixed tier on
    the others, equal its run() in tests/test_speculative.py); each
    interpret-mode run takes 3-5 s."""
    ref_w, cond, sel = engine_case()
    out = {}
    for tier, kw in TIERS.items():
        wdt = jnp.bfloat16 if tier != "fp32" else jnp.float32
        eng = jinfer.WaveNetInfer(**geometry(CFG), max_batch=ENG_B,
                                  implementation=jinfer.Impl.PERSISTENT,
                                  chunk_size=8, weight_dtype=wdt, **kw)
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        y_run = eng.run(ENG_T, ENG_B)
        y_spec = None
        if tier == "fp32":
            eng.set_inputs(cond, sel)
            y_spec = eng.run_speculative(ENG_T, ENG_B, window=ENG_WINDOW,
                                         adaptive=False)
        out[tier] = (y_run, y_spec)
    return out


def port_engine(tier, **kw):
    ref_w, cond, sel = engine_case()
    wdt = torch.bfloat16 if tier != "fp32" else torch.float32
    eng = WaveNetInfer(**geometry(CFG), max_batch=ENG_B, chunk_size=8,
                       weight_dtype=wdt, device="cpu", **TIERS[tier], **kw)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    return eng


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("tier", list(TIERS))
def test_engine_run_speculative_matches_jax(jax_runs, tier, B, adaptive):
    """The port's run_speculative equals the JAX engine's run() (and, on
    fp32, its run_speculative) and the port's own run(), bit for bit."""
    y_run, y_spec = jax_runs[tier]
    if y_spec is not None:
        assert np.array_equal(y_run, y_spec)
    eng = port_engine(tier)
    y_port_run = eng.run(ENG_T, B)
    y = eng.run_speculative(ENG_T, B, window=ENG_WINDOW, adaptive=adaptive)
    assert np.array_equal(y, y_run[:B])
    assert np.array_equal(y, y_port_run)
    assert eng.spec_rounds >= 1
    assert (eng.spec_branch in tspec.BRANCHES) if adaptive \
        else eng.spec_branch is None


# the JAX engine's raises (engine/wavenet_infer.py:1106-1129) and K6's
# geometry check, which the port makes on the CPU too
RAISES = {
    "fast_math": (dict(fast_math=True), "deterministic"),
    "fuse_chain": (dict(fuse_chain=True), "deterministic"),
    "priority_latency": (dict(priority="latency"), "deterministic"),
    "bf16_compute": (dict(compute_dtype="bf16"), "deterministic"),
    "overlength": ({}, "conditioning"),
    "before_set_inputs": ({}, "set_inputs"),
}


@pytest.mark.parametrize("name", list(RAISES) + ["k6_geometry"])
def test_engine_run_speculative_raises(name):
    ref_w, cond, sel = engine_case()
    if name == "k6_geometry":
        # R=36: K6 loads four columns at a time (fused_chain.fused_plan)
        eng = WaveNetInfer(num_layers=2, max_dilation=2, R=36, S=128,
                           A=256, max_batch=1, device="cpu")
        eng.set_inputs(np.zeros((4, 2, 1, 72), np.float32))
        with pytest.raises(ValueError, match="K6"):
            eng.run_speculative(4, 1, window=4)
        return
    kw, match = RAISES[name]
    for lib, impl in ((jinfer, jinfer.Impl.PERSISTENT),
                      (None, Impl.PERSISTENT)):
        extra = dict(kw)
        if extra.get("compute_dtype") == "bf16":
            extra["compute_dtype"] = (jnp.bfloat16 if lib is jinfer
                                      else torch.bfloat16)
        if lib is jinfer:
            eng = jinfer.WaveNetInfer(**geometry(CFG), max_batch=ENG_B,
                                      implementation=impl, chunk_size=8,
                                      **extra)
        else:
            eng = WaveNetInfer(**geometry(CFG), max_batch=ENG_B,
                               implementation=impl, chunk_size=8,
                               device="cpu", **extra)
        eng.set_reference_weights(ref_w)
        if name != "before_set_inputs":
            eng.set_inputs(cond, sel)
        with pytest.raises(ValueError, match=match):
            eng.run_speculative(2 * ENG_T if name == "overlength" else ENG_T,
                                ENG_B, window=ENG_WINDOW)


def test_speculative_int8_bitmatches_run_r10():
    """Under Impl.MANYBLOCK with int8 stacks the port's run_speculative,
    fixed and adaptive, equals the port's run(): the verify pass and the
    draft take `persistent.value_view` of the stored stacks.  At these
    weights (scale 3) int8 changes 69 of the 96 samples against fp32, so a
    verify pass on the fp32 weights could not pass; the JAX engine's
    run_speculative verifies with them and differs from its own run() in
    exactly those samples (fault R10, ROADMAP.md)."""
    ref_w = jparams.random_reference_weights(CFG, seed=77,
                                             scale=3.0 / np.sqrt(CFG.R))
    rng = np.random.RandomState(4)
    cond = rng.uniform(-1, 1, (ENG_T, CFG.num_layers, ENG_B, 2 * CFG.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (ENG_T, ENG_B)).astype(np.float32)
    ys = {}
    for name, kw in (("fp32", {}),
                     ("int8", dict(implementation=Impl.MANYBLOCK,
                                   stream_quant="int8"))):
        eng = WaveNetInfer(**geometry(CFG), max_batch=ENG_B, chunk_size=8,
                           device="cpu", **kw)
        eng.set_reference_weights(ref_w)
        eng.set_inputs(cond, sel)
        ys[name] = eng.run(ENG_T, ENG_B)
    y_int8 = ys["int8"]
    assert int((y_int8 != ys["fp32"]).sum()) == 69
    for adaptive in (False, True):
        assert np.array_equal(
            eng.run_speculative(ENG_T, ENG_B, window=ENG_WINDOW,
                                adaptive=adaptive), y_int8), adaptive
    jeng = jinfer.WaveNetInfer(**geometry(CFG), max_batch=ENG_B,
                               implementation=jinfer.Impl.MANYBLOCK,
                               chunk_size=8, stream_quant="int8")
    jeng.set_reference_weights(ref_w)
    jeng.set_inputs(cond, sel)
    jy_run = jeng.run(ENG_T, ENG_B)
    jeng.set_inputs(cond, sel)
    jy_spec = jeng.run_speculative(ENG_T, ENG_B, window=ENG_WINDOW,
                                   adaptive=False)
    assert np.array_equal(jy_run, y_int8)
    assert np.array_equal(jy_spec, ys["fp32"])
    assert int((jy_spec != jy_run).sum()) == 69
