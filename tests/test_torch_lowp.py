"""The port's two precision knobs on the CPU: `fast_math` and
`compute_dtype=torch.bfloat16` through the plain versions of K1/K2/K3/K5
(`ops/scan_generate.py`), of K6 (`ops/fused_chain.py`), the time-parallel
scorer (`ops/score_parallel.py`) and the engine, against the JAX package.

The case is the hot case of tests/test_low_precision.py (6 layers, R=32,
S=128, A=256, max_dilation 8; trained-scale weights, p_max ~0.85), B=8,
T=64 (the JAX interpret-mode kernel: 32 steps), driven through the fp32
free run's symbols (teacher forcing).  Tolerances and why:
  * the port's "bf16" against JAX's bf16 (its scan, and its persistent
    kernel in interpret mode): mean and p99 per-step TV below a fifth of
    the mean TV between JAX's fp32 and bf16 scans on the same case
    (measured: 4e-5 to 5e-5 against 5.5e-3).  Both sum the same exact
    bf16 x bf16 products in fp32 in other orders; a one-ulp difference
    flips a rounding of x now and then (one row over four steps here).
    JAX's kernels round the embedding table before the lookup and so does
    the port everywhere; JAX's scan rounds only after it (its one-hot
    product runs at DEFAULT precision, fp32 on XLA:CPU), which alone moves
    p as much as bf16 itself, so the scan is fed the rounded table;
  * "fast" has no JAX oracle on the CPU (XLA:CPU computes DEFAULT as
    HIGHEST, tests/test_low_precision.py:169-172): it, "bf16" and K6 in
    "bf16" are held to the TV contract against JAX fp32 (mean < 0.025, p99
    < 0.10, max < 0.20, tests/test_low_precision.py:145-178), with a TV
    above 1e-3 against the port's own exact run as the positive control;
  * the scorer in "bf16" against JAX's bf16 scorer (fed the rounded table)
    and against the plain forced run: the same TV bounds as above (their
    products sum in other orders);
  * the engine's chunking, ragged feeds, snapshot and handoffs: exact
    integers (one computation, one order).
The JAX runs are made once, in the module fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.ops import persistent as jper
from nv_wavenet_tpu.ops import score_parallel as jsp
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import fused_chain as tfc
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from nv_wavenet_tpu_torch.ops import score_parallel as tsp

from tests.test_low_precision import (CFG, free_run_forced, hot_case,
                                      kernel_forced_probs, scan_forced_probs,
                                      tv)
from tests.test_torch_persistent import port_cfg

B, T, TK = 8, 64, 32
PCFG = port_cfg(CFG)
DTYPES = {"exact": torch.float32, "fast": torch.float32,
          "bf16": torch.bfloat16}


def renorm(p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return p / p.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def case():
    """The hot case, its fp32 trajectory, JAX's fp32 and bf16 scans, JAX's
    bf16 interpret-mode kernel and its bf16 scorer."""
    params, cond, sel, ref_w = hot_case(CFG, B, T, seed=7)
    forced = np.ascontiguousarray(free_run_forced(CFG, params, cond, sel))
    rounded = {**params, "embed": jnp.asarray(params["embed"], jnp.bfloat16
                                              ).astype(jnp.float32)}
    p32 = scan_forced_probs(CFG, params, cond, sel, forced, jnp.float32)[:T]
    p_bf_raw = scan_forced_probs(CFG, params, cond, sel, forced,
                                 jnp.bfloat16)[:T]
    p_bf = scan_forced_probs(CFG, rounded, cond, sel, forced,
                             jnp.bfloat16)[:T]
    p_kbf = kernel_forced_probs(CFG, params, cond[:TK], forced[:TK], B,
                                compute_dtype=jnp.bfloat16)
    score = jsp.make_parallel_scorer(CFG, B, compute_dtype=jnp.bfloat16)
    p_sbf = score(rounded, 0, jnp.asarray(cond), jnp.asarray(forced),
                  jper.init_ring(CFG, B, jnp.bfloat16),
                  jnp.full((2, B), CFG.silence_bin, jnp.int32))[0]
    tp = tparams.canonical_to_torch(
        {k: np.asarray(v, np.float32) for k, v in params.items()}, "cpu")
    return dict(params=params, tp=tp, ref_w=ref_w, cond=cond, sel=sel,
                forced=forced, p32=p32, p_bf_raw=p_bf_raw, p_bf=p_bf,
                p_kbf=p_kbf, p_sbf=renorm(p_sbf), jtv=tv(p32, p_bf_raw))


def fresh(prec, batch=B):
    return (tper.init_ring(PCFG, batch, "cpu", tsg.ring_dtype(prec)),
            torch.full((2, batch), PCFG.silence_bin, dtype=torch.int32))


def cond_pre(c, n=T):
    return (torch.from_numpy(c["cond"][:n])
            + c["tp"]["dil_b"][None, :, None, :]).contiguous()


def symbols(c, n=T):
    return torch.from_numpy(c["forced"][:n].astype(np.float32))


def port_forced(c, prec, n=T, fused=False):
    """p_seq of the port's plain forced generator (K2's plain version, or
    K6's with fused=True) on the fp32 trajectory, renormalised."""
    kw = dict(compute_dtype=DTYPES[prec], fast_math=prec == "fast")
    if fused:
        gen = tfc.make_fused_generator(PCFG, B, "forced", prefold_cond=True,
                                       **kw)
    else:
        gen = tper.make_persistent_generator(PCFG, B, mode="forced", **kw)
    out = gen(c["tp"], 0, cond_pre(c, n), symbols(c, n), *fresh(prec))
    assert torch.equal(out[0], symbols(c, n).to(torch.int32))
    return renorm(out[-1])


def port_engine(c, batch=B, **kw):
    eng = WaveNetInfer(num_layers=CFG.num_layers,
                       max_dilation=CFG.max_dilation, R=CFG.R, S=CFG.S,
                       A=CFG.A, max_batch=batch, chunk_size=8, device="cpu",
                       **kw)
    eng.set_reference_weights(c["ref_w"])
    return eng


# ----------------------------------------------------------------------
# (a) the port's bf16 is JAX's bf16
# ----------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["scan", "interpret_kernel"])
def test_plain_bf16_matches_jax_bf16(case, oracle):
    p_port = port_forced(case, "bf16")
    p_jax = case["p_bf"] if oracle == "scan" else case["p_kbf"]
    t = tv(p_port[:len(p_jax)], p_jax)
    bound = case["jtv"].mean() / 5
    msg = (f"{oracle}: mean TV {t.mean():.3g} p99 {np.percentile(t, 99):.3g}"
           f" max {t.max():.3g}; bound {bound:.3g}")
    assert t.mean() < bound and np.percentile(t, 99) < bound, msg
    assert t.max() < case["jtv"].max(), msg


def test_jax_scan_rounds_the_embedding_later(case):
    """Why the scan is fed the rounded table: unrounded, JAX's bf16 scan
    is as far from its own kernel as bf16 is from fp32."""
    t_raw = tv(case["p_bf_raw"][:TK], case["p_kbf"])
    t_rounded = tv(case["p_bf"][:TK], case["p_kbf"])
    assert t_rounded.max() < 1e-6 < t_raw.mean()


# ----------------------------------------------------------------------
# (b) the TV contract against JAX fp32
# ----------------------------------------------------------------------

@pytest.mark.parametrize("prec,fused", [("fast", False), ("bf16", False),
                                        ("bf16", True)],
                         ids=["fast", "bf16", "k6_bf16"])
def test_low_precision_meets_the_tv_contract(case, prec, fused):
    p = port_forced(case, prec, fused=fused)
    t = tv(case["p32"], p)
    msg = (f"{prec} fused={fused}: mean TV {t.mean():.5f} p99 "
           f"{np.percentile(t, 99):.5f} max {t.max():.5f}")
    assert t.mean() < 0.025 and np.percentile(t, 99) < 0.10, msg
    assert t.max() < 0.20 and np.abs(p - case["p32"]).max() < 0.20, msg
    control = tv(port_forced(case, "exact", fused=fused), p).max()
    assert control > 1e-3, f"{prec}: the rounding changed nothing ({control})"


# ----------------------------------------------------------------------
# (c) the scorer in bf16
# ----------------------------------------------------------------------

def port_score(c, prec, n=T):
    score = tsp.make_parallel_scorer(PCFG, B, compute_dtype=DTYPES[prec],
                                     prefold_cond=True)
    ring, ys = fresh(prec)
    p = score(c["tp"], 0, cond_pre(c, n), torch.from_numpy(c["forced"][:n]),
              ring, ys)[0]
    return renorm(p), ring, ys


def test_scorer_bf16_matches_jax_scorer_and_plain_forced(case):
    p, ring, ys = port_score(case, "bf16")
    assert ring.dtype == torch.bfloat16
    bound = case["jtv"].mean() / 5
    for name, q in (("JAX scorer", case["p_sbf"]),
                    ("plain forced", port_forced(case, "bf16"))):
        t = tv(p, q)
        assert t.mean() < bound and np.percentile(t, 99) < bound, (
            f"{name}: mean TV {t.mean():.3g} p99 "
            f"{np.percentile(t, 99):.3g}; bound {bound:.3g}")
    assert torch.equal(ys[1], torch.from_numpy(case["forced"][T - 1]))


def test_bf16_score_then_feed_continues_exactly(case):
    """Score the first half on a bf16 engine, feed the second: the samples
    of one bf16 generation."""
    half = T // 2
    cond, sel = case["cond"], case["sel"]
    gen = port_engine(case, compute_dtype=torch.bfloat16)
    gen.begin_stream(B)
    head = gen.feed(cond[:half], sel[:half])
    tail = gen.feed(cond[half:], sel[half:])
    eng = port_engine(case, compute_dtype=torch.bfloat16)
    eng.begin_stream(B)
    eng.score(cond[:half], head)
    assert np.array_equal(eng.feed(cond[half:], sel[half:]), tail)


# ----------------------------------------------------------------------
# (d) the engine's surfaces in fast and bf16
# ----------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["fast", "bf16"])
def test_engine_chunked_runs_equal_one_run(case, prec):
    kw = dict(compute_dtype=DTYPES[prec], fast_math=prec == "fast")
    eng = port_engine(case, **kw)
    eng.set_inputs(case["cond"], case["sel"])
    y = eng.run(T, B)
    parts = [eng.run_partial(t0, min(7, T - t0), B) for t0 in range(0, T, 7)]
    assert np.array_equal(np.concatenate(parts, 1), y)
    assert eng._ring.dtype == tsg.ring_dtype(prec)
    # the plain generator of the same precision, called directly
    gen = tper.make_persistent_generator(PCFG, B, **kw)
    y_gen = gen(case["tp"], 0, cond_pre(case),
                torch.from_numpy(case["sel"]), *fresh(prec))[0]
    assert np.array_equal(y_gen.numpy().T, y)


@pytest.mark.parametrize("prec", ["fast", "bf16"])
def test_engine_ragged_rows_and_snapshot(case, prec):
    """A ragged feed's rows equal the rows generated alone; a snapshot taken
    mid-desync resumes exactly in a fresh engine, the ring keeping its
    dtype."""
    kw = dict(compute_dtype=DTYPES[prec], fast_math=prec == "fast")
    cond, sel = case["cond"], case["sel"]
    lens = np.array([16, 5, 0, 11, 16, 2, 9, 13])

    def serve(migrate):
        eng = port_engine(case, **kw)
        eng.begin_stream(B)
        y1 = eng.feed(cond[:16], sel[:16], lengths=lens)
        if migrate:
            snap = eng.export_state()
            assert snap["ring"].dtype == np.float32
            eng = port_engine(case, **kw)
            eng.import_state(snap)
            assert eng._ring.dtype == tsg.ring_dtype(prec)
        # desynced rows, no lengths: each row from its own clock
        y2 = eng.feed(np.stack([cond[n:n + 8, :, b] for b, n in
                                enumerate(lens)], 2),
                      np.stack([sel[n:n + 8, b] for b, n in
                                enumerate(lens)], 1))
        return y1, y2, eng.export_state()["ring"]

    (y1, y2, ring), (m1, m2, mring) = serve(False), serve(True)
    assert np.array_equal(y1, m1) and np.array_equal(y2, m2)
    assert np.array_equal(ring, mring)
    for b in (0, 1, 3):
        alone = port_engine(case, batch=1, **kw)
        alone.begin_stream(1)
        n = lens[b] + 8
        y_b = alone.feed(cond[:n, :, b:b + 1], sel[:n, b:b + 1])[0]
        assert np.array_equal(y_b[:lens[b]], y1[b, :lens[b]])
        assert np.array_equal(y_b[lens[b]:], y2[b])


def test_latency_tier_slot_handover(case):
    """priority="latency": lockstep feeds on K6, then a slot reset and a
    desynced feed, which runs on K5's step with fast_math; the reset row
    is its utterance generated alone from clock 0 in the same precision."""
    cond, sel = case["cond"], case["sel"]
    eng = port_engine(case, priority="latency")
    eng.begin_stream(B)
    eng.feed(cond[:12], sel[:12])
    eng.reset_utterances([2])
    y = eng.feed(cond[12:20], sel[12:20])
    assert y.shape == (B, 8)
    assert ("exact" not in {k[-1] for k in eng._gens}
            and (B, "sample", False, True, "fast") in eng._gens)
    alone = port_engine(case, batch=1, fast_math=True)
    alone.begin_stream(1)
    assert np.array_equal(alone.feed(cond[12:20, :, 2:3],
                                     sel[12:20, 2:3])[0], y[2])
