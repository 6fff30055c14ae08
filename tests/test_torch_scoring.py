"""The port's scoring path on the CPU, against the JAX package on the same
numpy inputs from a seed: the plain forced kernel K2 (mode "forced" of
`make_persistent_generator`) against the JAX kernel in interpret mode and
the golden model; the scan's `forced_y`/`return_za`; the time-parallel
scorer, its committer and `bits_per_sample`; the three `scoring.*`
functions; `WaveNetInfer.score` -> `feed`; and the plain versions of the
scorer's kernels K7 (`ordered_matmul`) and K0c (`softmax_canonical`).

Tolerances: integers exact; p 1e-6 absolute and xt 1e-6
(tests/test_score_parallel.py:59, 155-157); logp 2e-5 and bits 1e-5
(tests/test_scoring.py:73-74); za 1e-4 with atol 2e-5 and the FIFO ring
1e-2 with atol 3e-4 (the reference ladder, tests/test_engine.py:57-64).
Where the port compares with itself (chunking, handoff, committer) the
plain versions run the same row-wise ops, so the results are bit-equal.

Configs: WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
(tests/test_score_parallel.py:20) and a 4-layer one
(tests/test_scoring.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu.ops import exact_math as jem
from nv_wavenet_tpu.ops import persistent as jper
from nv_wavenet_tpu.ops import scan_generate as jsg
from nv_wavenet_tpu.ops import score_parallel as jsp
from nv_wavenet_tpu.ops import scoring as jscoring
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import exact_math as tem
from nv_wavenet_tpu_torch.ops import ordered_matmul as tom
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg
from nv_wavenet_tpu_torch.ops import score_parallel as tsp
from nv_wavenet_tpu_torch.ops import scoring as tscoring

from tests.test_golden_vs_scan import rel_close
from tests.test_torch_persistent import port_cfg, unpack_ring

CFG = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
CFG4 = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4)


def case(cfg, B, T, seed):
    """tests/test_score_parallel.py::case: weights at scale 1/sqrt(R),
    cond in [-1, 1], and the forced trajectory = the JAX scan's own free
    run.  Returns numpy canonical params too."""
    rng = np.random.RandomState(seed)
    ref_w = params_lib.random_reference_weights(
        cfg, seed=seed, scale=1.0 / np.sqrt(cfg.R))
    canon = params_lib.to_canonical(ref_w, cfg)
    cond = rng.uniform(-1, 1, (T, cfg.num_layers, B, 2 * cfg.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)
    pj = {k: jnp.asarray(v) for k, v in canon.items()}
    _, y, _ = jsg.generate(pj, jsg.init_state(cfg, B), jnp.asarray(cond),
                           jnp.asarray(sel), cfg)
    forced = np.ascontiguousarray(np.asarray(y).T, np.int32)   # [T, B]
    return canon, ref_w, cond, sel, forced


def torch_params(canon):
    return tparams.canonical_to_torch(canon, "cpu")


def port_state(cfg, B):
    return (tper.init_ring(port_cfg(cfg), B, "cpu"),
            torch.full((2, B), cfg.silence_bin, dtype=torch.int32))


def jax_state(cfg, B):
    return jper.init_ring(cfg, B), jnp.full((2, B), cfg.silence_bin, jnp.int32)


def golden_p_seq(cfg, ref_w, cond, sel, forced):
    T, _, B, _ = cond.shape
    g = WaveNetGolden(cfg, B, T)
    g.set_reference_weights(ref_w)
    g.set_inputs(cond, sel)
    g.run(T, B, mode="forced", forced_y=forced.T)
    return g.get_p_seq(), g


# ----------------------------------------------------------------------
# the plain K2 against the JAX forced kernel and the golden model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def forced_case():
    """One forced window through the JAX kernel in interpret mode (with the
    dump) and the golden model, shared by the K2 tests."""
    B, T = 3, 16
    canon, ref_w, cond, sel, forced = case(CFG, B, T, seed=23)
    gen = jper.make_persistent_generator(CFG, B, 8, mode="forced", dump=True,
                                         interpret=True)
    ring, ys = jax_state(CFG, B)
    out = gen({k: jnp.asarray(v) for k, v in canon.items()}, np.array([0]),
              jnp.asarray(cond), jnp.asarray(forced.astype(np.float32)),
              ring, ys, n_valid=T)
    jax_out = [np.asarray(o) for o in out]
    p_gold, g = golden_p_seq(CFG, ref_w, cond, sel, forced)
    return canon, cond, forced, jax_out, p_gold, g


@pytest.mark.parametrize("dump", [False, True])
def test_plain_forced_matches_jax_interpret_kernel_and_golden(forced_case,
                                                              dump):
    canon, cond, forced, jax_out, p_gold, g = forced_case
    y_j, ring_j, ys_j = jax_out[:3]
    p_j = jax_out[-1]
    B = forced.shape[1]
    pt = torch_params(canon)
    gen = tper.make_persistent_generator(port_cfg(CFG), B, mode="forced",
                                         dump=dump)
    ring, ys = port_state(CFG, B)
    cond_pre = (torch.from_numpy(cond) + pt["dil_b"][None, :, None, :])
    kernel = gen.route.cuda_kernel("exact")
    launches = kernel.launches
    out = gen(pt, 0, cond_pre.contiguous(),
              torch.from_numpy(forced.astype(np.float32)), ring, ys)
    assert kernel.launches == launches  # no kernel
    assert len(out) == (9 if dump else 4)
    y, p = out[0].numpy(), out[-1].numpy()
    assert np.array_equal(y, forced) and np.array_equal(y, y_j[:16])
    assert np.array_equal(ys.numpy(), ys_j)
    assert rel_close(unpack_ring(CFG, ring_j), ring.numpy(), 1e-2, atol=3e-4)
    np.testing.assert_allclose(p, p_j[:16], atol=1e-6, rtol=0)
    np.testing.assert_allclose(p, p_gold, atol=1e-6, rtol=0)
    if dump:
        xt, skip, zs, za, p_last = [d.numpy() for d in out[3:8]]
        for l in range(CFG.num_layers):
            assert rel_close(g.get_xt_out(l), xt[l], 1e-2, atol=3e-4)
            assert rel_close(g.get_skip_out(l), skip[l], 1e-2, atol=3e-4)
        assert rel_close(g.get_zs(), zs, 1e-4, atol=2e-5)
        assert rel_close(g.get_za(), za, 1e-4, atol=2e-5)
        assert np.array_equal(p_last, p[-1])


def test_plain_forced_n_valid_zeroes_the_tail():
    """p_seq rows past n_valid are zero and the state is a shorter call's."""
    B, T = 2, 8
    canon, _, cond, _, forced = case(CFG4, B, T, seed=3)
    pt = torch_params(canon)
    gen = tper.make_persistent_generator(port_cfg(CFG4), B, mode="forced")
    cond_pre = (torch.from_numpy(cond)
                + pt["dil_b"][None, :, None, :]).contiguous()
    sym = torch.from_numpy(forced.astype(np.float32))
    short, padded = port_state(CFG4, B), port_state(CFG4, B)
    y5, _, _, p5 = gen(pt, 0, cond_pre[:5].contiguous(), sym[:5].contiguous(),
                       *short)
    y8, _, _, p8 = gen(pt, 0, cond_pre, sym, *padded, n_valid=5)
    assert torch.equal(p8[:5], p5) and not p8[5:].any() and not y8[5:].any()
    assert torch.equal(short[0], padded[0]) and torch.equal(short[1],
                                                            padded[1])


# ----------------------------------------------------------------------
# the scan's forced_y / return_za
# ----------------------------------------------------------------------

def test_scan_forced_y_return_za_matches_jax_scan():
    B, T = 3, 12
    canon, _, cond, sel, forced = case(CFG, B, T, seed=13)
    # force another trajectory than the free run: a shifted one
    forced = (forced + 17) % CFG.A
    pj = {k: jnp.asarray(v) for k, v in canon.items()}
    st_j, y_j, za_j = jsg.generate(pj, jsg.init_state(CFG, B),
                                   jnp.asarray(cond), jnp.asarray(sel), CFG,
                                   forced_y=jnp.asarray(forced),
                                   return_za=True)
    st, y, za = tsg.generate(torch_params(canon),
                             tsg.init_state(port_cfg(CFG), B, "cpu"),
                             torch.from_numpy(cond), torch.from_numpy(sel),
                             port_cfg(CFG), forced_y=torch.from_numpy(forced),
                             return_za=True)
    assert np.array_equal(y.numpy(), forced.T)
    assert np.array_equal(np.asarray(y_j), y.numpy())
    assert za.shape == (T, B, CFG.A)
    assert rel_close(np.asarray(za_j), za.numpy(), 1e-4, atol=2e-5)
    assert rel_close(np.asarray(st_j.ring), st.ring.numpy(), 1e-2, atol=3e-4)
    assert np.array_equal(np.asarray(st_j.y_prev), st.y_prev.numpy())
    assert np.array_equal(np.asarray(st_j.y_cur), st.y_cur.numpy())
    assert st.t == T
    # wavenet_step's forced_y_t is the same teacher forcing, one step
    st1, y1, aux = tsg.wavenet_step(
        torch_params(canon), tsg.init_state(port_cfg(CFG), B, "cpu"),
        torch.from_numpy(cond[0]), torch.from_numpy(sel[0]), port_cfg(CFG),
        forced_y_t=torch.from_numpy(forced[0]))
    assert np.array_equal(y1.numpy(), forced[0])
    assert torch.equal(aux["za"], za[0])


# ----------------------------------------------------------------------
# the time-parallel scorer
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def scorer_case():
    """One window scored by the JAX scorer (return_xt and return_za)."""
    B, T = 4, 24
    canon, ref_w, cond, sel, forced = case(CFG, B, T, seed=11)
    scorer = jsp.make_parallel_scorer(CFG, B, return_xt=True, return_za=True)
    ring, ys = jax_state(CFG, B)
    out = scorer({k: jnp.asarray(v) for k, v in canon.items()},
                 np.array([0]), jnp.asarray(cond), jnp.asarray(forced), ring,
                 ys)
    return canon, ref_w, cond, sel, forced, [np.array(o) for o in out]


def port_score(canon, cond, forced, state=None, t0=0, n_valid=None, **kw):
    B = forced.shape[1]
    scorer = tsp.make_parallel_scorer(port_cfg(CFG), B, **kw)
    ring, ys = port_state(CFG, B) if state is None else state
    return scorer(torch_params(canon), t0, torch.from_numpy(cond),
                  torch.from_numpy(forced), ring, ys, n_valid)


def test_parallel_scorer_matches_jax_scorer_and_golden(scorer_case):
    canon, ref_w, cond, sel, forced, (p_j, ring_j, ys_j, xt_j, za_j) = \
        scorer_case
    launches = (tom.ORDERED_MATMUL_KERNEL.launches,
                tem.SOFTMAX_KERNEL.launches, tem.EXACT_FN_KERNEL.launches)
    p, ring, ys, xt, za = port_score(canon, cond, forced, return_xt=True,
                                     return_za=True)
    assert launches == (tom.ORDERED_MATMUL_KERNEL.launches,
                        tem.SOFTMAX_KERNEL.launches,
                        tem.EXACT_FN_KERNEL.launches)   # CPU: no kernel
    np.testing.assert_allclose(p.numpy(), p_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(xt.numpy(), xt_j, atol=1e-6, rtol=0)
    assert rel_close(za_j, za.numpy(), 1e-4, atol=2e-5)
    assert rel_close(unpack_ring(CFG, ring_j), ring.numpy(), 1e-2, atol=3e-4)
    assert np.array_equal(ys.numpy(), ys_j)
    p_gold, g = golden_p_seq(CFG, ref_w, cond, sel, forced)
    np.testing.assert_allclose(p.numpy(), p_gold, atol=1e-6, rtol=0)
    np.testing.assert_allclose(xt.numpy(), np.transpose(g._hist[:24],
                                                        (1, 0, 2, 3)),
                               atol=1e-6, rtol=0)


def test_chunked_scoring_equals_full_score(scorer_case):
    """Ragged chunks (3, 1, 9, 11: shorter than the largest dilation, t0 not
    aligned) with the carried state equal one full-window score, bit for
    bit."""
    canon, _, cond, _, forced, _ = scorer_case
    p_full, ring_full, ys_full = port_score(canon, cond, forced)
    state = port_state(CFG, forced.shape[1])
    parts, t0 = [], 0
    for n in (3, 1, 9, 11):
        parts.append(port_score(canon, cond[t0:t0 + n], forced[t0:t0 + n],
                                state, t0)[0])
        t0 += n
    assert torch.equal(torch.cat(parts), p_full)
    assert torch.equal(state[0], ring_full) and torch.equal(state[1], ys_full)


def test_score_then_generate_handoff(scorer_case):
    """The scorer's state continues generation exactly: score a prefix of
    the free run, generate the suffix from the scorer's state with the
    plain generator: the suffix equals the free run's."""
    canon, _, cond, sel, forced, _ = scorer_case
    B, T, T1 = forced.shape[1], forced.shape[0], 11
    state = port_state(CFG, B)
    port_score(canon, cond[:T1], forced[:T1], state)
    pt = torch_params(canon)
    gen = tper.make_persistent_generator(port_cfg(CFG), B)
    cond_pre = (torch.from_numpy(cond[T1:])
                + pt["dil_b"][None, :, None, :]).contiguous()
    y = gen(pt, T1, cond_pre, torch.from_numpy(sel[T1:]), *state)[0]
    assert np.array_equal(y.numpy(), forced[T1:])


@pytest.mark.parametrize("nv", [1, 7, 19])
def test_committer_equals_scorer_pass_with_n_valid(scorer_case, nv):
    """The committer's state from a window's xt equals a scorer pass with
    n_valid=nv, bit for bit, and the JAX committer's within the ladder."""
    canon, _, cond, _, forced, (_, _, _, xt_j, _) = scorer_case
    B = forced.shape[1]
    # a non-zero pre-window state: score the first 5 steps
    pre = port_state(CFG, B)
    port_score(canon, cond[:5], forced[:5], pre)
    t0, T = 5, 19
    want = (pre[0].clone(), pre[1].clone())
    port_score(canon, cond[t0:], forced[t0:], want, t0, n_valid=nv)
    draft = (pre[0].clone(), pre[1].clone())
    xt = port_score(canon, cond[t0:], forced[t0:], draft, t0,
                    return_xt=True)[3]
    got = tsp.make_state_committer(port_cfg(CFG))(
        pre[0].clone(), xt, torch.from_numpy(forced[t0:]), pre[1].clone(),
        t0, nv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert xt.shape == (CFG.num_layers + 1, T, B, CFG.R)
    if nv == T:   # the whole window: the full scorer's state
        assert torch.equal(got[0], draft[0]) and torch.equal(got[1], draft[1])
    ring_j, ys_j = jsp.make_state_committer(CFG)(
        jax_ring_from_plain(CFG, pre[0].numpy()), jnp.asarray(xt.numpy()),
        jnp.asarray(forced[t0:]), jnp.asarray(pre[1].numpy()), t0, nv)
    assert np.array_equal(np.asarray(ys_j), got[1].numpy())
    assert rel_close(unpack_ring(CFG, ring_j), got[0].numpy(), 1e-6,
                     atol=1e-7)


def jax_ring_from_plain(cfg, ring):
    """The port's plain [ring_size, B, R] ring -> the JAX lane-packed one
    (the inverse of unpack_ring)."""
    packed = np.zeros(np.asarray(jper.init_ring(cfg, ring.shape[1])).shape,
                      np.float32)
    _, _, row_offs, lane_slots = cfg.packed_ring_plan()
    for l, (off, d) in enumerate(zip(cfg.ring_offsets, cfg.dilations)):
        q = lane_slots[l] * cfg.R
        packed[row_offs[l]:row_offs[l] + d, :, q:q + cfg.R] = ring[off:off + d]
    return jnp.asarray(packed)


def test_bits_per_sample_matches_jax(scorer_case):
    _, _, _, _, forced, (p_j, *_) = scorer_case
    b_j = np.asarray(jsp.bits_per_sample(jnp.asarray(p_j),
                                         jnp.asarray(forced)))
    b = tsp.bits_per_sample(torch.from_numpy(p_j), torch.from_numpy(forced))
    assert b.shape == forced.shape
    np.testing.assert_allclose(b.numpy(), b_j, atol=1e-5, rtol=0)


def test_bits_per_sample_uniform_4_layers():
    """tests/test_score_parallel.py::test_bits_per_sample_uniform on the
    port: near-zero weights score random audio at ~log2(A) = 8 bits."""
    B, T = 2, 16
    ref_w = params_lib.random_reference_weights(CFG4, seed=1, scale=1e-3)
    rng = np.random.RandomState(0)
    cond = rng.uniform(-0.1, 0.1, (T, CFG4.num_layers, B, 2 * CFG4.R)
                       ).astype(np.float32)
    y = torch.from_numpy(rng.randint(0, CFG4.A, (T, B)).astype(np.int32))
    scorer = tsp.make_parallel_scorer(port_cfg(CFG4), B)
    p_seq = scorer(torch_params(params_lib.to_canonical(ref_w, CFG4)), 0,
                   torch.from_numpy(cond), y, *port_state(CFG4, B))[0]
    assert abs(float(tsp.bits_per_sample(p_seq, y).mean()) - 8.0) < 0.3


# ----------------------------------------------------------------------
# scoring.*
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def scoring_case():
    """tests/test_scoring.py::test_kernel_scorer_matches_scan_scorer's case
    through the three JAX scorers (the kernel one in interpret mode)."""
    B, T = 3, 21
    ref_w = params_lib.random_reference_weights(CFG4, seed=91)
    canon = params_lib.to_canonical(ref_w, CFG4)
    rng = np.random.RandomState(4)
    cond = rng.uniform(-0.5, 0.5, (T, CFG4.num_layers, B, 2 * CFG4.R)
                       ).astype(np.float32)
    audio = rng.randint(0, 256, size=(B, T)).astype(np.int32)
    pj = {k: jnp.asarray(v) for k, v in canon.items()}
    out = {
        "score_teacher_forced": jscoring.score_teacher_forced(
            pj, CFG4, jnp.asarray(cond), jnp.asarray(audio)),
        "score_teacher_forced_kernel": jscoring.score_teacher_forced_kernel(
            pj, CFG4, jnp.asarray(cond), audio, chunk=8, interpret=True),
        "score_teacher_forced_parallel":
            jscoring.score_teacher_forced_parallel(
                pj, CFG4, jnp.asarray(cond), jnp.asarray(audio)),
    }
    return canon, cond, audio, {k: [np.asarray(v) for v in o]
                                for k, o in out.items()}


@pytest.mark.parametrize("name", ["score_teacher_forced",
                                  "score_teacher_forced_kernel",
                                  "score_teacher_forced_parallel"])
def test_scoring_functions_match_jax(scoring_case, name):
    canon, cond, audio, jax_out = scoring_case
    logp_j, bits_j = jax_out[name]
    logp, bits = getattr(tscoring, name)(torch_params(canon), port_cfg(CFG4),
                                         cond, audio)
    if name == "score_teacher_forced_kernel":
        assert isinstance(logp, np.ndarray) and logp.dtype == np.float32
        # launches of 8 steps carrying the state give the same scores
        logp8, bits8 = tscoring.score_teacher_forced_kernel(
            torch_params(canon), port_cfg(CFG4), cond, audio, chunk=8)
        assert np.array_equal(logp8, logp) and np.array_equal(bits8, bits)
    else:
        assert isinstance(logp, torch.Tensor)
        logp, bits = logp.numpy(), bits.numpy()
    assert logp.shape == (3, 20) and bits.shape == (3,)
    np.testing.assert_allclose(logp, logp_j, atol=2e-5, rtol=0)
    np.testing.assert_allclose(bits, bits_j, atol=1e-5, rtol=0)
    # and against the JAX scan scorer, as tests/test_scoring.py holds them
    np.testing.assert_allclose(logp, jax_out["score_teacher_forced"][0],
                               atol=2e-5, rtol=0)


# ----------------------------------------------------------------------
# the engine: score -> feed
# ----------------------------------------------------------------------

def port_engine(cfg, B, ref_w, **kw):
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=8, device="cpu", **kw)
    eng.set_reference_weights(ref_w)
    return eng


def test_engine_score_then_feed_matches_jax_engine():
    """tests/test_score_parallel.py::test_engine_score_stream_and_handoff on
    the port and the JAX engine: `score` returns the forced distributions,
    advances every row clock and leaves the state generation would leave,
    so the next `feed` equals an all-feed stream."""
    B, T1, T2 = 2, 11, 13
    _, ref_w, cond, sel, forced = case(CFG, B, T1 + T2, seed=57)
    ys, ps = {}, {}
    jeng = jinfer.WaveNetInfer(num_layers=CFG.num_layers,
                               max_dilation=CFG.max_dilation, R=CFG.R,
                               S=CFG.S, A=CFG.A, max_batch=B,
                               implementation=jinfer.Impl.PERSISTENT,
                               chunk_size=8, interpret=True)
    jeng.set_reference_weights(ref_w)
    for name, eng in (("jax", jeng), ("port", port_engine(CFG, B, ref_w))):
        eng.begin_stream(B)
        y1 = eng.feed(cond[:T1], sel[:T1])
        y2 = eng.feed(cond[T1:], sel[T1:])
        assert np.array_equal(np.concatenate([y1, y2], 1).T, forced)
        eng.begin_stream(B)
        ps[name] = eng.score(cond[:T1], y1)                    # [B, T1, A]
        if name == "port":
            assert list(eng._stream_t_row) == [T1] * B
        ys[name] = eng.feed(cond[T1:], sel[T1:])
        assert np.array_equal(ys[name], y2)
    np.testing.assert_allclose(ps["port"], ps["jax"], atol=1e-6, rtol=0)
    p_gold, _ = golden_p_seq(CFG, ref_w, cond[:T1], sel[:T1], forced[:T1])
    np.testing.assert_allclose(np.transpose(ps["port"], (1, 0, 2)), p_gold,
                               atol=1e-6, rtol=0)


def test_engine_score_uses_tempered_params_and_checks_its_inputs():
    B, T = 2, 9
    _, ref_w, cond, sel, forced = case(CFG4, B, T, seed=7)
    eng = port_engine(CFG4, B, ref_w, temperature=2.0)
    with pytest.raises(RuntimeError, match="begin_stream"):
        eng.score(cond, forced.T)
    eng.begin_stream(B)
    p = eng.score_device(cond, torch.from_numpy(forced))
    # the tempered distribution: K2's plain version on the tempered params
    params = eng._device_params()
    gen = tper.make_persistent_generator(port_cfg(CFG4), B, mode="forced")
    cond_pre = (torch.from_numpy(cond)
                + params["dil_b"][None, :, None, :]).contiguous()
    p_k = gen(params, 0, cond_pre, torch.from_numpy(forced.astype(np.float32)),
              *port_state(CFG4, B))[-1]
    np.testing.assert_allclose(p.numpy(), p_k.numpy(), atol=1e-6, rtol=0)
    eng1 = port_engine(CFG4, B, ref_w)
    eng1.begin_stream(B)
    assert not np.allclose(eng1.score(cond, forced.T),
                           p.permute(1, 0, 2).numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="y_chunk"):
        eng.score(cond, forced)
    with pytest.raises(ValueError, match="cond_chunk"):
        eng.score(cond[:, :, :1], forced.T[:1])
    eng.reset_utterances([0])                       # desynced row clocks
    with pytest.raises(ValueError, match="clocks"):
        eng.score(cond, forced.T)
    for mode in ("forced", "prng"):                 # lockstep modes only
        with pytest.raises(ValueError, match="sample"):
            eng.feed(cond, forced.astype(np.float32), mode=mode)


def test_engine_forced_feed_echoes_and_advances():
    """A lockstep forced feed emits its symbols and carries the state as
    generating them would: a sample feed after it equals the all-sample
    stream."""
    B, T1, T2 = 2, 6, 7
    _, ref_w, cond, sel, forced = case(CFG4, B, T1 + T2, seed=9)
    eng = port_engine(CFG4, B, ref_w)
    eng.begin_stream(B)
    y1 = eng.feed(cond[:T1], forced[:T1].astype(np.float32), mode="forced")
    assert np.array_equal(y1, forced[:T1].T)
    assert np.array_equal(eng.feed(cond[T1:], sel[T1:]), forced[T1:].T)


# ----------------------------------------------------------------------
# the plain versions of K7 and K0c
# ----------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(37, 64, 50), (5, 256, 256), (3, 1, 7)])
def test_ordered_matmul_plain_is_k_ordered(M, K, N):
    """K7's plain version is the fixed-order sum from 0 over k, each
    product and sum rounded once to float32 (a numpy loop), and close to
    the float64 product."""
    rng = np.random.RandomState(M + K + N)
    x = rng.uniform(-1, 1, (M, K)).astype(np.float32)
    w = rng.uniform(-1, 1, (K, N)).astype(np.float32)
    want = np.zeros((M, N), np.float32)
    for k in range(K):
        want = want + x[:, k:k + 1] * w[k:k + 1, :]
    launches = tom.ORDERED_MATMUL_KERNEL.launches
    y = tom.ordered_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tom.ORDERED_MATMUL_KERNEL.launches == launches
    assert np.array_equal(y.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(y.numpy(), x.astype(np.float64) @ w, atol=1e-5)
    with pytest.raises(ValueError, match="shapes"):
        tom.ordered_matmul(torch.from_numpy(x), torch.from_numpy(w)[:-1])


def test_softmax_canonical_plain_matches_numpy_twin_and_jax():
    rng = np.random.RandomState(4)
    za = rng.uniform(-8, 8, (64, 256)).astype(np.float32)
    launches = tem.SOFTMAX_KERNEL.launches
    p = tem.softmax_canonical(torch.from_numpy(za)).numpy()
    assert tem.SOFTMAX_KERNEL.launches == launches
    want = jem.softmax_p_np(*jem.softmax_cumsum_np(za))
    assert np.array_equal(p.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(p, np.asarray(jper.softmax_canonical(
        jnp.asarray(za))), atol=1e-6, rtol=0)
    p3 = tem.softmax_canonical(torch.from_numpy(za.reshape(4, 16, 256)))
    assert np.array_equal(p3.numpy().reshape(64, 256), p)
