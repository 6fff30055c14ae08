"""The port's plain step generator (`ops/scan_generate.py`, the plain version
of kernel K1) against the numpy golden model and the JAX scan generator:
exact integer samples, and the reference's activation ladder on the
last-step dumps (xt/skip 1e-2 with atol 3e-4, zs/za 1e-4 with atol 2e-5,
p 1e-3), as tests/test_golden_vs_scan.py holds the JAX scan."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu.ops import scan_generate as jsg
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import scan_generate as tsg

from tests.test_golden_vs_scan import CONFIGS, make_case, rel_close


def port_cfg(cfg):
    return tcfg.WaveNetConfig(num_layers=cfg.num_layers, R=cfg.R, S=cfg.S,
                              A=cfg.A, max_dilation=cfg.max_dilation,
                              tanh_embed=cfg.tanh_embed)


def port_generate(cfg, ref_w, cond, sel, mode="sample", dump=False):
    params = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, cfg),
                                        "cpu")
    state = tsg.init_state(port_cfg(cfg), sel.shape[1], "cpu")
    state, y, aux = tsg.generate(params, state, torch.from_numpy(cond),
                                 torch.from_numpy(sel), port_cfg(cfg),
                                 mode=mode, dump=dump)
    return state, y.numpy(), aux


def golden_run(cfg, ref_w, cond, sel, mode="sample"):
    T, _, B, _ = cond.shape
    golden = WaveNetGolden(cfg, max_batch=B, max_samples=T)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    return golden, golden.run(T, B, mode=mode)


def assert_ladder(golden, aux, L):
    for l in range(L):
        assert rel_close(golden.get_xt_out(l), aux["xt"][l].numpy(), 1e-2,
                         atol=3e-4)
        assert rel_close(golden.get_skip_out(l), aux["skip"][l].numpy(), 1e-2,
                         atol=3e-4)
    assert rel_close(golden.get_zs(), aux["zs"].numpy(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_za(), aux["za"].numpy(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_p(), aux["p"].numpy(), 1e-3)


@pytest.mark.parametrize("cfg,batch,samples", CONFIGS)
def test_plain_matches_golden_and_jax_scan(cfg, batch, samples):
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=42)
    golden, y_gold = golden_run(cfg, ref_w, cond, sel)
    state, y, aux = port_generate(cfg, ref_w, cond, sel, dump=True)
    assert np.array_equal(y_gold, y)
    assert_ladder(golden, aux, cfg.num_layers)
    assert state.t == samples
    assert np.array_equal(state.y_cur.numpy(), y[:, -1])

    params = params_lib.to_canonical(ref_w, cfg)
    jstate, y_scan, jaux = jsg.generate(params, jsg.init_state(cfg, batch),
                                        cond, sel, cfg, dump=True)
    assert np.array_equal(np.asarray(y_scan), y)
    # the FIFO ring has the same [ring_size, B, R] layout in both
    assert rel_close(np.asarray(jstate.ring), state.ring.numpy(), 1e-2,
                     atol=3e-4)
    assert rel_close(np.asarray(jaux["za"]), aux["za"].numpy(), 1e-4,
                     atol=2e-5)


def test_argmax_matches_golden():
    cfg = WaveNetConfig(num_layers=8, R=32, S=128, A=256, max_dilation=8)
    ref_w, cond, sel = make_case(cfg, 2, 10, seed=7)
    _, y_gold = golden_run(cfg, ref_w, cond, sel, mode="argmax")
    _, y, _ = port_generate(cfg, ref_w, cond, sel, mode="argmax")
    assert np.array_equal(y_gold, y)


def test_chunked_7_7_1_matches_full_run():
    cfg = WaveNetConfig(num_layers=10, R=32, S=128, A=256, max_dilation=8)
    ref_w, cond, sel = make_case(cfg, 2, 15, seed=3)
    _, y_full, _ = port_generate(cfg, ref_w, cond, sel)

    params = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, cfg),
                                        "cpu")
    state = tsg.init_state(port_cfg(cfg), 2, "cpu")
    ys = []
    for lo, hi in [(0, 7), (7, 14), (14, 15)]:
        state, y, _ = tsg.generate(params, state,
                                   torch.from_numpy(cond[lo:hi]),
                                   torch.from_numpy(sel[lo:hi]),
                                   port_cfg(cfg))
        ys.append(y.numpy())
    assert np.array_equal(y_full, np.concatenate(ys, axis=1))


def test_wavenet_step_and_embed_lookup_match_jax():
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    ref_w, cond, sel = make_case(cfg, 3, 1, seed=13)
    params = params_lib.to_canonical(ref_w, cfg)
    tp = tparams.canonical_to_torch(params, "cpu")
    y_prev = np.array([1, 128, 255], np.int32)
    y_cur = np.array([0, 7, 128], np.int32)
    x_j = np.asarray(jsg.embed_lookup(params["embed"], y_prev, y_cur, cfg.A,
                                      True))
    x_t = tsg.embed_lookup(tp["embed"], torch.from_numpy(y_prev),
                           torch.from_numpy(y_cur), cfg.A, True)
    assert np.array_equal(x_j.view(np.int32), x_t.numpy().view(np.int32))

    jst, jy, jaux = jsg.wavenet_step(params, jsg.init_state(cfg, 3), cond[0],
                                     sel[0], cfg)
    tst, ty, taux = tsg.wavenet_step(tp, tsg.init_state(port_cfg(cfg), 3,
                                                        "cpu"),
                                     torch.from_numpy(cond[0]),
                                     torch.from_numpy(sel[0]), port_cfg(cfg))
    assert np.array_equal(np.asarray(jy), ty.numpy())
    assert tst.t == 1 and np.array_equal(tst.y_cur.numpy(), ty.numpy())
    for k in ("xt", "skip", "zs", "za", "p"):
        assert rel_close(np.asarray(jaux[k]), taux[k].numpy(), 1e-4,
                         atol=2e-5), k


def test_unported_modes_raise():
    cfg = WaveNetConfig(num_layers=2, R=32, S=128, A=256, max_dilation=2)
    ref_w, cond, sel = make_case(cfg, 1, 2, seed=1)
    for mode in ("prng", "forced"):
        with pytest.raises(NotImplementedError):
            port_generate(cfg, ref_w, cond, sel, mode=mode)


def test_horizon_65536_draws_exact():
    """The 65,536-draw horizon case of tests/test_golden_vs_scan.py: the
    bit-identical library keeps the port's integer samples equal to the
    golden model's at any horizon; any flip is a regression."""
    cfg = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4)
    B, T = 16, 4096
    rng = np.random.RandomState(123)
    ref_w = params_lib.random_reference_weights(cfg, seed=321)
    cond = rng.uniform(-0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R)
                       ).astype(np.float32)
    sel = rng.uniform(0, 1, (T, B)).astype(np.float32)
    _, y_gold = golden_run(cfg, ref_w, cond, sel)
    _, y, _ = port_generate(cfg, ref_w, cond, sel)
    n_mismatch = int(np.sum(y != y_gold))
    assert n_mismatch == 0, f"{n_mismatch}/{T * B} port-vs-golden mismatches"
