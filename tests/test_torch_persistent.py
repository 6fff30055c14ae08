"""The port's `make_persistent_generator` on the CPU (the plain version of
kernel K1) against the JAX persistent kernel run in interpret mode, as
tests/test_persistent_kernel.py runs it: exact y and y_state, the FIFO ring
within the xt ladder (1e-2, atol 3e-4) after unpacking the JAX kernel's
lane-packed ring, and the dumps within the reference ladder."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import persistent as tper

from tests.test_golden_vs_scan import make_case, rel_close
from tests.test_persistent_kernel import CONFIGS, run_kernel


def port_cfg(cfg):
    return tcfg.WaveNetConfig(num_layers=cfg.num_layers, R=cfg.R, S=cfg.S,
                              A=cfg.A, max_dilation=cfg.max_dilation,
                              tanh_embed=cfg.tanh_embed)


def unpack_ring(cfg, packed):
    """JAX lane-packed ring [rows, B, pack*R] -> the plain [ring_size, B, R]
    layout of `ring_offsets`."""
    packed = np.asarray(packed)
    _, _, row_offs, lane_slots = cfg.packed_ring_plan()
    out = np.zeros((cfg.ring_size, packed.shape[1], cfg.R), packed.dtype)
    for l, (off, d) in enumerate(zip(cfg.ring_offsets, cfg.dilations)):
        q = lane_slots[l] * cfg.R
        out[off:off + d] = packed[row_offs[l]:row_offs[l] + d, :, q:q + cfg.R]
    return out


class PortRun:
    """The port's generator over numpy inputs, with cond_pre = cond + dil_b
    folded as the engine folds it."""

    def __init__(self, cfg, ref_w, batch, mode="sample", dump=False):
        self.cfg = port_cfg(cfg)
        self.params = tparams.canonical_to_torch(
            params_lib.to_canonical(ref_w, cfg), "cpu")
        self.gen = tper.make_persistent_generator(self.cfg, batch, mode=mode,
                                                  dump=dump)
        self.ring = tper.init_ring(self.cfg, batch, "cpu")
        self.y_state = torch.full((2, batch), self.cfg.silence_bin,
                                  dtype=torch.int32)

    def __call__(self, cond, sel, t0=0, n_valid=None):
        cond_pre = (torch.from_numpy(cond)
                    + self.params["dil_b"][None, :, None, :]).contiguous()
        out = self.gen(self.params, t0, cond_pre, torch.from_numpy(sel),
                       self.ring, self.y_state, n_valid)
        return out[0].numpy().T, out[3:]


@pytest.mark.parametrize("cfg,batch,samples,chunk", CONFIGS)
def test_plain_matches_jax_interpret_kernel(cfg, batch, samples, chunk):
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=11)
    params = params_lib.to_canonical(ref_w, cfg)
    y_j, ring_j, ys_j, dumps_j = run_kernel(cfg, params, cond, sel, batch,
                                            chunk, dump=True)

    port = PortRun(cfg, ref_w, batch, dump=True)
    launches = tper.PERSISTENT_KERNEL.launches
    y, dumps = port(cond, sel)
    assert tper.PERSISTENT_KERNEL.launches == launches   # CPU: no kernel
    assert np.array_equal(y_j, y)
    assert np.array_equal(np.asarray(ys_j), port.y_state.numpy())
    assert rel_close(unpack_ring(cfg, ring_j), port.ring.numpy(), 1e-2,
                     atol=3e-4)
    xt_j, skip_j, zs_j, za_j, p_j = [np.asarray(d) for d in dumps_j]
    xt, skip, zs, za, p = [d.numpy() for d in dumps]
    assert rel_close(xt_j, xt, 1e-2, atol=3e-4)
    assert rel_close(skip_j, skip, 1e-2, atol=3e-4)
    assert rel_close(zs_j, zs, 1e-4, atol=2e-5)
    assert rel_close(za_j, za, 1e-4, atol=2e-5)
    assert rel_close(p_j, p, 1e-3)


def test_argmax_matches_jax_interpret_kernel():
    cfg = WaveNetConfig(num_layers=8, R=32, S=128, A=256, max_dilation=8)
    ref_w, cond, sel = make_case(cfg, 2, 8, seed=5)
    y_j, _, ys_j, _ = run_kernel(cfg, params_lib.to_canonical(ref_w, cfg),
                                 cond, sel, 2, 4, mode="argmax")
    port = PortRun(cfg, ref_w, 2, mode="argmax")
    y, _ = port(cond, sel)
    assert np.array_equal(y_j, y)
    assert np.array_equal(np.asarray(ys_j), port.y_state.numpy())


def test_state_carries_across_calls():
    """Two calls with the carried ring/y_state and an absolute t0 equal one
    call, and equal the JAX kernel's chunked run."""
    cfg = WaveNetConfig(num_layers=8, R=32, S=128, A=256, max_dilation=4)
    ref_w, cond, sel = make_case(cfg, 2, 12, seed=9)
    y_full, _ = PortRun(cfg, ref_w, 2)(cond, sel)

    port = PortRun(cfg, ref_w, 2)
    y1, _ = port(cond[:8], sel[:8])
    y2, _ = port(cond[8:], sel[8:], t0=8)
    assert np.array_equal(y_full, np.concatenate([y1, y2], axis=1))

    y_j, _, _, _ = run_kernel(cfg, params_lib.to_canonical(ref_w, cfg), cond,
                              sel, 2, 4)
    assert np.array_equal(y_j, y_full)


def test_steps_past_n_valid_leave_state_untouched():
    """The 7-of-8 contract: a call told n_valid=7 of 8 emits 0 for the last
    step and leaves the ring and y_state as a 7-step call does."""
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=8)
    ref_w, cond, sel = make_case(cfg, 2, 8, seed=4)
    short = PortRun(cfg, ref_w, 2)
    y7, _ = short(cond[:7], sel[:7])
    padded = PortRun(cfg, ref_w, 2)
    y8, _ = padded(cond, sel, n_valid=7)
    assert np.array_equal(y8[:, :7], y7) and not y8[:, 7].any()
    assert torch.equal(short.ring, padded.ring)
    assert torch.equal(short.y_state, padded.y_state)


@pytest.mark.parametrize("num_layers,max_dilation", [(20, 512), (8, 4), (6, 8)])
def test_fifo_schedule_is_the_ring_layout(num_layers, max_dilation):
    """The [2, L] array K1 addresses its FIFOs by holds the JAX package's
    ring offsets and dilations, so the kernel and the plain loop share one
    layout."""
    cfg = WaveNetConfig(num_layers=num_layers, R=32, S=128, A=256,
                        max_dilation=max_dilation)
    sched = tper.fifo_schedule(port_cfg(cfg), "cpu")
    assert sched.dtype == torch.int32 and sched.is_contiguous()
    assert sched.tolist() == [list(cfg.ring_offsets), list(cfg.dilations)]


def test_unported_options_raise_and_bad_inputs_are_rejected():
    cfg = port_cfg(WaveNetConfig(num_layers=2, R=32, S=128, A=256,
                                 max_dilation=2))
    for kw, kernel in ((dict(mode="forced"), "K2"), (dict(mode="prng"), "K3"),
                       (dict(stream_weights=True), "K4"),
                       (dict(stream_quant=True), "K4"),
                       (dict(ragged=True), "K5")):
        with pytest.raises(NotImplementedError, match=kernel):
            tper.make_persistent_generator(cfg, 1, **kw)

    ref_w = tparams.random_reference_weights(cfg, seed=0)
    params = tparams.canonical_to_torch(tparams.to_canonical(ref_w, cfg),
                                        "cpu")
    gen = tper.make_persistent_generator(cfg, 1)
    ring = tper.init_ring(cfg, 1, "cpu")
    ys = torch.full((2, 1), 128, dtype=torch.int32)
    cond = torch.zeros((4, 2, 1, 64))
    sel = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="cond_pre"):
        gen(params, 0, cond.double(), sel, ring, ys)
    with pytest.raises(ValueError, match="sel"):
        gen(params, 0, cond, torch.zeros((4, 2)), ring, ys)
    with pytest.raises(ValueError, match="ring"):
        gen(params, 0, cond, sel, ring.transpose(1, 2), ys)
    with pytest.raises(ValueError, match="y_state"):
        gen(params, 0, cond, sel, ring, ys.long())
    with pytest.raises(ValueError, match="n_valid"):
        gen(params, 0, cond, sel, ring, ys, n_valid=5)
