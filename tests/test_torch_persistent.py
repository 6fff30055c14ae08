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
    launches = tper.PERSISTENT_KERNELS["exact"].launches
    y, dumps = port(cond, sel)
    assert tper.PERSISTENT_KERNELS["exact"].launches == launches  # no kernel
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
    # K4's rules, the JAX package's: int8 stacks over fp32 storage only, no
    # ragged streaming; int8 without streaming is off, as there
    with pytest.raises(ValueError, match="stream_quant"):
        tper.make_persistent_generator(cfg, 1, stream_weights=True,
                                       stream_quant=True,
                                       weight_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stream_weights"):
        tper.make_persistent_generator(cfg, 1, ragged=True,
                                       stream_weights=True)
    for kw in (dict(stream_weights=True), dict(stream_quant=True),
               dict(weight_dtype=torch.bfloat16)):
        tper.make_persistent_generator(cfg, 1, **kw)
    with pytest.raises(ValueError, match="mode"):
        tper.make_persistent_generator(cfg, 1, mode="beam")
    # K5 (ragged=True) is ported for mode "sample" without dump, as the TPU
    # kernel's ragged variant allows: prng and forced stay lockstep
    for kw in (dict(mode="argmax"), dict(dump=True), dict(mode="prng"),
               dict(mode="forced")):
        with pytest.raises(ValueError, match="K5"):
            tper.make_persistent_generator(cfg, 1, ragged=True, **kw)

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
    # K2 takes symbols, integers in [0, A), in sel
    forced = tper.make_persistent_generator(cfg, 1, mode="forced")
    for bad in (sel + 0.5, sel + 256, sel - 1):
        with pytest.raises(ValueError, match="symbols"):
            forced(params, 0, cond, bad, ring, ys)
    assert torch.equal(forced(params, 0, cond, sel + 7, ring, ys)[0],
                       torch.full((4, 1), 7, dtype=torch.int32))

    ragged = tper.make_persistent_generator(cfg, 1, ragged=True)
    t0_row = torch.zeros(1, dtype=torch.int64)
    n_row = torch.full((1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_valid_row"):
        ragged(params, t0_row, cond, sel, ring, ys, n_row + 1)
    with pytest.raises(ValueError, match="n_valid_row"):
        ragged(params, t0_row, cond, sel, ring, ys, n_row.long())
    with pytest.raises(ValueError, match="t0_row"):
        ragged(params, t0_row - 1, cond, sel, ring, ys, n_row)
    with pytest.raises(ValueError, match="t0_row"):
        ragged(params, torch.zeros(2, dtype=torch.int64), cond, sel, ring,
               ys, n_row)
    with pytest.raises(ValueError, match="cond_pre"):
        ragged(params, t0_row, cond.double(), sel, ring, ys, n_row)


# ----------------------------------------------------------------------
# what a generator binds once (`bind`): the params, the ring, y_state, the
# device and its stream; what a call brings (cond_pre, sel, t0_row,
# n_valid_row) is checked on every call
# ----------------------------------------------------------------------

BIND_CFG = tcfg.WaveNetConfig(num_layers=2, R=32, S=128, A=256,
                              max_dilation=2)
BIND_B, BIND_T = 2, 4


def bind_case(fast_math=False):
    """(a ragged generator that has bound once, params, ring, y_state,
    cond_pre, sel, t0_row, n_valid_row)."""
    cfg = BIND_CFG
    ref_w = tparams.random_reference_weights(cfg, seed=0)
    params = tparams.canonical_to_torch(tparams.to_canonical(ref_w, cfg),
                                        "cpu")
    gen = tper.make_persistent_generator(cfg, BIND_B, ragged=True,
                                         fast_math=fast_math)
    ring = tper.init_ring(cfg, BIND_B, "cpu")
    ys = torch.full((2, BIND_B), cfg.silence_bin, dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    cond = torch.rand((BIND_T, 2, BIND_B, 64), generator=g) - 0.5
    sel = torch.rand((BIND_T, BIND_B), generator=g)
    t0_row = torch.tensor([0, 5], dtype=torch.int64)
    n_row = torch.tensor([BIND_T, 2], dtype=torch.int32)
    gen(params, t0_row, cond, sel, ring, ys, n_row)
    return gen, params, ring, ys, cond, sel, t0_row, n_row


# (what to pass in place of one argument, the ValueError's text): the
# wrapper's messages, unchanged
BAD_CALLS = {
    "cond_pre dtype": (lambda a: {"cond": a["cond"].double()},
                       "cond_pre: expected torch.float32 (4, 2, 2, 64), got "
                       "torch.float64 (4, 2, 2, 64)"),
    "cond_pre shape": (lambda a: {"cond": a["cond"][:, :1].contiguous()},
                       "cond_pre: expected torch.float32 (4, 2, 2, 64), got "
                       "torch.float32 (4, 1, 2, 64)"),
    "cond_pre strides": (lambda a: {"cond": a["cond"].transpose(2, 1)
                                    .contiguous().transpose(2, 1)},
                         "cond_pre: must be contiguous"),
    "sel shape": (lambda a: {"sel": torch.zeros((BIND_T, 3))},
                  "sel: expected torch.float32 (4, 2), got torch.float32 "
                  "(4, 3)"),
    "sel dtype": (lambda a: {"sel": a["sel"].double()},
                  "sel: expected torch.float32 (4, 2), got torch.float64 "
                  "(4, 2)"),
    "t0_row negative": (lambda a: {"t0": torch.tensor([0, -1])},
                        "t0_row [0, -1] must be >= 0"),
    "t0_row dtype": (lambda a: {"t0": a["t0"].int()},
                     "t0_row: expected torch.int64 (2,), got torch.int32 "
                     "(2,)"),
    "t0_row shape": (lambda a: {"t0": torch.zeros(3, dtype=torch.int64)},
                     "t0_row: expected torch.int64 (2,), got torch.int64 "
                     "(3,)"),
    "n_valid_row past T": (lambda a: {"n": torch.tensor([5, 0],
                                                        dtype=torch.int32)},
                           "n_valid_row [5, 0] outside [0, T=4]"),
    "n_valid_row negative": (lambda a: {"n": torch.tensor([1, -1],
                                                          dtype=torch.int32)},
                             "n_valid_row [1, -1] outside [0, T=4]"),
    "n_valid_row dtype": (lambda a: {"n": a["n"].long()},
                          "n_valid_row: expected torch.int32 (2,), got "
                          "torch.int64 (2,)"),
    "ring": (lambda a: {"ring": a["ring"].transpose(1, 2)},
             "ring: expected torch.float32 (3, 2, 32), got torch.float32 "
             "(3, 32, 2)"),
    "y_state": (lambda a: {"ys": a["ys"].long()},
                "y_state: expected torch.int32 (2, 2), got torch.int64 "
                "(2, 2)"),
    "params": (lambda a: {"params": {**a["params"],
                                     "end_b": a["params"]["end_b"][:-1]}},
               "end_b: expected torch.float32 (256,), got torch.float32 "
               "(255,)"),
}


@pytest.mark.parametrize("what", sorted(BAD_CALLS))
def test_a_bound_ragged_generator_still_checks_each_call(what):
    """After a call has bound, a wrong cond_pre, sel, t0_row or n_valid_row
    raises the same ValueError as before any binding; so does a wrong
    ring, y_state or params tensor, which binds anew.  A failed call leaves
    the binding as it was: the good arguments do not bind again."""
    from nv_wavenet_tpu_torch.utils import tracing
    gen, params, ring, ys, cond, sel, t0, n = bind_case()
    good = dict(params=params, ring=ring, ys=ys, cond=cond, sel=sel, t0=t0,
                n=n)
    change, text = BAD_CALLS[what]
    a = {**good, **change(good)}
    with pytest.raises(ValueError) as err:
        gen(a["params"], a["t0"], a["cond"], a["sel"], a["ring"], a["ys"],
            a["n"])
    assert str(err.value) == text
    binds = tracing.counters().get("k5.binds", 0)
    gen(params, t0, cond, sel, ring, ys, n)
    assert tracing.counters().get("k5.binds", 0) == binds


# each change, applied after a first bound call: (how, binds it adds)
BIND_CHANGES = {
    "nothing": 0,
    "params replaced": 1,
    "weight in place": 1,
    "new ring": 1,
    "new y_state": 1,
}


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("change", sorted(BIND_CHANGES))
def test_ragged_generator_binds_once_per_change(change, fast_math):
    """Repeated calls on the same state bind once; replacing a params
    tensor, changing a weight in place, or passing another ring or y_state
    object binds once more (`k5.binds`), and what follows equals a fresh
    generator's run on the same values (the storage, a rounded view under
    fast_math, is rebuilt after the in-place change)."""
    from nv_wavenet_tpu_torch.utils import tracing
    gen, params, ring, ys, cond, sel, t0, n = bind_case(fast_math)
    before = tracing.counters().get("k5.binds", 0)
    gen(params, t0, cond, sel, ring, ys, n)
    assert tracing.counters().get("k5.binds", 0) == before
    if change == "params replaced":
        params = {**params, "end_w": params["end_w"] * 1.5}
    elif change == "weight in place":
        params["end_w"].mul_(1.5)
    elif change == "new ring":
        ring = ring.clone()
    elif change == "new y_state":
        ys = ys.clone()
    fresh = tper.make_persistent_generator(BIND_CFG, BIND_B, ragged=True,
                                           fast_math=fast_math)
    ring_f, ys_f = ring.clone(), ys.clone()
    for _ in range(3):
        y = gen(params, t0, cond, sel, ring, ys, n)[0]
        y_f = fresh(params, t0, cond, sel, ring_f, ys_f, n)[0]
        assert torch.equal(y, y_f) and torch.equal(ys, ys_f)
        assert torch.equal(ring, ring_f)
    # the fresh generator's own first call binds once too
    assert (tracing.counters().get("k5.binds", 0) - before
            == BIND_CHANGES[change] + 1)
