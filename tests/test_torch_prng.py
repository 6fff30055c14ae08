"""Mode "prng" of the port (kernel K3 and its plain version) on the CPU.

The TPU kernel draws its selectors from the TPU's hardware PRNG, whose bits
no other machine gives, so the port is held to the contract of the draws,
not to their bits (ROADMAP.md, K3): Philox4x32-10 with the Random123 known
answers; the plain K3 is the plain K1 (and the golden model) fed the
selectors of `prng_uniform_sel`, exactly; draws keyed on the absolute clock
do not depend on chunking (tests/test_engine.py:285-303), for `run_partial`
and for lockstep `feed`; seeds differ, and seed s at t+1 is not seed s+1 at
t (the TPU kernel's `seed + t` aliases them, fault R8); and 10^5 uniforms
pass a Kolmogorov-Smirnov test against U[0, 1)."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
from nv_wavenet_tpu_torch.models import params as tparams
from nv_wavenet_tpu_torch.ops import persistent as tper
from nv_wavenet_tpu_torch.ops import scan_generate as tsg

from tests.test_golden_vs_scan import make_case
from tests.test_torch_persistent import port_cfg

CFG = WaveNetConfig(num_layers=4, R=32, S=128, A=256, max_dilation=4)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    assert tuple(int(w) for w in tsg.philox4x32(ctr, key)) == want


def test_prng_uniform_sel_is_philox_word0():
    """Counter (t_lo, t_hi, row, 0), key (seed_lo, seed_hi), top 24 bits of
    word 0 times 2^-24; an int t gives [B], an array [len(t), B]."""
    seed, B = 0x0123456789ABCDEF, 5
    ts = np.array([0, 1, 77, (1 << 32) + 3, (1 << 40) + 1], np.uint64)
    sel = tsg.prng_uniform_sel(seed, ts, B)
    assert sel.shape == (len(ts), B) and sel.dtype == np.float32
    for i, t in enumerate(ts):
        for b in range(B):
            w0 = int(tsg.philox4x32(
                (int(t) & 0xFFFFFFFF, int(t) >> 32, b, 0),
                (seed & 0xFFFFFFFF, seed >> 32))[0])
            assert sel[i, b] == np.float32((w0 >> 8) * 2.0 ** -24)
    assert np.array_equal(tsg.prng_uniform_sel(seed, 77, B), sel[2])
    # the high words of t and of the seed take part
    assert not np.array_equal(sel[0], tsg.prng_uniform_sel(seed, 1 << 32, B))
    assert not np.array_equal(tsg.prng_uniform_sel(1, 0, B),
                              tsg.prng_uniform_sel(1 + (1 << 32), 0, B))
    # a negative seed is its 64-bit two's complement
    assert np.array_equal(tsg.prng_uniform_sel(-1, 3, B),
                          tsg.prng_uniform_sel((1 << 64) - 1, 3, B))


def plain_gen(mode, B):
    return tper.make_persistent_generator(port_cfg(CFG), B, mode=mode)


def test_prng_run_is_the_sample_run_fed_philox_selectors():
    """The plain K3 from t0 = 3 equals the plain K1 and the golden model fed
    prng_uniform_sel(seed, 3 .., B), sample for sample."""
    B, T, t0, seed = 3, 12, 3, 99
    ref_w, cond, _ = make_case(CFG, B, t0 + T, seed=17)
    pt = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, CFG),
                                    "cpu")
    cond_pre = (torch.from_numpy(cond)
                + pt["dil_b"][None, :, None, :]).contiguous()
    sel = tsg.prng_uniform_sel(seed, np.arange(t0 + T), B)

    def run(mode, s):
        ring = tper.init_ring(port_cfg(CFG), B, "cpu")
        ys = torch.full((2, B), CFG.silence_bin, dtype=torch.int32)
        gen = plain_gen("sample", B)
        gen(pt, 0, cond_pre[:t0].contiguous(), torch.from_numpy(sel[:t0]),
            ring, ys)
        gen = plain_gen(mode, B)
        kernel = gen.route.cuda_kernel("exact")
        launches = kernel.launches
        y = gen(pt, t0, cond_pre[t0:].contiguous(), torch.from_numpy(s), ring,
                ys, seed=seed)[0]
        assert kernel.launches == launches  # no kernel
        return y.numpy()

    y_prng = run("prng", np.zeros((T, B), np.float32))
    assert np.array_equal(y_prng, run("sample", sel[t0:]))
    golden = WaveNetGolden(CFG, max_batch=B, max_samples=t0 + T)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    assert np.array_equal(golden.run(t0 + T, B)[:, t0:], y_prng.T)


def test_wavenet_step_prng_is_sample_with_philox_selectors():
    """One scan step in mode "prng" draws prng_uniform_sel(seed, state.t)."""
    B, seed = 3, 41
    ref_w, cond, sel = make_case(CFG, B, 2, seed=19)
    pt = tparams.canonical_to_torch(params_lib.to_canonical(ref_w, CFG),
                                    "cpu")
    states = {m: tsg.init_state(port_cfg(CFG), B, "cpu")
              for m in ("prng", "sample")}
    for t in range(2):
        ys = {}
        for mode, st in states.items():
            s_t = (torch.from_numpy(sel[t]) if mode == "prng" else
                   torch.from_numpy(tsg.prng_uniform_sel(seed, t, B)))
            states[mode], ys[mode], _ = tsg.wavenet_step(
                pt, st, torch.from_numpy(cond[t]), s_t, port_cfg(CFG), mode,
                seed=seed)
        assert torch.equal(ys["prng"], ys["sample"])


def engine(B, ref_w, seed=0):
    eng = WaveNetInfer(num_layers=CFG.num_layers,
                       max_dilation=CFG.max_dilation, R=CFG.R, S=CFG.S,
                       A=CFG.A, max_batch=B, chunk_size=4, device="cpu")
    eng.set_reference_weights(ref_w)
    eng.sampling_seed = seed
    return eng


def test_prng_chunk_invariance_run_partial_and_feed():
    """tests/test_engine.py::test_manyblock_prng_mode_chunk_invariant on the
    port: chunked run_partial calls (and chunk_size-4 launches) equal one
    full run, lockstep feeds of any chunking equal it too, and another
    sampling_seed gives another stream."""
    B, T = 2, 14
    ref_w, cond, _ = make_case(CFG, B, T, seed=37)
    eng = engine(B, ref_w, seed=7)
    eng.set_inputs(cond)
    y_full = eng.run(T, B, mode="prng")
    parts = [eng.run_partial(0, 5, B, mode="prng"),
             eng.run_partial(5, 1, B, mode="prng"),
             eng.run_partial(6, T - 6, B, mode="prng")]
    assert np.array_equal(y_full, np.concatenate(parts, axis=1))
    chunks = []
    eng.run_chunks(3, lambda yc, off, n: chunks.append(yc), T, B, mode="prng")
    assert np.array_equal(y_full, np.concatenate(chunks, axis=1))
    for sizes in ((T,), (5, 1, 8), (1,) * T):
        eng.begin_stream(B)
        ys, off = [], 0
        for n in sizes:
            ys.append(eng.feed(cond[off:off + n], mode="prng"))
            off += n
        assert np.array_equal(y_full, np.concatenate(ys, axis=1))
    other = engine(B, ref_w, seed=8)
    other.set_inputs(cond)
    assert not np.array_equal(y_full, other.run(T, B, mode="prng"))


def test_seeds_differ_and_do_not_alias_r8():
    """Different seeds draw different streams, and seed s at t+1 is not
    seed s+1 at t, where the TPU kernel's seed + t makes them equal (R8)."""
    B, T = 4, 256
    ts = np.arange(T)
    for s in (0, 1, 12345):
        a = tsg.prng_uniform_sel(s, ts + 1, B)
        b = tsg.prng_uniform_sel(s + 1, ts, B)
        assert not np.any(a == b)
        assert not np.any(tsg.prng_uniform_sel(s, ts, B) == b)
    # rows and steps differ from each other too
    u = tsg.prng_uniform_sel(3, ts, B)
    assert len(np.unique(u)) == u.size


def test_prng_uniformity_ks():
    """10^5 uniforms (12,500 steps x 8 rows) against U[0, 1): the
    Kolmogorov-Smirnov statistic is below its 1% critical value
    1.628 / sqrt(n), the mean and variance are 1/2 and 1/12 within 4
    standard errors, and every value lies on the 2^-24 grid in [0, 1)."""
    u = np.sort(tsg.prng_uniform_sel(2024, np.arange(12500), 8).ravel()
                ).astype(np.float64)
    n = u.size
    assert n == 100_000 and u.min() >= 0 and u.max() < 1
    assert np.all(u * 2.0 ** 24 == np.floor(u * 2.0 ** 24))
    i = np.arange(1, n + 1)
    ks = max(np.max(i / n - u), np.max(u - (i - 1) / n))
    assert ks < 1.628 / np.sqrt(n), ks
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) < 4 * np.sqrt(1 / 180 / n)
