"""The port's engine, `WaveNetInfer(device="cpu")`, against the numpy golden
model over the engine matrix of tests/test_engine.py (MANYBLOCK rows on the
plain version of the streaming kernel K4): exact integer samples through `run`,
`run_chunks` with ragged chunks, and the dump getters within the reference
ladder (xt/skip 1e-2 with atol 3e-4, zs/za 1e-4 with atol 2e-5, p 1e-3)."""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu.config import WaveNetConfig
from nv_wavenet_tpu.engine import wavenet_infer as jinfer
from nv_wavenet_tpu.models import params as params_lib
from nv_wavenet_tpu.models.golden import WaveNetGolden
from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
from nv_wavenet_tpu_torch.engine import wavenet_infer as tinfer
from nv_wavenet_tpu_torch.ops import persistent as tper

from tests.test_engine import MATRIX
from tests.test_golden_vs_scan import make_case, rel_close


def make_engine(cfg, batch, impl=Impl.AUTO, chunk=4):
    return WaveNetInfer(num_layers=cfg.num_layers,
                        max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                        A=cfg.A, max_batch=batch, implementation=impl,
                        chunk_size=chunk, device="cpu")


def golden_run(cfg, ref_w, cond, sel, batch, samples):
    golden = WaveNetGolden(cfg, max_batch=batch, max_samples=samples)
    golden.set_reference_weights(ref_w)
    golden.set_inputs(cond, sel)
    return golden, golden.run(samples, batch)


@pytest.mark.parametrize("cfg,impl,batch", MATRIX)
def test_engine_matches_golden(cfg, impl, batch):
    samples = 8
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=21)
    golden, y_gold = golden_run(cfg, ref_w, cond, sel, batch, samples)

    eng = make_engine(cfg, batch, Impl[impl.name])
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    kernels = (tper.PERSISTENT_KERNELS["exact"], tper.STREAM_KERNELS["exact"])
    launches = [k.launches for k in kernels]
    y = eng.run(samples, batch, dump_activations=True)
    assert [k.launches for k in kernels] == launches    # CPU: no kernel
    assert np.array_equal(y_gold, y)

    for l in range(cfg.num_layers):
        assert rel_close(golden.get_xt_out(l), eng.get_xt_out(l), 1e-2,
                         atol=3e-4)
        assert rel_close(golden.get_skip_out(l), eng.get_skip_out(l), 1e-2,
                         atol=3e-4)
    assert rel_close(golden.get_zs(), eng.get_zs(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_za(), eng.get_za(), 1e-4, atol=2e-5)
    assert rel_close(golden.get_p(), eng.get_p(), 1e-3)


def test_run_chunks_uneven_matches_golden():
    """chunk 7 against 8 samples: a ragged final chunk, as
    tests/test_engine.py::test_engine_uneven_chunks."""
    cfg = WaveNetConfig(num_layers=8, R=32, S=128, A=256, max_dilation=8)
    batch, samples = 2, 8
    ref_w, cond, sel = make_case(cfg, batch, samples, seed=23)
    _, y_gold = golden_run(cfg, ref_w, cond, sel, batch, samples)

    eng = make_engine(cfg, batch, Impl.PERSISTENT, chunk=4)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    seen = []
    y = eng.run_chunks(7, lambda yc, off, n: seen.append((yc.shape, off, n)),
                       samples, batch)
    assert np.array_equal(y_gold, y)
    assert seen == [((batch, 7), 0, 7), ((batch, 1), 7, 1)]

    # run_partial with the carried state equals one run, and dump getters
    # after a chunked dump run equal a single dump run
    y_full = eng.run(samples, batch, dump_activations=True)
    full = {k: v.clone() for k, v in eng._dumps.items()}
    parts = [eng.run_partial(0, 3, batch), eng.run_partial(3, 5, batch)]
    assert np.array_equal(y_full, np.concatenate(parts, axis=1))
    y = eng.run_chunks(7, lambda *a: None, samples, batch,
                       dump_activations=True)
    assert np.array_equal(y_full, y)
    for k in full:
        assert torch.equal(full[k], eng._dumps[k]), k
    assert np.allclose(eng.get_p().sum(-1), 1.0, atol=1e-5)


def test_default_selectors_and_canonical_upload():
    """selectors=None draws the default stream keyed on the seed; weights
    uploaded in canonical layout give the same samples as the setters."""
    cfg = WaveNetConfig(num_layers=6, R=32, S=128, A=256, max_dilation=4)
    batch, samples = 3, 10
    ref_w, cond, _ = make_case(cfg, batch, samples, seed=31)
    sel = jinfer._selector_stream(9, 0, samples, batch)
    _, y_gold = golden_run(cfg, ref_w, cond, sel, batch, samples)

    eng = make_engine(cfg, batch)
    eng.set_canonical_params(params_lib.to_canonical(ref_w, cfg))
    eng.set_inputs(cond, seed=9)
    assert np.array_equal(y_gold, eng.run(samples, batch))
    y_dev = eng.run_device(samples, batch)
    assert isinstance(y_dev, torch.Tensor) and y_dev.shape == (samples, batch)
    assert np.array_equal(y_gold, y_dev.numpy().T)


@pytest.mark.parametrize("t0", [0, 12345, [0, 7, 1 << 33]])
def test_selector_stream_bit_equal(t0):
    a = jinfer._selector_stream(0xDEADBEEF, np.asarray(t0), 64, 3, pidx=1)
    b = tinfer._selector_stream(0xDEADBEEF, np.asarray(t0), 64, 3, pidx=1)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        eng = WaveNetInfer(num_layers=2, max_dilation=2, R=32, S=128, A=256)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            WaveNetInfer(num_layers=2, max_dilation=2, R=32, S=128, A=256)


def test_unported_paths_raise():
    """MANYBLOCK (K4) constructs with its storage knobs and a geometry K4
    cannot run raises there; modes "prng" (K3) and "forced" (K2) run:
    forced echoes the symbols its selectors hold, prng draws the same
    samples for the same seed; an unknown mode raises."""
    for kw in ({}, dict(weight_dtype=torch.bfloat16),
               dict(stream_quant="int8", stream_group_size=3,
                    stream_prefetch=True)):
        eng = WaveNetInfer(num_layers=2, max_dilation=2, R=32, S=128, A=256,
                           implementation=Impl.MANYBLOCK, device="cpu", **kw)
        assert eng.implementation == Impl.MANYBLOCK
    # R = 512 constructs since fault F3's repair (the first K4's general
    # instance); A = 16384 leaves no K4 two stages of shared memory
    WaveNetInfer(num_layers=2, max_dilation=2, R=512, S=128, A=256,
                 implementation=Impl.MANYBLOCK, device="cpu")
    with pytest.raises(ValueError, match="two stages"):
        WaveNetInfer(num_layers=2, max_dilation=2, R=32, S=128, A=16384,
                     implementation=Impl.MANYBLOCK, device="cpu")
    cfg = WaveNetConfig(num_layers=2, R=32, S=128, A=256, max_dilation=2)
    ref_w, cond, sel = make_case(cfg, 1, 4, seed=2)
    eng = make_engine(cfg, 1)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    y = eng.run(4, 1, mode="prng")
    assert y.shape == (1, 4) and np.array_equal(eng.run(4, 1, mode="prng"), y)
    sym = np.floor(sel * 256).astype(np.float32)
    eng.set_inputs(cond, sym)
    assert np.array_equal(eng.run(4, 1, mode="forced"), sym.T.astype(np.int32))
    with pytest.raises(ValueError, match="mode"):
        eng.run(4, 1, mode="beam")


def test_engine_rejects_bad_calls():
    cfg = WaveNetConfig(num_layers=2, R=32, S=128, A=256, max_dilation=2)
    ref_w, cond, sel = make_case(cfg, 2, 4, seed=2)
    eng = make_engine(cfg, 2)
    with pytest.raises(RuntimeError, match="set_inputs"):
        eng.run(4, 2)
    with pytest.raises(ValueError, match="cond shape"):
        eng.set_inputs(cond[:, :1], sel)
    with pytest.raises(ValueError, match="max_batch"):
        make_engine(cfg, 1).set_inputs(cond, sel)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    with pytest.raises(ValueError, match="shorter"):
        eng.run(5, 2)
    with pytest.raises(RuntimeError, match="dump_activations"):
        eng.get_zs()
