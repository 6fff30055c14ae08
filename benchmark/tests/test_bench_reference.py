"""The plain reference against the port's plain paths at tiny sizes: the
teacher-forced logits and the sampler against the port's step generator,
the training features, loss and gradients against the port's pipeline and
model; and a lower precision read as a fault."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import train_ref, wavenet_ref
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _port_generate(cfg, params, cond, sel, **kw):
    from nv_wavenet_tpu_torch.config import WaveNetConfig
    from nv_wavenet_tpu_torch.ops import scan_generate
    wc = WaveNetConfig(num_layers=cfg["num_layers"], R=cfg["R"], S=cfg["S"],
                       A=cfg["A"], max_dilation=cfg["max_dilation"])
    state = scan_generate.init_state(
        wc, cond.shape[2], CPU,
        scan_generate.ring_dtype(scan_generate.precision(**kw)))
    _, y, za = scan_generate.generate(params, state, cond, sel, wc,
                                      return_za=True, **kw)
    return y.T, za


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_teacher_forced_logits_match_the_port(seed):
    cfg, T, B = tiny.GEN, 48, 3
    p = inputs.gen_params(cfg, seed, CPU)
    g = torch.Generator().manual_seed(seed)
    cond = torch.rand((T, cfg["num_layers"], B, 2 * cfg["R"]),
                      generator=g) - 0.5
    sel = torch.rand((T, B), generator=g)
    y, za = _port_generate(cfg, p, cond, sel)
    ref = wavenet_ref.teacher_forced_logits(p, cfg, cond, y)
    assert torch.allclose(ref, za, rtol=0, atol=1e-5)
    gaps = wavenet_ref.selector_gaps(ref, y, sel)
    assert gaps["widest_gap"] < 1e-6 and gaps["samples"] == T * B


def test_a_bf16_run_reads_a_gap():
    cfg, T, B = tiny.GEN, 256, 4
    p = inputs.gen_params(cfg, 11, CPU)
    g = torch.Generator().manual_seed(11)
    cond = torch.rand((T, cfg["num_layers"], B, 2 * cfg["R"]),
                      generator=g) - 0.5
    sel = torch.rand((T, B), generator=g)
    y, _ = _port_generate(cfg, p, cond, sel, compute_dtype=torch.bfloat16)
    ref = wavenet_ref.teacher_forced_logits(p, cfg, cond, y)
    assert wavenet_ref.selector_gaps(ref, y, sel)["widest_gap"] > 1e-4


def test_an_altered_sample_reads_a_gap():
    cfg, T, B = tiny.GEN, 32, 2
    p = inputs.gen_params(cfg, 3, CPU)
    g = torch.Generator().manual_seed(3)
    cond = torch.rand((T, cfg["num_layers"], B, 2 * cfg["R"]),
                      generator=g) - 0.5
    sel = torch.rand((T, B), generator=g)
    y, _ = _port_generate(cfg, p, cond, sel)
    y[5, 1] = (y[5, 1] + 7) % cfg["A"]
    ref = wavenet_ref.teacher_forced_logits(p, cfg, cond, y)
    assert wavenet_ref.selector_gaps(ref, y, sel)["widest_gap"] > 1e-3


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_training_batches_match_the_port_pipeline(rank, world):
    from nv_wavenet_tpu_torch.train.data import Mel2Samp, \
        data_config_from_json
    d = tiny.TRAIN_CFG["data_config"]
    clips = inputs.audio_clips(9, 3, 900, d["sampling_rate"])
    seed = inputs.data_seed(9)
    port = Mel2Samp(clips, data_config_from_json(d), seed=seed).batches(
        2, rank=rank, world_size=world)
    ref = train_ref.batches(clips, d, seed, 2, rank, world)
    for _ in range(3):
        (pm, pa), (rm, ra) = next(port), next(ref)
        assert np.array_equal(pm, rm) and np.array_equal(pa, ra)


def test_training_loss_and_gradients_match_the_port():
    from nv_wavenet_tpu_torch.train import trainer
    w, d = tiny.TRAIN_CFG["wavenet_config"], tiny.TRAIN_CFG["data_config"]
    model = trainer.create_model(w)
    p0 = inputs.train_params(w, 4, CPU)
    model.load_state_dict(p0)
    clips = inputs.audio_clips(4, 2, 800, d["sampling_rate"])
    mel, bins = next(train_ref.batches(clips, d, 1, 2, 0, 1))
    mel, bins = torch.as_tensor(mel), torch.as_tensor(bins)
    loss = trainer.cross_entropy_loss(model(mel, bins), bins)
    loss.backward()
    ref_loss, ref_g = train_ref.loss_and_grads(p0, w, [(mel, bins)])
    assert abs(float(loss.detach()) - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, prm in model.named_parameters():
        assert torch.allclose(prm.grad, ref_g[name], rtol=1e-5, atol=1e-7), \
            name


def test_reference_adam_is_torchs():
    p = {"a": torch.randn(5, generator=torch.Generator().manual_seed(1))}
    g = {"a": torch.randn(5, generator=torch.Generator().manual_seed(2))}
    t = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.Adam([t], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    adam, q = train_ref.Adam(1e-3), dict(p)
    for _ in range(3):
        t.grad = g["a"].clone()
        opt.step()
        q = adam.step(q, g)
    assert torch.allclose(t.detach(), q["a"], rtol=0, atol=1e-7)
