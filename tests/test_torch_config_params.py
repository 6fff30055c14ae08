"""The port's config and parameter adapters against the JAX package's.

Geometry (dilations, FIFO offsets, ring size, parameter count) must be equal
for every engine-matrix config and the four named configs; the numpy weight
generator and layout adapters must give bit-equal arrays; and
`canonical_to_torch` must carry the canonical arrays across unchanged.
"""

import numpy as np
import pytest
import torch

from nv_wavenet_tpu import config as jcfg
from nv_wavenet_tpu.models import params as jparams
from nv_wavenet_tpu_torch import config as tcfg
from nv_wavenet_tpu_torch.models import params as tparams

from tests.test_engine import MATRIX

NAMED = ("TEST_CONFIG_SMALL", "TEST_CONFIG_MED", "TEST_CONFIG_LARGE",
         "FLAGSHIP_CONFIG")
CONFIGS = [c for c, _, _ in MATRIX] + [getattr(jcfg, n) for n in NAMED]


def _port_cfg(cfg):
    return tcfg.WaveNetConfig(num_layers=cfg.num_layers, R=cfg.R, S=cfg.S,
                              A=cfg.A, max_dilation=cfg.max_dilation,
                              tanh_embed=cfg.tanh_embed,
                              silence_bin=cfg.silence_bin)


@pytest.mark.parametrize("name", NAMED)
def test_named_configs_equal(name):
    assert getattr(tcfg, name) == _port_cfg(getattr(jcfg, name))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_geometry_equal(cfg):
    port = _port_cfg(cfg)
    assert port.dilations == cfg.dilations
    assert port.ring_offsets == cfg.ring_offsets
    assert port.ring_size == cfg.ring_size
    assert port.receptive_field == cfg.receptive_field
    assert port.param_count() == cfg.param_count()
    assert port.weight_bytes() == cfg.weight_bytes()
    assert port.ring_bytes(16) == cfg.ring_bytes(16)
    assert tcfg.dilation_schedule(cfg.num_layers, cfg.max_dilation) == \
        jcfg.dilation_schedule(cfg.num_layers, cfg.max_dilation)


def test_dilation_schedule_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tcfg.dilation_schedule(4, 6)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_weights_and_layout_bit_equal(cfg):
    port = _port_cfg(cfg)
    ref_j = jparams.random_reference_weights(cfg, seed=5)
    ref_t = tparams.random_reference_weights(port, seed=5)
    assert ref_j.keys() == ref_t.keys()
    for k in ref_j:
        a, b = ref_j[k], ref_t[k]
        if isinstance(a, list):
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), k
        else:
            assert np.array_equal(a, b), k
    can_j = jparams.to_canonical(ref_j, cfg)
    can_t = tparams.to_canonical(ref_t, port)
    assert can_j.keys() == can_t.keys()
    for k in can_j:
        assert can_t[k].dtype == np.float32
        assert np.array_equal(can_j[k], can_t[k]), k
    tparams.validate_canonical(can_t, port)
    back = tparams.from_canonical(can_t, port)
    back_j = jparams.from_canonical(can_j, cfg)
    for k in back_j:
        if isinstance(back_j[k], list):
            assert all(np.array_equal(x, y) for x, y in zip(back_j[k], back[k]))
        else:
            assert np.array_equal(back_j[k], back[k]), k


@pytest.mark.parametrize("cfg", CONFIGS)
def test_canonical_to_torch_round_trip(cfg):
    can = jparams.to_canonical(jparams.random_reference_weights(cfg, seed=2),
                               cfg)
    t = tparams.canonical_to_torch(can, "cpu")
    assert list(t) == list(tparams.PARAM_ORDER)
    for k, v in t.items():
        assert v.dtype == torch.float32 and v.is_contiguous()
        assert np.array_equal(v.numpy(), can[k]), k


def test_canonical_to_torch_rejects_bad_params():
    cfg = jcfg.TEST_CONFIG_SMALL
    can = jparams.to_canonical(jparams.random_reference_weights(cfg), cfg)
    bad = dict(can, rs_b=can["rs_b"][:, :-1])
    with pytest.raises(ValueError, match="rs_b"):
        tparams.canonical_to_torch(bad, "cpu")
    missing = {k: v for k, v in can.items() if k != "end_b"}
    with pytest.raises(ValueError, match="end_b"):
        tparams.canonical_to_torch(missing, "cpu")
    with pytest.raises(ValueError, match="rs_b"):
        tparams.validate_canonical(bad, _port_cfg(cfg))
