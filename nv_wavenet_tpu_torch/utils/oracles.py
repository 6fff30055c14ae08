"""Value oracles shared by the port's checks.

The port's copy of `nv_wavenet_tpu/utils/oracles.py`.  The int8 weight
streaming tier is exact: K4 dequantizes with one rounded product per weight,
so its integer samples equal the plain loop fed the quantize -> dequantize
round-tripped weights.
"""

from __future__ import annotations

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig
from nv_wavenet_tpu_torch.models import params as params_lib
from nv_wavenet_tpu_torch.ops import persistent, scan_generate


def int8_dequant_scan_oracle(cfg: WaveNetConfig, ref_w: dict, cond, sel
                             ) -> np.ndarray:
    """Integer samples [B, T] of the plain loop (on the CPU) fed the int8
    round-tripped weights: the value oracle of `WaveNetInfer(stream_quant=
    "int8", implementation=Impl.MANYBLOCK)` over the same inputs (cond
    [T, L, B, 2R], sel [T, B] uniforms)."""
    params = params_lib.canonical_to_torch(
        params_lib.to_canonical(ref_w, cfg), "cpu")
    params_dq = persistent.dequantize_stream_params(params)
    state = scan_generate.init_state(cfg, np.shape(sel)[1], "cpu")
    _, y, _ = scan_generate.generate(
        params_dq, state, torch.as_tensor(np.asarray(cond, np.float32)),
        torch.as_tensor(np.asarray(sel, np.float32)), cfg)
    return y.numpy()
