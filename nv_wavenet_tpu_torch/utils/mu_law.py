"""Mu-law companding codec, in numpy and in torch.

The port's copy of `nv_wavenet_tpu/utils/mu_law.py` (the reference codec,
`pytorch/utils.py:62-90`): encode maps audio in [-1, 1] to integer bins
[0, mu), decode maps bins back to [-1, 1].  The numpy functions are the JAX
package's, line for line; `mu_law_encode` / `mu_law_decode` are their torch
counterparts (the JAX package's are jnp), on any device.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WAV_VALUE = 32768.0


def mu_law_encode_np(x: np.ndarray, mu_quantization: int = 256) -> np.ndarray:
    if not (np.max(x) <= 1.0 and np.min(x) >= -1.0):
        raise ValueError("mu_law_encode_np: audio outside [-1, 1]")
    mu = mu_quantization - 1.0
    x_mu = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return ((x_mu + 1) / 2 * mu + 0.5).astype(np.int64)


def mu_law_decode_np(x: np.ndarray, mu_quantization: int = 256) -> np.ndarray:
    if not (np.max(x) < mu_quantization and np.min(x) >= 0):
        raise ValueError(f"mu_law_decode_np: bins outside [0, "
                         f"{mu_quantization})")
    mu = mu_quantization - 1.0
    signal = 2 * (x / mu) - 1
    magnitude = (1.0 / mu) * ((1 + mu) ** np.abs(signal) - 1)
    return np.sign(signal) * magnitude


def mu_law_encode(x: torch.Tensor, mu_quantization: int = 256) -> torch.Tensor:
    """x in [-1, 1] (float) -> int32 bins in [0, mu)."""
    mu = mu_quantization - 1.0
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return ((x_mu + 1) / 2 * mu + 0.5).to(torch.int32)


def mu_law_decode(x: torch.Tensor, mu_quantization: int = 256) -> torch.Tensor:
    """int bins -> float32 in [-1, 1]."""
    mu = mu_quantization - 1.0
    signal = 2 * (x.to(torch.float32) / mu) - 1
    magnitude = (1.0 / mu) * ((1 + mu) ** torch.abs(signal) - 1)
    return torch.sign(signal) * magnitude
