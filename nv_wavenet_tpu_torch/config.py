"""Model / engine configuration for the PyTorch/CUDA port.

The port's own copy of `nv_wavenet_tpu/config.py` (the JAX package is the
reference and is not imported here).  R/S/A are plain runtime values; the
CUDA kernels take them as launch arguments.

Terminology: R = residual channels, S = skip channels, A = audio
quantization channels (mu-law bins), L = number of residual layers,
max_dilation = largest dilation in the cycling schedule.

The dilation FIFOs live in ONE plain [ring_size, B, R] buffer: layer l's
queue holds d_l slots starting at `ring_offsets[l]`, and at absolute sample
t the layer reads x^l_{t-d_l} from slot offs[l] + (t & (d_l - 1)) and writes
x^l_t back to the same slot.  The JAX package's 128-lane `packed_ring_plan`
is a TPU tiling artifact and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def dilation_schedule(num_layers: int, max_dilation: int) -> Tuple[int, ...]:
    """Cycling power-of-two dilations: 1, 2, ..., max_dilation, 1, 2, ..."""
    if max_dilation < 1 or (max_dilation & (max_dilation - 1)) != 0:
        raise ValueError(f"max_dilation must be a power of two, got {max_dilation}")
    dils = []
    d = 1
    for _ in range(num_layers):
        dils.append(d)
        d *= 2
        if d > max_dilation:
            d = 1
    return tuple(dils)


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Static shape/behaviour config shared by the plain generator, the CUDA
    kernels and the engine."""

    num_layers: int = 20
    R: int = 64           # residual channels
    S: int = 128          # skip channels
    A: int = 256          # output channels (mu-law bins)
    max_dilation: int = 512
    tanh_embed: bool = True   # apply tanh after the 2-tap embedding sum
    silence_bin: int = 128    # initial y_prev/y_cur and sampler fallback value

    def __post_init__(self):
        if self.num_layers < 1 or self.A < 2:
            raise ValueError(f"invalid config {self}")

    @property
    def dilations(self) -> Tuple[int, ...]:
        return dilation_schedule(self.num_layers, self.max_dilation)

    @property
    def ring_offsets(self) -> Tuple[int, ...]:
        """Start slot of each layer's dilation FIFO in the [ring_size, B, R]
        ring (layer l owns slots [offs[l], offs[l] + d_l))."""
        offs = []
        acc = 0
        for d in self.dilations:
            offs.append(acc)
            acc += d
        return tuple(offs)

    @property
    def ring_size(self) -> int:
        return sum(self.dilations)

    @property
    def receptive_field(self) -> int:
        return sum(self.dilations) + 1

    def param_count(self) -> int:
        L, R, S, A = self.num_layers, self.R, self.S, self.A
        return (2 * A * R                      # embeddings (prev + cur)
                + L * (2 * R * 2 * R + 2 * R)  # dilated conv W + b
                + L * (R * R + R)              # residual W + b
                + L * (S * R + S)              # skip W + b
                + A * S + A                    # out (Zs) W + b
                + A * A + A)                   # end (Za) W + b

    def weight_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_count() * dtype_bytes

    def ring_bytes(self, batch: int, dtype_bytes: int = 4) -> int:
        return self.ring_size * batch * self.R * dtype_bytes


TEST_CONFIG_SMALL = WaveNetConfig(num_layers=20, R=32, S=128, A=256, max_dilation=8)
TEST_CONFIG_MED = WaveNetConfig(num_layers=20, R=64, S=128, A=256, max_dilation=8)
TEST_CONFIG_LARGE = WaveNetConfig(num_layers=20, R=64, S=256, A=256, max_dilation=8)
FLAGSHIP_CONFIG = WaveNetConfig(num_layers=20, R=64, S=256, A=256, max_dilation=512)
