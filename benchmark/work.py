"""The yardstick: operations and bytes of the work the cells do, counted
from the shapes, and the card's published peaks.

Frozen copies of the port's counts (`chip_smoke.py`: `bound_ms`,
`k1_ops_per_row_step`, `k1_bytes`, `k5_bytes`;
`nv_wavenet_tpu_torch/utils/profiling.py::step_cost`) and the training
forward's FLOPs from the layer shapes.  Nothing here imports the program,
so a change to the program cannot move what its work is measured against.

A config is the dict of a `configs/<name>.json` file.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# fp32 operations of one element of the canonical exact math (the port's
# ops/exact_math.py, one op per line of its lowering)
EXP_OPS = 25
RECIP_OPS = 21
TANH_LARGE_OPS = 53
SIGMOID_OPS = 50


def gen_dims(cfg: dict):
    """(L, R, S, A) of a generation config."""
    return cfg["num_layers"], cfg["R"], cfg["S"], cfg["A"]


def dilations(num_layers: int, max_dilation: int) -> list:
    """1, 2, ..., max_dilation, 1, 2, ... for `num_layers` layers."""
    out, d = [], 1
    for _ in range(num_layers):
        out.append(d)
        d = 1 if d * 2 > max_dilation else d * 2
    return out


def param_count(cfg: dict) -> int:
    """Parameters of the inference step (embeddings, dilated, res/skip,
    output stack)."""
    L, R, S, A = gen_dims(cfg)
    return (2 * A * R + L * (2 * R * 2 * R + 2 * R) + L * (R * R + R)
            + L * (S * R + S) + A * S + A + A * A + A)


def ring_size(cfg: dict) -> int:
    return sum(dilations(cfg["num_layers"], cfg["max_dilation"]))


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the fp32 rate, the larger."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_FLOPS)


def step_flops(cfg: dict) -> float:
    """FLOPs of one sample of one utterance (`profiling.step_cost`):
    the embedding's one-hot product, L dilated and res/skip products, the
    output stack."""
    L, R, S, A = gen_dims(cfg)
    return 2.0 * (2 * A * R + L * (2 * R * 2 * R) + L * (R * (R + S))
                  + S * A + A * A)


def row_step_ops(cfg: dict) -> int:
    """Operations of one sample of one batch row: the products (2 per
    multiply-add) and the elementwise work of the canonical step
    (`chip_smoke.k1_ops_per_row_step`)."""
    L, R, S, A = gen_dims(cfg)
    macs = L * (2 * R * 2 * R + R * (R + S)) + S * A + A * A
    gate = TANH_LARGE_OPS + SIGMOID_OPS + 1
    elementwise = (R * (1 + TANH_LARGE_OPS)
                   + L * (R * (4 + gate) + 2 * (R + S))
                   + S + A
                   + A * (2 + EXP_OPS + A.bit_length() - 1 + 2))
    return 2 * macs + elementwise


def launch_bytes(cfg: dict, B: int, T: int, live: int | None = None,
                 ragged: bool = False) -> int:
    """Each input read once, each output written once, of one launch of
    the generation step over T steps of B rows (`chip_smoke.k1_bytes`;
    ragged: `k5_bytes`, the per-row clocks and lengths added): weights,
    the prefolded conditioning and selectors of the row-steps that run
    (`live`, default all T * B), the FIFO ring and y_state in and out, y."""
    L, R = cfg["num_layers"], cfg["R"]
    live = T * B if live is None else live
    n = 4 * (param_count(cfg) + live * L * 2 * R + live
             + 2 * ring_size(cfg) * B * R + 2 * 2 * B + T * B)
    return n + (12 * B if ragged else 0)


def launch_bound_s(cfg: dict, B: int, T: int, live: int | None = None,
                   ragged: bool = False) -> float:
    """The bound of one generation launch (K1 lockstep, K5 ragged): its
    live row-steps' operations or its bytes, the larger."""
    live = T * B if live is None else live
    return bound_s(launch_bytes(cfg, B, T, live, ragged),
                   row_step_ops(cfg) * live)


def train_forward_flops(wcfg: dict, batch: int, samples: int,
                        hop: int) -> float:
    """FLOPs of the training forward (`models/wavenet.py`) on `batch`
    clips of `samples` audio samples, 2 a multiply-add, from the layer
    shapes: the mel upsampler over its frames, the conditioning conv, L
    dilated convs (k=2), L-1 residual and L skip 1x1 convs, conv_out and
    conv_end.  `hop`: the mel frames' stride in samples (centered STFT:
    samples // hop + 1 frames)."""
    L = wcfg["n_layers"]
    R, S = wcfg["n_residual_channels"], wcfg["n_skip_channels"]
    A, C = wcfg["n_out_channels"], wcfg["n_cond_channels"]
    window = wcfg["upsamp_window"]
    frames = samples // hop + 1
    pos = batch * samples
    upsample = 2.0 * batch * frames * C * C * window
    cond = 2.0 * pos * C * 2 * R * L
    dilated = 2.0 * pos * 2 * R * R * 2 * L
    res = 2.0 * pos * R * R * (L - 1)
    skip = 2.0 * pos * R * S * L
    out = 2.0 * pos * (S * A + A * A)
    return upsample + cond + dilated + res + skip + out


def train_step_flops(wcfg: dict, batch: int, samples: int, hop: int
                     ) -> float:
    """A training step: the forward and a backward of twice its work."""
    return 3.0 * train_forward_flops(wcfg, batch, samples, hop)
