"""Trainable WaveNet (teacher-forced, convolutional over whole segments) as
a torch `nn.Module`: the port's counterpart of `nv_wavenet_tpu/models/
wavenet.py` (flax), with the same parameters, arithmetic and export
conventions (the reference training model, `pytorch/wavenet.py:54-202`):

  * sample embedding of mu-law bins (A -> R),
  * mel conditioning upsampled with a transposed conv (window/stride from
    config), then one 1x1 conv producing every layer's conditioning at once
    (n_cond -> 2R*L),
  * L causal dilated convs (k=2, cycling power-of-two dilations),
  * gated tanh/sigmoid activation, residual convs for the first L-1 layers,
    skip convs summed across layers,
  * relu -> conv_out (S->A, no bias) -> relu -> conv_end (A->A, no bias),
  * output logits shifted right one step (next-sample prediction targets).

Public functions take and return the JAX package's channels-last layouts
([B, T, C]; `get_cond_input` the engine's [T, L, B, 2R]); inside, the
convolutions run on torch's [B, C, T].  No Pallas kernel is involved: the
JAX package leaves all of this to XLA, and the port to stock torch ops.

Precision: `precision="highest"` runs every convolution and product in full
fp32 (TF32 off in cuDNN and cuBLAS), which the train <-> infer contract
needs; `"default"` allows TF32, the counterpart of the JAX package's
single-pass bf16 MXU products.  `precision_scope` sets both flags for a
block of work (forward and backward) and restores them after it.

Initialisation draws from flax's distributions (lecun-normal kernels, zero
biases, flax's `Embed` init) from an explicit `torch.Generator`; the bits
differ from JAX's (another generator), so the tests hand both the same
parameters through `params_from_flax`.

Tensor and sequence parallelism (`train/sharding.py`): `forward(...,
mesh=)` computes one rank's part, the module holding its model rank's
shards (`sharding.shard_module`) and the audio its seq rank's window; the
collectives sit where the shards meet.  Without a mesh each of them is the
plain op it replaces.

`export_canonical` / `export_weights` convert the trained parameters into
the engine's format with the reference's conventions (`pytorch/wavenet.py:
147-188` + `pytorch/nv_wavenet.py:98-141`): zero embedding_prev,
tanh_embed=False, Wprev = dilated-conv tap 0 and Wcur = tap 1, an all-zero
residual layer appended for the last layer, and zero out/end biases.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nv_wavenet_tpu_torch.config import WaveNetConfig, dilation_schedule
from nv_wavenet_tpu_torch.train import sharding

PRECISIONS = ("highest", "default")

# flax's truncated-normal variance scaling divides the standard deviation by
# the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


@contextlib.contextmanager
def precision_scope(precision: str) -> Iterator[None]:
    """TF32 in cuDNN convolutions and cuBLAS products off ("highest") or on
    ("default") inside the block; both flags restored after it."""
    check_precision(precision)
    tf32 = precision == "default"
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _truncated_normal_(t: torch.Tensor, std: float,
                       gen: torch.Generator) -> None:
    """Normal(0, std) truncated to [-2 std, 2 std], by the inverse CDF of a
    uniform draw from `gen` (flax's `truncated_normal(-2, 2) * std`)."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.rand(t.shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    with torch.no_grad():
        t.copy_((z * std).clamp_(-2 * std, 2 * std))


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    _truncated_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


class MelUpsample(nn.Module):
    """The mel upsampler: a transposed convolution, stride `stride`, window
    `window`, no padding ([B, F, C] -> [B, (F - 1) stride + window, D]).

    The JAX package keeps its kernel as [window, C, D] and overlap-adds the
    window-reversed kernel's chunks (`nv_wavenet_tpu/models/wavenet.py:63`);
    `F.conv_transpose1d` with weight[c, d, k] = kernel[window - 1 - k, c, d]
    is the same sum, so the flip lives in the weight map
    (`params_from_flax`)."""

    def __init__(self, in_channels: int, features: int, window: int,
                 stride: int):
        super().__init__()
        if window % stride != 0:
            raise ValueError(f"MelUpsample requires window % stride == 0 "
                             f"(got {window} % {stride})")
        self.window, self.stride = window, stride
        self.weight = nn.Parameter(torch.empty(in_channels, features, window))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax's kernel [window, C, D]: fan_in = C * window
        _lecun_normal_(self.weight, self.weight.shape[0] * self.window, gen)
        nn.init.zeros_(self.bias)

    def forward_bct(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, F] -> [B, D, (F - 1) stride + window]."""
        return F.conv_transpose1d(x, self.weight, self.bias,
                                  stride=self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_bct(x.transpose(1, 2)).transpose(1, 2)


class WaveNetTrain(nn.Module):
    """The trainable model at the reference's config keys; `forward(mel,
    audio)` is the teacher-forced forward.  Built with parameters drawn
    from seed 0; `reset_parameters(generator)` draws them anew."""

    def __init__(self, n_in_channels: int = 256, n_layers: int = 16,
                 max_dilation: int = 128, n_residual_channels: int = 64,
                 n_skip_channels: int = 256, n_out_channels: int = 256,
                 n_cond_channels: int = 80, upsamp_window: int = 800,
                 upsamp_stride: int = 200, precision: str = "highest"):
        super().__init__()
        check_precision(precision)
        A, R, S, L = (n_out_channels, n_residual_channels, n_skip_channels,
                      n_layers)
        self.n_in_channels, self.n_layers = n_in_channels, L
        self.max_dilation = max_dilation
        self.n_residual_channels, self.n_skip_channels = R, S
        self.n_out_channels, self.n_cond_channels = A, n_cond_channels
        self.upsamp_window, self.upsamp_stride = upsamp_window, upsamp_stride
        self.precision = precision
        self.dilations = dilation_schedule(L, max_dilation)
        self.embed = nn.Embedding(n_in_channels, R)
        self.upsample = MelUpsample(n_cond_channels, n_cond_channels,
                                    upsamp_window, upsamp_stride)
        self.cond_layer = nn.Conv1d(n_cond_channels, 2 * R * L, 1)
        self.dilate_layers = nn.ModuleList(
            nn.Conv1d(R, 2 * R, 2, dilation=d) for d in self.dilations)
        self.res_layers = nn.ModuleList(
            nn.Conv1d(R, R, 1) for _ in range(L - 1))
        self.skip_layers = nn.ModuleList(
            nn.Conv1d(R, S, 1) for _ in range(L))
        self.conv_out = nn.Conv1d(S, A, 1, bias=False)
        self.conv_end = nn.Conv1d(A, A, 1, bias=False)
        # the model ranks the sharded convs are split over
        # (`sharding.shard_module`); 1: the full module
        self.model_parallel = 1
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's initialisers, drawn from `gen` in a fixed order."""
        R = self.n_residual_channels
        with torch.no_grad():
            # flax Embed [A, R]: variance_scaling(1, fan_in, normal,
            # out_axis=0) has fan_in R
            self.embed.weight.copy_(torch.randn(
                self.embed.weight.shape, generator=gen) / math.sqrt(R))
        self.upsample.reset_parameters(gen)
        convs = [self.cond_layer, *self.dilate_layers, *self.res_layers,
                 *self.skip_layers, self.conv_out, self.conv_end]
        for conv in convs:
            # flax Conv [k, in, out]: fan_in = in * k
            _lecun_normal_(conv.weight,
                           conv.in_channels * conv.kernel_size[0], gen)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)

    def _cond_bct(self, mel: torch.Tensor, length: int,
                  mesh=None) -> torch.Tensor:
        """mel [B, T_mel, n_cond] -> every layer's conditioning
        [B, 2R L, length]: upsample, crop to the audio, one 1x1 conv
        (`pytorch/wavenet.py:105-115`).  Under a mesh, `length` is the seq
        rank's window and the crop that window of the whole upsampled mel;
        the conv's output shards are gathered over the model group."""
        up = self.upsample.forward_bct(mel.transpose(1, 2))
        seq, s = (1, 0) if mesh is None else (mesh.seq, mesh.seq_rank)
        if up.shape[2] < length * seq:
            raise ValueError(
                f"upsampled conditioning covers {up.shape[2]} samples < "
                f"audio length {length * seq} (mel too short for this "
                f"segment; the reference asserts the same, "
                f"`pytorch/wavenet.py:110`)")
        up = sharding.copy_to_model(up[:, :, s * length:(s + 1) * length],
                                    mesh)
        return sharding.gather_model(self.cond_layer(up), mesh)

    def _cond_acts(self, mel: torch.Tensor, length: int) -> torch.Tensor:
        """mel [B, T_mel, n_cond] -> per-layer conditioning
        [B, length, L, 2R]."""
        with precision_scope(self.precision):
            cond = self._cond_bct(mel, length)
        B = cond.shape[0]
        return cond.transpose(1, 2).reshape(B, length, self.n_layers,
                                            2 * self.n_residual_channels)

    def forward(self, mel: torch.Tensor, audio: torch.Tensor,
                mesh=None) -> torch.Tensor:
        """mel [B, T_mel, n_cond]; audio [B, T] int mu-law bins -> logits
        [B, T, A], where logits[:, t] predicts audio[:, t] (right-shifted
        by one: position 0 gets zeros, the output for position T-1 is
        dropped, `pytorch/wavenet.py:136-143`).

        With `mesh` (a `train.sharding.TrainMesh`; the module sharded for
        it), audio is this seq rank's window of T/seq samples
        (`sharding.batch_partition`), the mel whole, and the logits are
        the window's."""
        if self.model_parallel != (1 if mesh is None else mesh.model):
            raise ValueError(f"the module is sharded over "
                             f"{self.model_parallel} model rank(s); the "
                             f"mesh is {mesh}")
        R = self.n_residual_channels
        T = audio.shape[1]
        with precision_scope(self.precision):
            cond = self._cond_bct(mel, T, mesh)            # [B, 2RL, T]
            x = self.embed(audio.long()).transpose(1, 2)   # [B, R, T]
            output = None
            for i, d in enumerate(self.dilations):
                in_act = (self.dilate_layers[i](sharding.halo_pad(x, d, mesh))
                          + cond[:, 2 * R * i:2 * R * (i + 1)])
                acts = torch.tanh(in_act[:, :R]) * torch.sigmoid(in_act[:, R:])
                if i < len(self.res_layers):
                    x = self.res_layers[i](acts) + x
                s = self.skip_layers[i](sharding.copy_to_model(acts, mesh))
                output = s if output is None else output + s
            output = sharding.reduce_from_model(
                self.conv_out(F.relu(output)), mesh)
            output = self.conv_end(F.relu(output))
        # next-sample shift: drop the last step, prepend zeros
        return sharding.shift_right(output, mesh).transpose(1, 2)

    def get_cond_input(self, mel: torch.Tensor) -> torch.Tensor:
        """Inference conditioning: [B, T_mel, n_cond] -> [T, L, B, 2R], the
        engine's set_inputs layout (`pytorch/wavenet.py:190-202`), the
        transposed conv's tail (window - stride samples) trimmed."""
        with precision_scope(self.precision):
            up = self.upsample.forward_bct(mel.transpose(1, 2))
            cutoff = self.upsamp_window - self.upsamp_stride
            cond = self.cond_layer(up[:, :, :up.shape[2] - cutoff])
        B, _, T = cond.shape
        return cond.reshape(B, self.n_layers, 2 * self.n_residual_channels,
                            T).permute(3, 1, 0, 2)


def config_of(model: WaveNetTrain) -> WaveNetConfig:
    return WaveNetConfig(num_layers=model.n_layers,
                         R=model.n_residual_channels,
                         S=model.n_skip_channels,
                         A=model.n_out_channels,
                         max_dilation=model.max_dilation,
                         tanh_embed=False)


# ---------------------------------------------------------------------------
# parameters from the JAX package's flax tree, and exports to the engine
# ---------------------------------------------------------------------------

def _conv(kernel) -> torch.Tensor:
    """flax Conv kernel [k, in, out] -> torch Conv1d weight [out, in, k]."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(2, 1, 0)))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `WaveNetTrain`'s parameters (a tree of numpy arrays, with or
    without the top-level "params") -> this module's `state_dict`: flax
    Conv [k, in, out] -> torch [out, in, k], `Embed` -> `nn.Embedding`, the
    upsampler's [window, C, D] -> conv_transpose1d's [C, D, window]
    window-reversed."""
    p = tree["params"] if "params" in tree else tree
    up = np.asarray(p["upsample"]["kernel"], np.float32)
    sd = {"embed.weight": _vec(p["embed"]["embedding"]),
          "upsample.weight": torch.from_numpy(np.ascontiguousarray(
              up[::-1].transpose(1, 2, 0))),
          "upsample.bias": _vec(p["upsample"]["bias"]),
          "cond_layer.weight": _conv(p["cond_layer"]["kernel"]),
          "cond_layer.bias": _vec(p["cond_layer"]["bias"]),
          "conv_out.weight": _conv(p["conv_out"]["kernel"]),
          "conv_end.weight": _conv(p["conv_end"]["kernel"])}
    for prefix, module in (("dilate", "dilate_layers"), ("res", "res_layers"),
                           ("skip", "skip_layers")):
        i = 0
        while f"{prefix}_{i}" in p:
            sd[f"{module}.{i}.weight"] = _conv(p[f"{prefix}_{i}"]["kernel"])
            sd[f"{module}.{i}.bias"] = _vec(p[f"{prefix}_{i}"]["bias"])
            i += 1
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _check_full(model: WaveNetTrain) -> None:
    if model.model_parallel != 1:
        raise ValueError(
            f"the module holds one of {model.model_parallel} model ranks' "
            f"shards: export the full parameters (a checkpoint, or "
            f"trainer.full_state_dict loaded into a full module)")


def export_canonical(model: WaveNetTrain) -> Dict[str, np.ndarray]:
    """The trained parameters -> the engine's canonical params (numpy):
    embed_prev zero (tanh_embed=False), dilated tap 0 (the older sample)
    -> Wprev and tap 1 -> Wcur, a zero residual part for the last layer,
    zero out_b / end_b."""
    _check_full(model)
    L, R, S, A = (model.n_layers, model.n_residual_channels,
                  model.n_skip_channels, model.n_out_channels)
    embed_cur = _np(model.embed.weight)                      # [A, R]
    dil_w = np.zeros((L, 2 * R, 2 * R), np.float32)
    dil_b = np.zeros((L, 2 * R), np.float32)
    rs_w = np.zeros((L, R, R + S), np.float32)
    rs_b = np.zeros((L, R + S), np.float32)
    for i in range(L):
        w = _np(model.dilate_layers[i].weight)               # [2R, R, 2]
        dil_w[i, :R] = w[:, :, 0].T
        dil_w[i, R:] = w[:, :, 1].T
        dil_b[i] = _np(model.dilate_layers[i].bias)
        if i < L - 1:
            rs_w[i, :, :R] = _np(model.res_layers[i].weight)[:, :, 0].T
            rs_b[i, :R] = _np(model.res_layers[i].bias)
        rs_w[i, :, R:] = _np(model.skip_layers[i].weight)[:, :, 0].T
        rs_b[i, R:] = _np(model.skip_layers[i].bias)
    return {
        "embed": np.concatenate([np.zeros_like(embed_cur), embed_cur], 0),
        "dil_w": dil_w, "dil_b": dil_b, "rs_w": rs_w, "rs_b": rs_b,
        "out_w": np.ascontiguousarray(_np(model.conv_out.weight)[:, :, 0].T),
        "out_b": np.zeros((A,), np.float32),
        "end_w": np.ascontiguousarray(_np(model.conv_end.weight)[:, :, 0].T),
        "end_b": np.zeros((A,), np.float32),
    }


def export_weights(model: WaveNetTrain) -> Dict[str, Any]:
    """The reference's export dict (`pytorch/wavenet.py:147-188`, key for
    key), tensors in the reference's math shapes (rows = out channels)."""
    _check_full(model)
    L = model.n_layers
    embed_cur = _np(model.embed.weight)
    out = {
        "embedding_prev": np.zeros_like(embed_cur),
        "embedding_curr": embed_cur,
        "conv_out_weight": _np(model.conv_out.weight)[:, :, 0],
        "conv_end_weight": _np(model.conv_end.weight)[:, :, 0],
        "dilate_weights": [], "dilate_biases": [],
        "res_weights": [], "res_biases": [],
        "skip_weights": [], "skip_biases": [],
        "max_dilation": model.max_dilation,
        "use_embed_tanh": False,
    }
    for i in range(L):
        # [2R out, R in, 2 taps]
        out["dilate_weights"].append(_np(model.dilate_layers[i].weight))
        out["dilate_biases"].append(_np(model.dilate_layers[i].bias))
        if i < L - 1:
            out["res_weights"].append(_np(model.res_layers[i].weight)[:, :, 0])
            out["res_biases"].append(_np(model.res_layers[i].bias))
        out["skip_weights"].append(_np(model.skip_layers[i].weight)[:, :, 0])
        out["skip_biases"].append(_np(model.skip_layers[i].bias))
    return out
