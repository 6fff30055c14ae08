"""Migration of trained reference checkpoints: a `state_dict` loaded
natively, as torch tensors on the port's device.

The port's counterpart of `nv_wavenet_tpu/engine/torch_import.py`.  The
reference pickles its whole module (`pytorch/train.py:73-81`), but a
`state_dict` is portable; from it alone this module rebuilds what
inference needs:

  * `export_weights_from_state_dict`: the `export_weights()` dict
    (`pytorch/wavenet.py:147-188`), for `NVWaveNet(**d)`;
  * `cond_input_from_state_dict`: `get_cond_input`'s conditioning
    (`pytorch/wavenet.py:190-202`: the ConvTranspose1d upsampler, the
    kernel-minus-stride tail trim, the all-layers 1x1 cond conv) in the
    reference's channels x batch x layers x samples layout.

Keys may be the reference's (`conv_out.conv.weight`, `cond_layers.conv.
weight`, `dilate_layers.0.conv.weight`, its Conv wrappers) or those of the
port's own `models/wavenet.WaveNetTrain` (`conv_out.weight`,
`cond_layer.weight`, `dilate_layers.0.weight`).  The convolutions run in
full fp32 (`models/wavenet.precision_scope("highest")`: no TF32).

    sd = torch.load("sd.pt")      # a reference model's state_dict()
    net = NVWaveNet(**export_weights_from_state_dict(sd, max_dilation=128))
    audio_bins = net.infer(cond_input_from_state_dict(sd, mels, 200))
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nv_wavenet_tpu_torch.engine.wavenet_infer import resolve_device
from nv_wavenet_tpu_torch.models.wavenet import precision_scope

# the port's WaveNetTrain names of the reference's wrapped convolutions
_PORT_NAMES = {"conv_out.conv.": "conv_out.", "conv_end.conv.": "conv_end.",
               "cond_layers.conv.": "cond_layer."}


def _get(sd: Dict, key: str, device) -> torch.Tensor:
    """sd[key] (a reference name) or its name in the port's model, as a
    float32 tensor on `device`."""
    if key not in sd:
        port = key.replace(".conv.", ".")
        for ref, name in _PORT_NAMES.items():
            if key.startswith(ref):
                port = name + key[len(ref):]
        if port not in sd:
            raise KeyError(f"state_dict holds neither {key!r} nor {port!r}")
        key = port
    return torch.as_tensor(sd[key]).detach().to(device, torch.float32)


def _n_layers(sd: Dict) -> int:
    return 1 + max(int(k.split(".")[1]) for k in sd
                   if k.startswith("dilate_layers."))


def export_weights_from_state_dict(sd: Dict, max_dilation: int,
                                   device=None) -> Dict:
    """`WaveNet.export_weights()` from a state_dict, as tensors on `device`
    (None: the card): a zero embedding_prev, the embedding table as
    embedding_curr, the bias-free output convs, the per-layer dilate, res
    (L-1) and skip lists, `use_embed_tanh=False`.  `max_dilation` is a
    module attribute the state_dict does not hold (the training config's
    wavenet_config has it)."""
    dev = resolve_device(device)
    L = _n_layers(sd)
    embed = _get(sd, "embed.weight", dev)                       # [A, R]
    conv_out = _get(sd, "conv_out.conv.weight", dev)            # [A, S, 1]
    if conv_out.shape[0] != embed.shape[0]:
        raise ValueError(f"conv_out {tuple(conv_out.shape)} does not match "
                         f"the embedding's A={embed.shape[0]}")

    def layers(kind, part, n):
        return [_get(sd, f"{kind}_layers.{i}.conv.{part}", dev)
                for i in range(n)]
    return {
        "embedding_prev": torch.zeros_like(embed),
        "embedding_curr": embed,
        "conv_out_weight": conv_out,
        "conv_end_weight": _get(sd, "conv_end.conv.weight", dev),
        "dilate_weights": layers("dilate", "weight", L),
        "dilate_biases": layers("dilate", "bias", L),
        "res_weights": layers("res", "weight", L - 1),
        "res_biases": layers("res", "bias", L - 1),
        "skip_weights": layers("skip", "weight", L),
        "skip_biases": layers("skip", "bias", L),
        "max_dilation": max_dilation,
        "use_embed_tanh": False,
    }


def cond_input_from_state_dict(sd: Dict, mels, upsamp_stride: int,
                               n_layers: Optional[int] = None,
                               device=None) -> torch.Tensor:
    """`WaveNet.get_cond_input` with the state_dict's weights, on `device`
    (None: the card): upsample the mel frames with the trained
    ConvTranspose1d, trim its (window - stride) tail, apply the all-layers
    1x1 cond conv, and return [2R, B, L, T], the reference's channels x
    batch x layers x samples.

    mels: [n_mel, frames] or [B, n_mel, frames] (numpy or a tensor).
    `upsamp_stride` is a constructor argument the state_dict does not hold
    (the reference config's 200, `config.json:35`); the window comes from
    the upsampler's weight."""
    dev = resolve_device(device)
    mels = torch.as_tensor(np.asarray(mels, np.float32)
                           if not isinstance(mels, torch.Tensor) else mels)
    mels = mels.to(dev, torch.float32)
    if mels.ndim == 2:
        mels = mels[None]
    L = n_layers or _n_layers(sd)
    up_w = _get(sd, "upsample.weight", dev)                 # [C, C, W]
    up_b = _get(sd, "upsample.bias", dev)
    cw = _get(sd, "cond_layers.conv.weight", dev)           # [2RL, C, 1]
    cb = _get(sd, "cond_layers.conv.bias", dev)
    cutoff = up_w.shape[2] - int(upsamp_stride)
    with torch.no_grad(), precision_scope("highest"):
        cond = F.conv_transpose1d(mels, up_w, up_b, stride=int(upsamp_stride))
        if cutoff:
            cond = cond[:, :, :-cutoff]                     # [B, C, T]
        z = F.conv1d(cond, cw, cb)                          # [B, 2RL, T]
    B, _, T = z.shape
    return z.reshape(B, L, -1, T).permute(2, 0, 1, 3).contiguous()
