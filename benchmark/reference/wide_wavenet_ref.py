"""Plain reference of the wide WaveNet vocoder's generation, teacher-forced
on served samples.

The layer of kan-bayashi/PytorchWaveNetVocoder's `WaveNet` (ESPnet's
`espnet/nets/pytorch_backend/wavenet.py`): a causal width-2 convolution
over the one-hot input with no tanh after it, then per layer a gated
dilated width-2 convolution with the conditioning added to both halves,
1x1 res and skip convolutions, and relu -> 1x1 -> relu -> 1x1 at the end.
In the canonical parameters of `inputs.gen_params` (weights [in, out]), one
step of a row is

  x0 = embed[y_prev] + embed[A + y_cur]        (the input conv, bias folded)
  per layer l (dilation d): z = x_{t-d} Wprev + x_t Wcur + dil_b + cond_l
      h = tanh(z[:R]) * sigmoid(z[R:]);  rs = h rs_w + rs_b
      x = rs[:R] + x;  skip = skip + rs[R:]
  zs = relu(relu(skip) out_w + out_b);  za = zs end_w + end_b

Given the served samples, every step's input is known, so each layer runs
over a block of steps at once; a block carries each layer's last d inputs
to the next (zero before the start, as the FIFOs start at zero), so the
whole sequence is computed in blocks that fit beside the conditioning.
The products run in float32 with TF32 off in cuBLAS and cuDNN.  The samples
are judged by `wavenet_ref.selector_gaps`.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from benchmark.reference.wavenet_ref import dilations, selector_gaps  # noqa: F401


@contextlib.contextmanager
def full_fp32():
    """TF32 off in cuBLAS and cuDNN for the block, the flags restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def teacher_forced_logits(p: Dict[str, torch.Tensor], cfg: dict,
                          cond: torch.Tensor, y: torch.Tensor,
                          silence: int = 128, block: int = 2048
                          ) -> torch.Tensor:
    """za [T, B, A] of every step whose inputs are the served samples
    y [T, B] (step t sees y[t-2], y[t-1], silence before the start), in
    blocks of `block` steps.  p: canonical parameters (float32 [in, out]);
    cond [T, L, B, 2R] raw (dil_b is added here)."""
    L, R, S, A = cfg["num_layers"], cfg["R"], cfg["S"], cfg["A"]
    T, _, B, _ = cond.shape
    y = y.long()
    pad = torch.full((2, B), silence, dtype=torch.long, device=y.device)
    hist = torch.cat([pad, y], 0)                 # [T + 2, B]
    dils = dilations(L, cfg["max_dilation"])
    # each layer's inputs of the d steps before the block
    tails = [torch.zeros((d, B, R), device=cond.device) for d in dils]
    za = torch.empty((T, B, A), device=cond.device)
    with full_fp32():
        for s in range(0, T, block):
            e = min(T, s + block)
            n = e - s
            x = p["embed"][hist[s:e]] + p["embed"][A + hist[s + 1:e + 1]]
            skip = torch.zeros((n, B, S), device=cond.device)
            for l, d in enumerate(dils):
                seq = torch.cat([tails[l], x], 0)   # inputs at s - d .. e - 1
                tails[l] = seq[-d:]
                w = p["dil_w"][l]
                z = seq[:n] @ w[:R] + x @ w[R:] + (p["dil_b"][l]
                                                   + cond[s:e, l])
                h = torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:])
                rs = h @ p["rs_w"][l] + p["rs_b"][l]
                x = rs[..., :R] + x
                skip = skip + rs[..., R:]
            zs = torch.relu(torch.relu(skip) @ p["out_w"] + p["out_b"])
            za[s:e] = zs @ p["end_w"] + p["end_b"]
    return za
