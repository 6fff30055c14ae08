"""Plain reference of WaveNet generation, teacher-forced on served samples.

The inference step of the NVIDIA nv-wavenet model (the port's canonical
step, `ops/scan_generate.py`, rewritten here in plain torch):

  x0 = tanh(embed[y_prev] + embed[A + y_cur])
  per layer l (dilation d): z = x_{t-d} Wprev + x_t Wcur + dil_b + cond_l
      h = tanh(z[:R]) * sigmoid(z[R:]);  rs = h rs_w + rs_b
      x = rs[:R] + x;  skip = skip + rs[R:]
  zs = relu(relu(skip) out_w + out_b);  za = zs end_w + end_b
  y = the canonical sampler: the count of bins whose cumulative
      probability is <= u, for the injected uniform u.

Given the samples a program served, every step's input is known (the two
previous samples), so all T steps of a layer are computed at once: x_{t-d}
is the layer's input d steps earlier, zero before the start, as the FIFOs
start at zero.  The matrix products run in float32 with TF32 off.  The
result is judged in float64: how far each injected uniform lies outside the
interval of cumulative probability that the reference gives the served
sample.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch


def _check_fp32(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the reference needs full-fp32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def dilations(num_layers: int, max_dilation: int) -> list:
    out, d = [], 1
    for _ in range(num_layers):
        out.append(d)
        d = 1 if d * 2 > max_dilation else d * 2
    return out


def teacher_forced_logits(p: Dict[str, torch.Tensor], cfg: dict,
                          cond: torch.Tensor, y: torch.Tensor,
                          silence: int = 128) -> torch.Tensor:
    """za [T, B, A] of every step whose inputs are the served samples
    y [T, B] (step t sees y[t-2], y[t-1], silence before the start).
    p: canonical parameters (float32 [in, out]); cond [T, L, B, 2R] raw
    (dil_b is added here)."""
    _check_fp32(cond)
    L, R, A = cfg["num_layers"], cfg["R"], cfg["A"]
    T, _, B, _ = cond.shape
    y = y.long()
    pad = torch.full((2, B), silence, dtype=torch.long, device=y.device)
    hist = torch.cat([pad, y], 0)                 # [T + 2, B]
    x = torch.tanh(p["embed"][hist[:T]] + p["embed"][A + hist[1:T + 1]])
    skip = torch.zeros((T, B, cfg["S"]), device=cond.device)
    for l, d in enumerate(dilations(L, cfg["max_dilation"])):
        x_prev = torch.zeros_like(x)
        if d < T:
            x_prev[d:] = x[:T - d]
        w = p["dil_w"][l]
        z = x_prev @ w[:R] + x @ w[R:] + (p["dil_b"][l] + cond[:, l])
        h = torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:])
        rs = h @ p["rs_w"][l] + p["rs_b"][l]
        x = rs[..., :R] + x
        skip = skip + rs[..., R:]
    zs = torch.relu(torch.relu(skip) @ p["out_w"] + p["out_b"])
    return zs @ p["end_w"] + p["end_b"]


def selector_gaps(za: torch.Tensor, y: torch.Tensor, sel: torch.Tensor
                  ) -> Dict[str, float]:
    """How far each injected uniform sel [T, B] lies outside the reference's
    interval [cum(y - 1), cum(y)) of the served sample y [T, B], in
    probability (float64).  Returns the widest gap, the samples whose gap
    is above 0 and the samples the reference's own sampler would change."""
    p = torch.softmax(za.double(), dim=-1)
    cum = torch.cumsum(p, dim=-1)
    yi = y.long().clamp(0, za.shape[-1] - 1)[..., None]
    hi = torch.gather(cum, -1, yi)[..., 0]
    lo = hi - torch.gather(p, -1, yi)[..., 0]
    u = sel.double()
    gap = torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)
    gap = torch.where((y >= 0) & (y < za.shape[-1]), gap,
                      torch.ones_like(gap))
    return {"widest_gap": float(gap.max()),
            "outside": int((gap > 0).sum()),
            "samples": int(gap.numel())}
