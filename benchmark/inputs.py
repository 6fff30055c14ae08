"""The inputs and weights of every cell, made from `--seed`.

Both sides get these: the program under test and the plain reference
(`reference/`).  Tensors are drawn on the device with a `torch.Generator`
there, in a few large calls; the serving schedule and the training audio
come from numpy generators on the host.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed keyed on `seed` (any int >= 0) and the tags (ints or
    strings), for one generator of one purpose."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        if isinstance(t, str):
            words.extend(t.encode())
        else:
            words.extend([int(t) & 0xFFFFFFFF, (int(t) >> 32) & 0xFFFFFFFF])
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & 0x7FFFFFFFFFFFFFFF


def device_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def uniform(shape, gen: torch.Generator, device, lo: float, hi: float,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """U[lo, hi) float32 of `shape` on `device` (into `out` when given)."""
    t = torch.rand(shape, generator=gen, device=device, out=out)
    return t.mul_(hi - lo).add_(lo)


# ---------------------------------------------------------------------------
# generation: canonical weights, conditioning, selectors
# ---------------------------------------------------------------------------

def canonical_shapes(cfg: dict) -> Dict[str, tuple]:
    """The engine's canonical parameters (weights [in, out])."""
    L, R, S, A = cfg["num_layers"], cfg["R"], cfg["S"], cfg["A"]
    return {"embed": (2 * A, R), "dil_w": (L, 2 * R, 2 * R),
            "dil_b": (L, 2 * R), "rs_w": (L, R, R + S), "rs_b": (L, R + S),
            "out_w": (S, A), "out_b": (A,), "end_w": (A, A), "end_b": (A,)}


def _gen_fan_in(cfg: dict) -> Dict[str, int]:
    """The fan-in of each weight of the step (the rest are biases)."""
    R, S, A = cfg["R"], cfg["S"], cfg["A"]
    return {"embed": 2, "dil_w": 2 * R, "rs_w": R, "out_w": S, "end_w": A}


END_GAIN = 4.0   # the output layer's gain: logits of std ~3.4 at the flagship


def gen_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every canonical parameter, drawn in one call on `device`: each weight
    U[-a, a) with a = sqrt(3 / fan_in) (the embedding's two rows summing to
    unit variance), the output layer's times END_GAIN, each bias
    U[-0.1, 0.1).  At the flagship the logits then spread as a trained
    vocoder's do: ~3.3 bits of entropy a sample and a most likely bin of
    ~0.4 on average, where the port's U[-0.5/R, 0.5/R) leaves every sample
    all but uniform (8.0 bits), which no lower precision could be seen
    in."""
    shapes = canonical_shapes(cfg)
    fan_in = _gen_fan_in(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = uniform((sum(sizes),), device_generator(
        device, sub_seed(seed, "gen_params")), device, -1.0, 1.0)
    out = {}
    for (k, s), t in zip(shapes.items(), torch.split(flat, sizes)):
        a = (0.1 if k not in fan_in else math.sqrt(3.0 / fan_in[k])
             * (END_GAIN if k == "end_w" else 1.0))
        out[k] = (t * a).view(s)
    return out


def offline_cond_bank(cfg: dict, traffic: dict, seed: int, device
                      ) -> torch.Tensor:
    """[bank, T, L, B, 2R] conditioning U[-c, c): the requests use it
    round-robin."""
    shape = (traffic["cond_bank"], traffic["samples"], cfg["num_layers"],
             traffic["batch"], 2 * cfg["R"])
    c = traffic["cond_range"]
    return uniform(shape, device_generator(device, sub_seed(seed, "cond")),
                   device, -c, c)


def offline_selectors(traffic: dict, seed: int, request: int, device
                      ) -> torch.Tensor:
    """[T, B] U[0, 1) injected selectors of request `request`."""
    return uniform((traffic["samples"], traffic["batch"]),
                   device_generator(device, sub_seed(seed, "sel", request)),
                   device, 0.0, 1.0)


def utterance(cfg: dict, traffic: dict, seed: int, k: int, n: int, device,
              cond_out: torch.Tensor | None = None,
              sel_out: torch.Tensor | None = None):
    """Utterance k of a serving run: conditioning [n, L, 2R] U[-c, c) and
    injected selectors [n] U[0, 1), from one generator keyed on (seed, k)."""
    gen = device_generator(device, sub_seed(seed, "utt", k))
    c = traffic["cond_range"]
    cond = uniform((n, cfg["num_layers"], 2 * cfg["R"]), gen, device, -c, c,
                   cond_out)
    sel = uniform((n,), gen, device, 0.0, 1.0, sel_out)
    return cond, sel


def serve_rng(seed: int) -> np.random.Generator:
    """The serving schedule's generator: utterance lengths and each tick's
    row lengths."""
    return np.random.default_rng(sub_seed(seed, "serve_schedule"))


# ---------------------------------------------------------------------------
# training: initial parameters and raw audio
# ---------------------------------------------------------------------------

def train_param_shapes(w: dict) -> Dict[str, tuple]:
    """The trainable model's parameters (the `state_dict` names of the
    reference's training model, `pytorch/wavenet.py`), in a fixed order:
    name -> (shape, fan_in) where fan_in sets the weight's scale and None
    marks a bias."""
    L, R, S = w["n_layers"], w["n_residual_channels"], w["n_skip_channels"]
    A, C, Ain = w["n_out_channels"], w["n_cond_channels"], w["n_in_channels"]
    win = w["upsamp_window"]
    shapes = {"embed.weight": ((Ain, R), R),
              "upsample.weight": ((C, C, win), C * win),
              "upsample.bias": ((C,), None),
              "cond_layer.weight": ((2 * R * L, C, 1), C),
              "cond_layer.bias": ((2 * R * L,), None)}
    for i in range(L):
        shapes[f"dilate_layers.{i}.weight"] = ((2 * R, R, 2), 2 * R)
        shapes[f"dilate_layers.{i}.bias"] = ((2 * R,), None)
    for i in range(L - 1):
        shapes[f"res_layers.{i}.weight"] = ((R, R, 1), R)
        shapes[f"res_layers.{i}.bias"] = ((R,), None)
    for i in range(L):
        shapes[f"skip_layers.{i}.weight"] = ((S, R, 1), R)
        shapes[f"skip_layers.{i}.bias"] = ((S,), None)
    shapes["conv_out.weight"] = ((A, S, 1), S)
    shapes["conv_end.weight"] = ((A, A, 1), A)
    return shapes


def train_params(w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial parameters, one draw on `device`: each weight U[-a, a) with
    a = sqrt(3 / fan_in) (lecun's variance), each bias U[-0.05, 0.05), so
    every bias has a gradient of its own size from step 1."""
    shapes = train_param_shapes(w)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = uniform((sum(sizes),), device_generator(
        device, sub_seed(seed, "train_params")), device, -1.0, 1.0)
    out = {}
    for (name, (shape, fan_in)), t in zip(shapes.items(),
                                          torch.split(flat, sizes)):
        a = 0.05 if fan_in is None else math.sqrt(3.0 / fan_in)
        out[name] = (t * a).view(shape)
    return out


def audio_clips(seed: int, n_clips: int, length: int, sr: int
                ) -> List[np.ndarray]:
    """Raw training audio in [-0.95, 0.95]: two harmonics of a random pitch
    in [80, 400] Hz with noise (as `nv_wavenet_tpu_torch.train.data.
    synthetic_clips` makes its clips), float32."""
    rng = np.random.default_rng(sub_seed(seed, "clips"))
    t = np.arange(length) / sr
    clips = []
    for _ in range(n_clips):
        f0 = rng.uniform(80, 400)
        sig = (0.5 * np.sin(2 * np.pi * f0 * t)
               + 0.25 * np.sin(2 * np.pi * 2.01 * f0 * t)
               + 0.05 * rng.standard_normal(length))
        clips.append((sig / np.max(np.abs(sig)) * 0.95).astype(np.float32))
    return clips


def data_seed(seed: int) -> int:
    """The seed the data pipeline samples segments with (numpy's legacy
    generator takes 32 bits; the pipeline masks it to 31 across ranks)."""
    return sub_seed(seed, "data") & 0x7FFFFFFF
