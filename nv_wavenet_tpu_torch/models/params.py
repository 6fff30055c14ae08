"""Parameter layout and weight-format adapters (numpy), plus the hand-over of
canonical parameters to device tensors.

The port's copy of `nv_wavenet_tpu/models/params.py`: the same RNG calls, so
`random_reference_weights` gives bit-equal arrays for equal seeds.

Canonical layout (all float arrays, weights [in, out] so every op is x @ W):
  embed      [2A, R]      rows [0,A) = prev-symbol table, [A,2A) = cur-symbol
  dil_w      [L, 2R, 2R]  in-axis = [x_{t-d} (R) | x_t (R)], out = [tanh R | sigmoid R]
  dil_b      [L, 2R]
  rs_w       [L, R, R+S]  out-axis = [residual R | skip S]
  rs_b       [L, R+S]
  out_w      [S, A]; out_b [A]
  end_w      [A, A]; end_b [A]
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nv_wavenet_tpu_torch.config import WaveNetConfig

PARAM_ORDER = ("embed", "dil_w", "dil_b", "rs_w", "rs_b",
               "out_w", "out_b", "end_w", "end_b")


def random_reference_weights(cfg: WaveNetConfig, seed: int = 0,
                             scale: float | None = None) -> Dict:
    """Random weights in the reference math shapes (rows = out channels):
    uniform in [-scale, scale), scale 0.5/R by default."""
    rng = np.random.RandomState(seed)
    if scale is None:
        scale = 0.5 / cfg.R
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A

    def rand(*shape):
        return (rng.uniform(-1.0, 1.0, size=shape) * scale).astype(np.float32)

    return {
        "embed_prev": rand(R, A),   # column y = embedding of symbol y
        "embed_cur": rand(R, A),
        "Wprev": [rand(2 * R, R) for _ in range(L)],
        "Wcur": [rand(2 * R, R) for _ in range(L)],
        "Bh": [rand(2 * R) for _ in range(L)],
        "Wres": [rand(R, R) for _ in range(L)],
        "Bres": [rand(R) for _ in range(L)],
        "Wskip": [rand(S, R) for _ in range(L)],
        "Bskip": [rand(S) for _ in range(L)],
        "Wzs": rand(A, S),
        "Bzs": rand(A),
        "Wza": rand(A, A),
        "Bza": rand(A),
    }


def to_canonical(ref: Dict, cfg: WaveNetConfig, dtype=np.float32) -> Dict:
    """Reference math shapes -> canonical stacked [in, out] arrays."""
    L = cfg.num_layers
    embed = np.concatenate(
        [np.asarray(ref["embed_prev"]).T, np.asarray(ref["embed_cur"]).T], axis=0)
    dil_w = np.stack([
        np.concatenate([np.asarray(ref["Wprev"][l]).T,
                        np.asarray(ref["Wcur"][l]).T], axis=0)
        for l in range(L)])
    dil_b = np.stack([np.asarray(ref["Bh"][l]) for l in range(L)])
    rs_w = np.stack([
        np.concatenate([np.asarray(ref["Wres"][l]).T,
                        np.asarray(ref["Wskip"][l]).T], axis=1)
        for l in range(L)])
    rs_b = np.stack([
        np.concatenate([np.asarray(ref["Bres"][l]), np.asarray(ref["Bskip"][l])])
        for l in range(L)])
    params = {
        "embed": embed,
        "dil_w": dil_w,
        "dil_b": dil_b,
        "rs_w": rs_w,
        "rs_b": rs_b,
        "out_w": np.asarray(ref["Wzs"]).T,
        "out_b": np.asarray(ref["Bzs"]),
        "end_w": np.asarray(ref["Wza"]).T,
        "end_b": np.asarray(ref["Bza"]),
    }
    return {k: np.asarray(v, dtype=dtype) for k, v in params.items()}


def canonical_shapes(L: int, R: int, S: int, A: int) -> Dict[str, tuple]:
    return {
        "embed": (2 * A, R),
        "dil_w": (L, 2 * R, 2 * R),
        "dil_b": (L, 2 * R),
        "rs_w": (L, R, R + S),
        "rs_b": (L, R + S),
        "out_w": (S, A),
        "out_b": (A,),
        "end_w": (A, A),
        "end_b": (A,),
    }


def validate_canonical(params: Dict, cfg: WaveNetConfig) -> None:
    for k, shape in canonical_shapes(cfg.num_layers, cfg.R, cfg.S,
                                     cfg.A).items():
        if k not in params:
            raise ValueError(f"param {k} missing")
        got = tuple(params[k].shape)
        if got != shape:
            raise ValueError(f"param {k}: expected shape {shape}, got {got}")


def from_canonical(params: Dict, cfg: WaveNetConfig) -> Dict:
    """Canonical stacked [in, out] arrays -> reference math shapes (the exact
    inverse of `to_canonical`; transposes are lossless)."""
    L, R, A = cfg.num_layers, cfg.R, cfg.A
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return {
        "embed_prev": p["embed"][:A].T,
        "embed_cur": p["embed"][A:].T,
        "Wprev": [p["dil_w"][l][:R].T for l in range(L)],
        "Wcur": [p["dil_w"][l][R:].T for l in range(L)],
        "Bh": [p["dil_b"][l] for l in range(L)],
        "Wres": [p["rs_w"][l][:, :R].T for l in range(L)],
        "Bres": [p["rs_b"][l][:R] for l in range(L)],
        "Wskip": [p["rs_w"][l][:, R:].T for l in range(L)],
        "Bskip": [p["rs_b"][l][R:] for l in range(L)],
        "Wzs": p["out_w"].T,
        "Bzs": p["out_b"],
        "Wza": p["end_w"].T,
        "Bza": p["end_b"],
    }


def canonical_to_torch(params_np: Dict, device,
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Carry the JAX package's canonical parameters (numpy arrays, the same
    [in, out] layout) across to contiguous device tensors.  The geometry is
    read from the shapes (L from dil_w, R from embed, S from out_w, A from
    end_w) and every array is checked against it."""
    missing = [k for k in PARAM_ORDER if k not in params_np]
    if missing:
        raise ValueError(f"canonical params missing {missing}")
    shapes = {k: np.shape(params_np[k]) for k in PARAM_ORDER}
    if (len(shapes["dil_w"]) != 3 or len(shapes["embed"]) != 2
            or len(shapes["out_w"]) != 2 or len(shapes["end_w"]) != 2):
        raise ValueError(f"canonical params have unexpected ranks: {shapes}")
    L, R = shapes["dil_w"][0], shapes["embed"][1]
    S, A = shapes["out_w"][0], shapes["end_w"][0]
    for k, shape in canonical_shapes(L, R, S, A).items():
        if tuple(shapes[k]) != shape:
            raise ValueError(f"param {k}: expected shape {shape}, got "
                             f"{tuple(shapes[k])}")
    return {k: torch.as_tensor(np.asarray(params_np[k]), dtype=dtype,
                               device=device).contiguous()
            for k in PARAM_ORDER}
