"""NVWaveNet: the reference user's API (`pytorch/nv_wavenet.py:55-196`) on
the port's engine.

The port's counterpart of `nv_wavenet_tpu/engine/nv_wavenet.py`: construct
from an `export_weights()` dict (the reference's, or the port's
`models/wavenet.export_weights`; numpy arrays or torch tensors) and call
`infer(cond_input, implementation)` with the reference's channels-first
conditioning (2R x batch x layers x samples).  Inside it drives
`WaveNetInfer` (time-major conditioning, reference math weights), which
runs on the card unless `device="cpu"` is passed among the engine keyword
arguments.

As in the JAX package, R/S/A come from the weights, and one engine is kept
per batch (and implementation) and reused across calls (the reference rebuilds and re-uploads
its engine on every call, `pytorch/wavenet_infer.cu:105-145`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer

__all__ = ["NVWaveNet", "Impl", "column_major", "interleave_lists"]


def _np(x) -> np.ndarray:
    """A host float32 array of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def column_major(x) -> np.ndarray:
    """Kept for API parity (`nv_wavenet.py:33-49`): the reference flips
    tensors to column-major for its C interface.  Here the identity on 1-D,
    a transpose otherwise (a trailing kernel dim of 1 squeezed first)."""
    x = _np(x)
    if x.ndim <= 1:
        return x
    if x.ndim == 3:
        if x.shape[2] != 1:
            raise ValueError(f"a 3-D weight needs a trailing 1, got "
                             f"{x.shape}")
        x = x[:, :, 0]
    if x.ndim == 2:
        return np.ascontiguousarray(x.T)
    if x.ndim == 4:
        return np.ascontiguousarray(np.transpose(x, (3, 2, 1, 0)))
    raise ValueError(f"unsupported rank {x.ndim}")


def interleave_lists(*lists) -> List:
    """Parity helper (`nv_wavenet.py:30-31`)."""
    return [x for t in zip(*lists) for x in t]


class NVWaveNet:
    def __init__(self, embedding_prev, embedding_curr, conv_out_weight,
                 conv_end_weight, dilate_weights, dilate_biases, max_dilation,
                 res_weights, res_biases, skip_weights, skip_biases,
                 use_embed_tanh, **engine_kwargs):
        """Arguments as `export_weights()` makes them
        (`pytorch/wavenet.py:147-188`): embedding_prev/curr [A, R];
        conv_out_weight [A, S]; conv_end_weight [A, A]; dilate_weights a
        list of [2R, R, 2] (tap 0 the older sample); res_weights L-1 [R, R]
        (a zero layer is appended, `nv_wavenet.py:139-141`); skip_weights L
        [S, R].  Conv1d weights may carry their trailing kernel dim of 1.
        engine_kwargs go to `WaveNetInfer` (device, chunk_size, ...)."""
        def w(x):
            x = _np(x)
            return x[:, :, 0] if x.ndim == 3 and x.shape[-1] == 1 else x

        embedding_prev, embedding_curr = w(embedding_prev), w(embedding_curr)
        conv_out_weight, conv_end_weight = w(conv_out_weight), w(
            conv_end_weight)
        res_weights = [w(x) for x in res_weights]
        skip_weights = [w(x) for x in skip_weights]
        A, R = embedding_curr.shape
        S = conv_out_weight.shape[1]
        L = len(dilate_weights)
        if conv_out_weight.shape[0] != A or conv_end_weight.shape != (A, A):
            raise ValueError(f"conv_out_weight {conv_out_weight.shape} / "
                             f"conv_end_weight {conv_end_weight.shape} do "
                             f"not match A={A}")
        if len(res_weights) not in (L, L - 1) or len(skip_weights) != L:
            raise ValueError(f"{L} dilated layers need L or L-1 res and L "
                             f"skip weights, got {len(res_weights)} and "
                             f"{len(skip_weights)}")
        self.R, self.S, self.A = R, S, A
        self.num_layers = L
        self.max_dilation = max_dilation
        self.use_embed_tanh = bool(use_embed_tanh)
        self._engine_kwargs = engine_kwargs
        self._engines: Dict[tuple, WaveNetInfer] = {}
        self._infer_calls = 0   # the default selectors' seed, per call

        self._layers = []
        for i in range(L):
            dw = _np(dilate_weights[i])
            if dw.shape != (2 * R, R, 2):
                raise ValueError(f"dilate weight {dw.shape}, expected "
                                 f"(2R, R, 2) = {(2 * R, R, 2)}")
            last = i >= len(res_weights)
            self._layers.append(dict(
                Wprev=dw[:, :, 0], Wcur=dw[:, :, 1],
                Bh=_np(dilate_biases[i]),
                Wres=np.zeros((R, R), np.float32) if last else res_weights[i],
                Bres=np.zeros((R,), np.float32) if last
                else _np(res_biases[i]),
                Wskip=skip_weights[i], Bskip=_np(skip_biases[i])))
        self._embeddings = (embedding_prev.T, embedding_curr.T)   # [R, A]
        # the output layers carry no biases (`pytorch/wavenet_infer.cu:75-82`)
        self._out = (conv_out_weight, np.zeros((A,), np.float32),
                     conv_end_weight, np.zeros((A,), np.float32))

    def _engine(self, batch: int, implementation: Impl) -> WaveNetInfer:
        """The engine of (batch, implementation), made and loaded once."""
        key = (batch, implementation)
        if key not in self._engines:
            eng = WaveNetInfer(num_layers=self.num_layers,
                               max_dilation=self.max_dilation, R=self.R,
                               S=self.S, A=self.A, max_batch=batch,
                               implementation=implementation,
                               tanh_embed=self.use_embed_tanh,
                               **self._engine_kwargs)
            eng.set_embeddings(*self._embeddings)
            for i, lw in enumerate(self._layers):
                eng.set_layer_weights(i, **lw)
            eng.set_out_weights(*self._out)
            self._engines[key] = eng
        return self._engines[key]

    def infer(self, cond_input, implementation: Impl = Impl.AUTO,
              selectors=None, mode: str = "sample",
              seed: Optional[int] = None) -> np.ndarray:
        """cond_input: channels x batch x layers x samples (2R, B, L, T),
        the reference layout (`nv_wavenet.py:172-181`), numpy or a tensor.
        Returns int32 samples [batch, T].  Without selectors each call draws
        a fresh default stream (an internal counter as the seed, like the
        reference's per-call host rand()); `seed` makes a call
        reproducible."""
        C, B, L, T = cond_input.shape
        if (C, L) != (2 * self.R, self.num_layers):
            raise ValueError(
                f"cond_input is channels x batch x layers x samples; "
                f"channels & layers should be {(2 * self.R, self.num_layers)}"
                f", got {(C, L)}")
        eng = self._engine(B, implementation)
        if isinstance(cond_input, torch.Tensor):
            cond = cond_input.permute(3, 2, 1, 0).to(torch.float32)
        else:
            cond = np.ascontiguousarray(
                np.transpose(cond_input, (3, 2, 1, 0)), np.float32)
        if seed is None:
            seed = self._infer_calls
            self._infer_calls += 1
        eng.set_inputs(cond, selectors, seed=seed)
        return eng.run(T, B, mode=mode)
