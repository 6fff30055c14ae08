"""Runs of a cell with the program changed underneath, for the readings
that set a check's limits and for the tests that see the check fail.

  * controls (a lower precision the program has a path for): "bf16"
    (`compute_dtype=torch.bfloat16`) and "fast" (`fast_math=True`) for
    generation, "tf32" (the model's precision "default") for training;
  * faults: "altered" (served samples changed where they are produced: a
    request's first chunk's last sample of row 0, every slot's first
    sample of a feed; or the loss a step returns), "half_batch" (half the
    rows left out: generation returns silence for them; training steps on
    the other half alone),
    "unchanged" (the step leaves its state as it was: the FIFOs are
    cleared before every generation call; training's parameters are put
    back after every step), "no_exchange" (training across ranks: each rank
    keeps its own gradient, DDP's all-reduce skipped).

`run.py` takes `--variant` for these runs alone; the benchmark's own runs
never pass it.
"""

from __future__ import annotations

import contextlib

import torch

CONTROLS = {"bf16": {"compute_dtype": torch.bfloat16},
            "fast": {"fast_math": True},
            "tf32": {"precision": "default"}}
FAULTS = ("altered", "half_batch", "unchanged", "no_exchange")
NAMES = ("program",) + tuple(CONTROLS) + FAULTS


def engine_kw(name: str) -> dict:
    """The program options of a control ({} otherwise)."""
    if name not in NAMES:
        raise ValueError(f"unknown variant {name!r}; one of {NAMES}")
    return dict(CONTROLS.get(name, {}))


def _patch(obj, attr: str, make):
    old = getattr(obj, attr)
    setattr(obj, attr, make(old))
    return obj, attr, old


@contextlib.contextmanager
def faults(name: str):
    """The fault `name` planted in the program for the block."""
    if name not in FAULTS:
        yield
        return
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.train import trainer
    undo = []

    def gen_out(old):
        def run_partial(self, init_sample, *a, **k):
            if name == "unchanged":
                self._ring.zero_()
            y = old(self, init_sample, *a, **k)
            if name == "altered" and init_sample == 0 and y.numel():
                y[-1, 0] = (y[-1, 0] + 1) % self.cfg.A
            if name == "half_batch":
                y[:, y.shape[1] // 2:] = self.cfg.silence_bin
            return y
        return run_partial

    def feed_out(old):
        def feed_device(self, cond, sel=None, mode="sample", lengths=None):
            if name == "unchanged":
                self._ring.zero_()
            y = old(self, cond, sel, mode, lengths)
            if name == "altered" and y.numel():
                y[0] = (y[0] + 1) % self.cfg.A   # every slot's first sample
            if name == "half_batch":
                y[:, y.shape[1] // 2:] = self.cfg.silence_bin
            return y
        return feed_device

    def step_out(old):
        def train_step(state, mel, audio):
            if name == "half_batch":
                h = mel.shape[0] // 2
                return old(state, mel[:h], audio[:h])
            if name == "no_exchange" and hasattr(state.model, "no_sync"):
                with state.model.no_sync():
                    return old(state, mel, audio)
            if name == "unchanged":
                saved = [p.detach().clone()
                         for p in state.module.parameters()]
                loss = old(state, mel, audio)
                with torch.no_grad():
                    for p, s in zip(state.module.parameters(), saved):
                        p.copy_(s)
                return loss
            loss = old(state, mel, audio)
            return loss * 1.001 if name == "altered" else loss
        return train_step

    undo.append(_patch(WaveNetInfer, "_run_partial_device", gen_out))
    undo.append(_patch(WaveNetInfer, "feed_device", feed_out))
    undo.append(_patch(trainer, "train_step", step_out))
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
