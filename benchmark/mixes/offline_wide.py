"""Traffic kind "offline_wide": the offline requests of `offline.py` on a
configuration with its own embedding (`tanh_embed` in its file) and the
wide vocoder's reference (`reference/wide_wavenet_ref.py`).

A request is `batch` utterances of `samples` samples: `set_inputs(cond,
selectors)` and `run_chunks(chunk, ...)` on one engine (mode "sample",
injected selectors), the conditioning from a bank made on the card, the
window whole requests until `--seconds` have passed: `offline.py`'s
set-up, window and release.

A program that would run the exact step of these widths one CTA a row
(the generic K1, whose every row re-reads all the weights a step on one SM)
cannot run the cell in any useful time: set-up refuses it at once, exit 2.

The check: `offline.check`'s, against the wide reference.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.mixes import offline
from benchmark.reference import wide_wavenet_ref

window = offline.window
release = offline.release


def setup(run) -> dict:
    run.engine_kw.setdefault("tanh_embed", run.cfg["tanh_embed"])
    exact = not (run.engine_kw.get("fast_math")
                 or run.engine_kw.get("compute_dtype", torch.float32)
                 != torch.float32)
    if run.device.type == "cuda" and exact:
        from nv_wavenet_tpu_torch.config import WaveNetConfig
        from nv_wavenet_tpu_torch.ops import persistent
        c = run.cfg
        route = persistent.generation_route(WaveNetConfig(
            num_layers=c["num_layers"], R=c["R"], S=c["S"], A=c["A"],
            max_dilation=c["max_dilation"]), run.traffic["batch"])
        if route.kernel == "generic":
            raise SystemExit(
                f"the program runs these widths' exact step on the generic "
                f"K1, one CTA a row ({route.note}): the cell needs a kernel "
                f"that streams the weights once a step for all rows")
    return offline.setup(run)


def check(run, st: dict) -> None:
    """Hold a sample of the window's requests against the wide reference."""
    t, c = run.traffic, run.cfg
    outs = st["outputs"]
    rng = np.random.default_rng(inputs.sub_seed(run.seed, "check"))
    picks = sorted(rng.choice(len(outs), min(t["check_requests"], len(outs)),
                              replace=False).tolist())
    params = inputs.gen_params(c, run.seed, run.device)
    bank = inputs.offline_cond_bank(c, t, run.seed, run.device)
    run.failed = int(sum(y.shape != (t["batch"], t["samples"])
                         or y.min() < 0 or y.max() >= c["A"] for y in outs))
    widest, outside, n = 0.0, 0, 0
    for i in picks:
        y = torch.as_tensor(outs[i].T.copy(), device=run.device)
        sel = inputs.offline_selectors(t, run.seed, i % t["selector_bank"],
                                       run.device)
        za = wide_wavenet_ref.teacher_forced_logits(
            params, c, bank[i % t["cond_bank"]], y)
        g = wide_wavenet_ref.selector_gaps(za, y, sel)
        widest = max(widest, g["widest_gap"])
        outside += g["outside"]
        n += g["samples"]
    run.compare("widest_sel_gap", widest, t["limits"]["widest_sel_gap"])
    run.compare("malformed_requests", run.failed, 0)
    run.notes.update(checked_requests=picks, samples_checked=n,
                     samples_outside=outside)
