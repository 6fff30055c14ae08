"""Traffic kind "offline": batched generation, closed loop, one request at
a time.

A request is `batch` utterances of `samples` samples: `set_inputs(cond,
selectors)` and `run_chunks(chunk, consume, samples, batch)` on one engine
(mode "sample", injected selectors).  Conditioning comes from a bank made on
the card in set-up and used round-robin; each request has selectors of its
own.  The window runs whole requests until `--seconds` have passed.

The check: a sample of the window's requests, drawn from the seed, each
held against the plain reference teacher-forced on its served samples
(`reference/wavenet_ref.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import wavenet_ref
from benchmark.tracing import span, sync


def make_engine(run, batch: int, chunk: int):
    """The engine of the config at `batch` rows, with the benchmark's
    weights."""
    from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
    c = run.cfg
    eng = WaveNetInfer(num_layers=c["num_layers"],
                       max_dilation=c["max_dilation"], R=c["R"], S=c["S"],
                       A=c["A"], max_batch=batch,
                       implementation=Impl[c["implementation"]],
                       chunk_size=chunk, device=run.device, **run.engine_kw)
    params = inputs.gen_params(c, run.seed, run.device)
    eng.set_canonical_params({k: v.cpu().numpy() for k, v in params.items()})
    return eng


def setup(run) -> dict:
    t = run.traffic
    eng = make_engine(run, t["batch"], t["chunk"])
    bank = inputs.offline_cond_bank(run.cfg, t, run.seed, run.device)
    sels = [inputs.offline_selectors(t, run.seed, i, run.device)
            for i in range(t["selector_bank"])]
    st = {"eng": eng, "bank": bank, "sels": sels, "outputs": []}
    for i in range(t["warmup_requests"]):
        request(run, st, i)
    st["outputs"].clear()
    return st


def request(run, st: dict, i: int) -> np.ndarray:
    """Request i: its conditioning and selectors, then the chunked run."""
    t = run.traffic
    eng = st["eng"]
    eng.set_inputs(st["bank"][i % t["cond_bank"]],
                   st["sels"][i % t["selector_bank"]])
    with span("generate"):
        return eng.run_chunks(t["chunk"], lambda y, off, n: None,
                              t["samples"], t["batch"])


def window(run, st: dict) -> None:
    t = run.traffic
    sync(run.device)
    run.open_window()
    i = 0
    while True:
        st["outputs"].append(request(run, st, i))
        i += 1
        if run.unit_done() >= run.seconds:
            break
    run.close_window()
    run.counts.update(requests=i, batch=t["batch"], samples=t["samples"],
                      chunk=t["chunk"])
    run.attempted = i


def release(run, st: dict) -> None:
    for k in ("eng", "bank", "sels"):
        st.pop(k, None)


def check(run, st: dict) -> None:
    """Hold a sample of the window's requests against the reference."""
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
        za = wavenet_ref.teacher_forced_logits(
            params, c, bank[i % t["cond_bank"]], y)
        g = wavenet_ref.selector_gaps(za, y, sel)
        widest = max(widest, g["widest_gap"])
        outside += g["outside"]
        n += g["samples"]
    run.compare("widest_sel_gap", widest, t["limits"]["widest_sel_gap"])
    run.compare("malformed_requests", run.failed, 0)
    run.notes.update(checked_requests=picks, samples_checked=n,
                     samples_outside=outside)
