"""Traffic kind "serve": streaming feeds into the slots of one engine,
closed loop, with continuous batching.

`begin_stream(slots)`, then tick after tick one ragged feed
`feed(cond, sel, lengths=...)`: each row gets 0 samples with probability
`p_stall` (its front end has nothing yet), else U{tick_min..tick_max},
capped at what its utterance has left.  Utterance lengths are
U{utt_min..utt_max}; a finished slot is handed to the next utterance of an
unbounded backlog by `reset_utterances` before the next tick.  Each
utterance's conditioning and injected selectors are drawn on the card when
it is admitted, into the slot's rows of one buffer; a tick's chunk is
gathered from there by the slots' clocks.  The schedule comes from the
seed alone, never from the samples.

A feed's time runs from the call to its numpy result: `feed` is
`feed_device` and the read-back, and the two are timed apart here
(`feed_device`'s host time is the staging, prefold and launch).

The check: a sample of the utterances completed in the window, drawn from
the seed with the longest among them, each held against the plain
reference generating it alone, teacher-forced on its served samples.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.mixes import offline
from benchmark.reference import wavenet_ref
from benchmark.tracing import span, sync


def setup(run) -> dict:
    t, c = run.traffic, run.cfg
    B = t["slots"]
    eng = offline.make_engine(run, B, t["tick_max"])
    st = {"eng": eng, "rng": inputs.serve_rng(run.seed), "next_utt": 0,
          "cond": torch.empty((B, t["utt_max"], c["num_layers"], 2 * c["R"]),
                              device=run.device),
          "sel": torch.empty((B, t["utt_max"]), device=run.device),
          "slot": [None] * B, "completed": [], "tick_lens": []}
    eng.begin_stream(B)
    for b in range(B):
        admit(run, st, b)
    for _ in range(t["warmup_ticks"]):
        tick(run, st)
    sync(run.device)
    st["completed"].clear()
    st["tick_lens"].clear()
    return st


def admit(run, st: dict, b: int) -> None:
    """Hand slot b to the next utterance of the backlog."""
    t = run.traffic
    k = st["next_utt"]
    st["next_utt"] += 1
    n = int(st["rng"].integers(t["utt_min"], t["utt_max"] + 1))
    with span("admit"):
        inputs.utterance(run.cfg, t, run.seed, k, n, run.device,
                         st["cond"][b, :n], st["sel"][b, :n])
    st["slot"][b] = {"k": k, "n": n, "pos": 0, "out": []}


def tick(run, st: dict):
    """One tick: hand finished slots on, draw the lengths, gather the chunk,
    feed.  Returns (feed seconds, feed_device host seconds, lengths)."""
    t = run.traffic
    eng, rng, B = st["eng"], st["rng"], t["slots"]
    done = [b for b, u in enumerate(st["slot"]) if u["pos"] == u["n"]]
    if done:
        with span("reset"):
            eng.reset_utterances(done)
        for b in done:
            u = st["slot"][b]
            st["completed"].append({"k": u["k"], "n": u["n"],
                                    "y": np.concatenate(u["out"])})
            admit(run, st, b)
    stall = rng.random(B) < t["p_stall"]
    draw = rng.integers(t["tick_min"], t["tick_max"] + 1, size=B)
    left = np.array([u["n"] - u["pos"] for u in st["slot"]])
    lens = np.minimum(np.where(stall, 0, draw), left).astype(np.int64)
    tm = int(lens.max())
    with span("gather"):
        clocks = torch.as_tensor([u["pos"] for u in st["slot"]],
                                 device=run.device)
        idx = (clocks[None, :] + torch.arange(tm, device=run.device)[:, None]
               ).clamp_(max=t["utt_max"] - 1)
        rows = torch.arange(B, device=run.device)[None, :]
        cond = st["cond"][rows, idx].permute(0, 2, 1, 3).contiguous()
        sel = st["sel"][rows, idx]
    a = time.perf_counter()
    with span("feed"):
        y_dev = eng.feed_device(cond, sel, lengths=lens)
        b = time.perf_counter()
        y = y_dev.T.cpu().numpy()
    c = time.perf_counter()
    for r, u in enumerate(st["slot"]):
        if lens[r]:
            u["out"].append(y[r, :lens[r]])
            u["pos"] += int(lens[r])
    st["tick_lens"].append(lens)
    return c - a, b - a, lens


def window(run, st: dict) -> None:
    feed_s, device_call_s = [], []
    sync(run.device)
    run.open_window()
    while True:
        f, d, _ = tick(run, st)
        feed_s.append(f)
        device_call_s.append(d)
        if run.unit_done() >= run.seconds:
            break
    run.close_window()
    lens = np.stack(st["tick_lens"])
    run.spans.update(feed=feed_s, feed_device=device_call_s)
    run.counts.update(ticks=len(feed_s), slots=lens.shape[1],
                      live_row_steps=int(lens.sum()),
                      row_steps=int(lens.max(axis=1).sum()) * lens.shape[1],
                      completed=len(st["completed"]))
    run.lengths = lens
    run.attempted = len(feed_s)


def release(run, st: dict) -> None:
    for k in ("eng", "cond", "sel"):
        st.pop(k, None)


def check(run, st: dict) -> None:
    """Hold a sample of the completed utterances, the longest among them,
    against the reference generating each alone."""
    t, c = run.traffic, run.cfg
    done = st["completed"]
    run.compare("utterances_completed", len(done), 1, at_least=True)
    if not done:
        return
    longest = max(range(len(done)), key=lambda i: done[i]["n"])
    rng = np.random.default_rng(inputs.sub_seed(run.seed, "check"))
    rest = [i for i in range(len(done)) if i != longest]
    picks = [longest] + sorted(rng.choice(
        rest, min(t["check_utterances"] - 1, len(rest)),
        replace=False).tolist())
    run.failed = int(sum(len(u["y"]) != u["n"] or u["y"].min() < 0
                         or u["y"].max() >= c["A"] for u in done))
    params = inputs.gen_params(c, run.seed, run.device)
    widest, outside, n = 0.0, 0, 0
    for i in picks:
        u = done[i]
        cond, sel = inputs.utterance(c, t, run.seed, u["k"], u["n"],
                                     run.device)
        y = torch.as_tensor(u["y"], device=run.device)[:, None]
        if len(u["y"]) != u["n"]:
            continue
        za = wavenet_ref.teacher_forced_logits(params, c, cond[:, :, None],
                                               y)
        g = wavenet_ref.selector_gaps(za, y, sel[:, None])
        widest = max(widest, g["widest_gap"])
        outside += g["outside"]
        n += g["samples"]
    run.compare("widest_sel_gap", widest, t["limits"]["widest_sel_gap"])
    run.compare("malformed_utterances", run.failed, 0)
    run.notes.update(checked_utterances=[done[i]["k"] for i in picks],
                     samples_checked=n, samples_outside=outside)
