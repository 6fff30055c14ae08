"""Samples generated per utterance over the window, over its seconds, in
kHz (nv-wavenet's `nv_wavenet_perf.cu` figure): requests x samples / s."""


def read(run):
    n = run.counts.get("requests")
    return n * run.counts["samples"] / run.window_s / 1e3 if n else None
