"""The generation step's share of the card's fp32 peak: `work.step_flops`
x the samples generated (every utterance) / seconds / 67 TFLOP/s, in %,
over the window (in a traced run, its part after the profiler stopped).
The card's power limit is beside it in `device`."""

from benchmark import work


def read(run):
    part = run.untraced()
    c = run.counts
    if part is None or not c.get("requests"):
        return None
    u, seconds = part
    flops = (work.step_flops(run.cfg) * (c["requests"] - u) * c["batch"]
             * c["samples"])
    return 100.0 * flops / seconds / work.PEAK_FP32_FLOPS
