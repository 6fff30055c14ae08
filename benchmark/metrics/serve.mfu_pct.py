"""The serving step's share of the card's fp32 peak: `work.step_flops` x
live samples / seconds / 67 TFLOP/s, in %, over the window (in a traced
run, its part after the profiler stopped)."""

from benchmark import work


def read(run):
    part = run.untraced()
    if part is None or run.lengths is None:
        return None
    u, seconds = part
    live = int(run.lengths[u:].sum())
    return (100.0 * work.step_flops(run.cfg) * live / seconds
            / work.PEAK_FP32_FLOPS)
