"""The median host time of `feed_device` until it returns: staging,
prefold and launch, in ms (the benchmark's span around it), over the
window's feeds (in a traced run, those after the profiler stopped)."""

import numpy as np


def read(run):
    part = run.untraced()
    calls = run.spans.get("feed_device")
    if part is None or not calls or part[0] >= len(calls):
        return None
    return float(np.median(calls[part[0]:])) * 1e3
