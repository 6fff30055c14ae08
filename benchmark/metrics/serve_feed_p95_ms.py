"""The 95th percentile of every feed's wall time in the window, from the
`feed` call to its numpy result (the time to a chunk), in ms."""

import numpy as np


def read(run):
    feeds = run.spans.get("feed")
    return float(np.percentile(feeds, 95)) * 1e3 if feeds else None
