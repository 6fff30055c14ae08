"""The frozen bound of the traced feeds' live row-steps (`work.py`, the
ragged launch of each feed) over the device time of every op launched
inside the feeds, in %."""

from benchmark import work


def read(run):
    tr = run.trace_summary
    if not tr or run.lengths is None:
        return None
    dev = tr["device_s_in"].get("feed", 0.0)
    ticks = run.lengths[:run.tracer.units]
    if dev <= 0 or not len(ticks):
        return None
    bound = sum(work.launch_bound_s(run.cfg, len(t), int(t.max()),
                                    int(t.sum()), ragged=True)
                for t in ticks if t.max() > 0)
    return 100.0 * bound / dev
