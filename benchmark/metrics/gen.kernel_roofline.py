"""The frozen bound of the traced requests' launches (`work.py`: each
launch `chunk` steps of `batch` rows) over the device time of every op
launched inside the engine's generation calls, in %.  Ops are tied to the
calls by correlation, not by name, so a kernel that replaces K1 reads the
same work."""

from benchmark import work


def read(run):
    tr = run.trace_summary
    if not tr or not run.counts.get("requests"):
        return None
    dev = tr["device_s_in"].get("generate", 0.0)
    units = run.tracer.units
    if dev <= 0 or not units:
        return None
    c = run.counts
    full, last = divmod(c["samples"], c["chunk"])
    bound = (full * work.launch_bound_s(run.cfg, c["batch"], c["chunk"])
             + (work.launch_bound_s(run.cfg, c["batch"], last) if last
                else 0.0))
    return 100.0 * units * bound / dev
