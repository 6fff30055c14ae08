"""Device ms a step of the backward: ops launched from autograd's threads
in the traced steps (rank 0), over those steps."""


def read(run):
    tr = run.trace_summary
    if not tr or not tr.get("backward_s") or not run.tracer.units:
        return None
    return tr["backward_s"] / run.tracer.units * 1e3
