"""Device ms a step in NCCL kernels on rank 0's card, over the traced
steps; nothing on one card."""


def read(run):
    tr = run.trace_summary
    if run.world == 1 or not tr or not run.tracer.units:
        return None
    return tr["nccl_s"] / run.tracer.units * 1e3
