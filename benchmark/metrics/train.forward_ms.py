"""Device ms a step of the ops launched inside the program's
`nvw:train.forward` span (the model and the loss), over the traced
`nvw:train.step` spans (rank 0)."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per(run, "train.forward", "train.step")
