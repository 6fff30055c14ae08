"""Device ms a step of the ops launched inside the program's
`nvw:train.optimizer` spans (`zero_grad` and Adam's step), over the traced
`nvw:train.step` spans (rank 0)."""

from benchmark import program_trace


def read(run):
    return program_trace.device_ms_per(run, "train.optimizer", "train.step")
