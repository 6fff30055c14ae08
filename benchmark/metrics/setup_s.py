"""Seconds from the process's start to the window's: imports, building or
loading the kernels, weights, inputs and warm-up (on several cards, rank
0's, which waits for every rank to join)."""


def read(run):
    return run.setup_s
