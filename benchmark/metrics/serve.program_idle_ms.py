"""The card's idle ms inside the program's `nvw:feed_device` spans, a
traced feed: the time the card waits on `feed_device`'s host work, K5's
launch included, while the host is inside the call."""

from benchmark import program_trace


def read(run):
    return program_trace.idle_ms_per(run, "feed_device")
