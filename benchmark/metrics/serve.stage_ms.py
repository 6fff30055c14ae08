"""The median host ms of the program's `nvw:feed.stage` span over the
traced feeds: `feed_device` drawing the default selectors and staging the
chunk and the selectors on the card (pinned memory, non-blocking copies).
Read from the traced seconds, so the profiler's overhead is in it."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, "feed.stage")
