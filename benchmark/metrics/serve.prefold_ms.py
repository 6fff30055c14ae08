"""The median host ms of the program's `nvw:feed.prefold` span over the
traced feeds: `feed_device` queueing the chunk's cond + dil_b on the card.
Read from the traced seconds, so the profiler's overhead is in it."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, "feed.prefold")
