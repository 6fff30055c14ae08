"""The median host ms of the program's `nvw:feed.launch` span over the
traced feeds: the generator's call, from its argument checks and weight
storage lookup through the pinned clocks and lengths and the output's
allocation to K5's ctypes launch.  Read from the traced seconds, so the
profiler's overhead is in it."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms(run, "feed.launch")
