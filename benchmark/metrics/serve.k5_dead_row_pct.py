"""Row-steps K5 runs for rows with nothing to do, out of all it runs, over
the process's ragged calls, in %: the program's counters `k5.row_steps`
(B x the longest row's steps a launch, since each of its B rows loops its
own length and the launch lasts the longest) and `k5.live_row_steps` (the
sum of the lengths)."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters()
    steps = c.get("k5.row_steps")
    if not steps:
        return None
    return 100.0 * (steps - c["k5.live_row_steps"]) / steps
