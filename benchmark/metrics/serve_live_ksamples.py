"""Live samples returned over all slots, over the window's seconds, in
thousands a second."""


def read(run):
    n = run.counts.get("live_row_steps")
    return n / run.window_s / 1e3 if n else None
