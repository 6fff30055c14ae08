"""The share of the traced window in which no op ran on the card (rank
0's card across several), in %."""


def read(run):
    tr = run.trace_summary
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
