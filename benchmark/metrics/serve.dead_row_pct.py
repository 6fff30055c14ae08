"""Row-steps the ragged kernel runs for rows with nothing to do, out of all
it runs (each feed runs its longest row's steps for every row), in %."""


def read(run):
    steps = run.counts.get("row_steps")
    if not steps:
        return None
    return 100.0 * (steps - run.counts["live_row_steps"]) / steps
