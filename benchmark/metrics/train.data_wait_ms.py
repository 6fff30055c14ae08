"""Host ms a step that the loop waits for its next batch from the
pipeline's device prefetch: the mean over the window's steps (in a traced
run, those after the profiler stopped; the benchmark's span around the
fetch, rank 0)."""


def read(run):
    part = run.untraced()
    fetch = run.spans.get("fetch")
    if part is None or not fetch or part[0] >= len(fetch):
        return None
    rest = fetch[part[0]:]
    return sum(rest) / len(rest) * 1e3
