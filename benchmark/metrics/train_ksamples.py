"""Audio samples trained over the window (steps x clips a step across all
ranks x samples a clip), over its seconds, in thousands a second."""


def read(run):
    steps = run.counts.get("steps")
    if not steps:
        return None
    return (steps * run.counts["clips_per_step"] * run.counts["segment"]
            / run.window_s / 1e3)
