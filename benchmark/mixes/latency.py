"""Traffic kind "latency": the offline requests of `offline.py` on the
engine's latency tier, `priority="latency"` (the collapsed-chain kernel K6
with fast_math): set-up, window, release and check are `offline.py`'s.

K6 is governed by the TV contract, not bit-exact: a selector's gap to the
reference's interval is at most the step's TV distance from the exact
step, so the traffic's `widest_sel_gap` limit is set from the tier's own
readings (PERF.md §4).
"""

from __future__ import annotations

from benchmark.mixes import offline

window = offline.window
release = offline.release
check = offline.check


def setup(run) -> dict:
    run.engine_kw.setdefault("priority", "latency")
    return offline.setup(run)
