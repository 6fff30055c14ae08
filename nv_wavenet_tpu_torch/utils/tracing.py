"""The port's tracing: host spans on `torch.profiler`'s clock, process-wide
counters, and a Chrome trace of a region.

  * `span(name, id=None)`: a host range `nvw:<name>` where the work
    happens (the engine's feeds, the train step, the data pipeline, the
    mesh's collectives).  While no profiler runs it is one shared null
    context: no string is built and no `record_function` made.  While one
    runs it is `torch.profiler.record_function("nvw:" + name, str(id))`,
    so it lands in the same Kineto timeline as the card's events, whose
    correlation ids tie each device op to the runtime call that launched
    it inside the range.  Ranges nest by thread, which gives each its
    parent.  The profiler records the thread that started it and the
    threads autograd runs the backward on; another thread's spans (the
    data pipeline's worker) only where the profiler records every thread,
    as `trace`'s does;
  * `count(name, n)`, `counters()`: plain integers, always on (K5's
    row-steps, the data pipeline's featurising time, the collectives'
    calls and bytes); `add_source(fn)` adds counters that a function reads
    only when `counters()` is read (K1 card-wide's stamps, summed on the
    card);
  * `trace(path)`: a `torch.profiler` region over every thread, written as
    a Chrome trace (chrome://tracing, Perfetto), the card's kernels
    included when there is one.

`ops/persistent.py` imports this module, so it imports nothing of the
port.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "nvw:"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRACE_PATH = os.path.join(_REPO, "build", "traces", "trace.json")

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_SOURCES: List[Callable[[], Dict[str, int]]] = []


def span(name: str, id: Optional[int] = None):
    """`with span("feed.stage"): ...`; `id` names the request (a feed's
    count, a step) in the range's args."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name, None if id is None else str(id))


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def add_source(fn: Callable[[], Dict[str, int]]) -> None:
    """Counters that `fn()` returns, read each time `counters()` is."""
    _SOURCES.append(fn)


def counters() -> Dict[str, int]:
    """A copy of every counter, those of the sources included."""
    out = dict(_COUNTS)
    for fn in _SOURCES:
        out.update(fn())
    return out


@contextlib.contextmanager
def trace(path: str = TRACE_PATH):
    """Profile a region, `with trace(): eng.run(...)`, and write it to
    `path` as a Chrome trace.  The card's activity is recorded when CUDA is
    available, the host's always, on every thread."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    every = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=every) as prof:
        yield prof
    prof.export_chrome_trace(path)
