"""The traced window: `torch.profiler` around part of the window, and what
the metric readers take from it.

Every event is placed on the host's clock.  A device event is tied to the
runtime call that launched it by their correlation id, and so to the
benchmark's host ranges (`bench:<span>`) and to the thread that launched
it (autograd's thread runs the backward).  From that:

  * busy_s: the union of device intervals inside the traced window;
  * device_s_in[span]: device seconds of every op launched inside a span;
  * backward_s: device seconds of ops launched from autograd's threads;
  * nccl_s: device seconds of NCCL kernels;
  * breakdown: the device ops that took most time, and the idle gaps of
    the device by the host span that covered them most.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

SPAN_PREFIX = "bench:"
TRACED = "traced"


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host range the trace can see (a cheap `record_function` when no
    profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """The profiler over the first `seconds` of a window: `start()` as the
    window opens, `poll(elapsed)` after each unit of work (it stops the
    profiler once `elapsed` reaches `seconds`), `stop()` at the latest as
    the window closes, then `summary()`.  Disabled, every call is a
    no-op and `summary()` is None."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled, self.seconds = enabled, seconds
        self.prof = self._range = None
        self.done = False
        self.units = 0   # units of work (polls) inside the traced range
        self.resumed = None   # the host clock once the profiler stopped

    @staticmethod
    def _activities() -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that attaching
        CUPTI (seconds) is not inside the window, where on several cards
        each rank would attach at its own time and the others' collectives
        would wait for it."""
        if self.enabled:
            with torch.profiler.profile(activities=self._activities()):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled:
            return
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self._range = span(TRACED)
        self._range.__enter__()

    def poll(self, elapsed: float) -> None:
        if self.prof is None or self.done:
            return
        self.units += 1
        if elapsed >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.done = True
        self.resumed = time.perf_counter()

    def summary(self) -> Optional[dict]:
        self.stop()
        return summarize(self.prof) if self.prof is not None else None


def _on_card(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Ranges:
    """Sorted host intervals of one span name, for point lookups."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.iv[i][0] <= t <= self.iv[i][1]

    def overlap(self, a: float, b: float) -> float:
        """The length of [a, b] that the intervals cover (one span name's
        intervals follow one another)."""
        c, i = 0.0, bisect.bisect_left(self.starts, b) - 1
        while i >= 0 and self.iv[i][1] > a:
            c += max(0.0, min(b, self.iv[i][1]) - max(a, self.iv[i][0]))
            i -= 1
        return c


def summarize(prof) -> dict:
    """The trace's readings (seconds)."""
    events = list(prof.events())
    host = {}
    for e in events:
        if e.name.startswith(SPAN_PREFIX) and not _on_card(e):
            host.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    if TRACED not in host:
        raise RuntimeError("the trace holds no traced range")
    w0, w1 = host.pop(TRACED)[0]
    launch = {e.id: (e.time_range.start, e.thread) for e in events
              if not _on_card(e) and e.name.startswith("cu")}
    autograd = {e.thread for e in events
                if e.name.startswith("autograd::engine::evaluate_function")}
    ranges = {k: _Ranges(v) for k, v in host.items()}
    dev = []
    for e in events:
        if not _on_card(e) or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(SPAN_PREFIX):
            continue
        a, b = e.time_range.start, e.time_range.end
        if b <= w0 or a >= w1:
            continue
        src = launch.get(e.id, launch.get(
            getattr(e, "linked_correlation_id", None)))
        dev.append((e.name, a, b, src))
    busy = _merge([(max(a, w0), min(b, w1)) for _, a, b, _ in dev])
    by_name: Dict[str, float] = {}
    device_in = {k: 0.0 for k in ranges}
    backward = nccl = 0.0
    for name, a, b, src in dev:
        s = (b - a) / 1e6
        by_name[name] = by_name.get(name, 0.0) + s
        if "nccl" in name.lower():
            nccl += s
        if src is None:
            continue
        for k, r in ranges.items():
            if r.holds(src[0]):
                device_in[k] += s
        if src[1] in autograd:
            backward += s
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best, cover = "host:none", 0.0
        for k, r in ranges.items():
            c = r.overlap(a, b)
            if c > cover:
                best, cover = k, c
        gaps[best] = gaps.get(best, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s_in": device_in,
            "backward_s": backward if autograd else None,
            "nccl_s": nccl,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}
