"""The harness's spans and the device trace of a `--trace 1` run.

Spans are the harness's own, on the host's wall clock (`time.time_ns`):
one around each call into the program's layers that the window makes.
The device trace is `torch.profiler` with CUDA activity only (CUPTI),
whose timestamps are on the same wall clock, over a part of the
window: its first whole collection, or one job after its untraced jobs
(a window's worth of events, over a million, takes minutes to read).
From it:

* busy time as the union of the intervals in which a kernel, a copy or
  a memset ran on the card, clipped to the traced window.  This repairs
  `profile_smoke.py::_busy`, which added up `self_device_time_total`:
  where operations overlap on several streams, that sum counts the
  overlap twice;
* device time by kernel name, for the rooflines;
* the breakdown the result line carries: the device operations that
  took most time, and the idle time grouped by the innermost harness
  span the host was in when each gap began.

The whole trace is never written out.
"""

import contextlib
import sys
import time
from collections import defaultdict
from typing import Optional


class Trace:
    """Harness spans always; the device trace between `start` and
    `stop` when `enabled` and the run is on a card.  A mode's window
    calls `start` where the part it traces begins: the whole window's
    first collection (heavy hitters), or a few jobs after the window's
    untraced ones (attribute metrics)."""

    def __init__(self, enabled: bool, on_card: bool = True):
        self.enabled = enabled and on_card
        self.spans: list = []          # (name, start_ns, end_ns)
        self.events: list = []         # (name, start_ns, end_ns)
        self.window_ns: Optional[tuple] = None
        self._prof = None
        self._t0 = time.time_ns()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def start(self) -> None:
        if self.enabled:
            import torch

            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        """Close the traced part of the window (after the caller's
        device sync) and keep the device events inside it; later calls
        do nothing.  A mode calls it once the part it traces is done, so
        that a window's trace holds one whole collection or a few jobs;
        the run calls it when the window closes (without a `start`, the
        part runs from the trace's creation)."""
        if self.window_ns is not None:
            return
        t1 = time.time_ns()
        self.window_ns = (self._t0, t1)
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        raw = self._prof.profiler.kineto_results.events()
        self.events = device_events(raw, self._t0, t1)
        self._prof = None
        print(f"portbench: {len(self.events)} device events of {len(raw)} "
              f"kept, read in {(time.time_ns() - t1) / 1e9:.1f} s",
              file=sys.stderr)

    # -- readings -----------------------------------------------------

    def window_s(self) -> float:
        (t0, t1) = self.window_ns
        return (t1 - t0) / 1e9

    def busy_s(self) -> float:
        return sum(b - a for (a, b) in merged(self.events)) / 1e9

    def kernel_ms(self, names: tuple) -> float:
        """Device milliseconds of the operations whose name contains one
        of `names`."""
        return sum(e - s for (n, s, e) in self.events
                   if any(k in n for k in names)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = defaultdict(int)
        for (name, s, e) in self.events:
            by_op[short_name(name)] += e - s
        idle: dict = defaultdict(int)
        for (a, b) in gaps(merged(self.events), self.window_ns):
            idle[self.host_at(a)] += b - a
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(idle, top)}

    def host_at(self, t: int) -> str:
        """The innermost harness span open at wall time t."""
        inside = [(s, n) for (n, s, e) in self.spans if s <= t < e]
        return max(inside)[1] if inside else "outside spans"


def device_events(events, t0: int, t1: int) -> list:
    """(name, start, end) of the kineto events that occupied the card
    (kernels, copies and memsets: with CUDA activity alone, every event
    on the device but a user annotation), clipped to [t0, t1]."""
    out = []
    for ev in events:
        if str(ev.device_type()).split(".")[-1] != "CUDA" \
                or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        (s, e) = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        (s, e) = (max(s, t0), min(e, t1))
        if e > s:
            out.append((ev.name(), s, e))
    return out


def merged(events: list) -> list:
    """The union of the events' intervals, as sorted disjoint
    (start, end) pairs."""
    out: list = []
    for (s, e) in sorted((s, e) for (_n, s, e) in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(busy: list, window: tuple) -> list:
    """The idle intervals of the window between the busy ones."""
    (t, end) = window
    out = []
    for (s, e) in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(")[0][:120]


def _top(totals: dict, top: int) -> list:
    return [[k, v / 1e9] for (k, v) in
            sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
