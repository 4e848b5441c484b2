"""Structured span tracer (copy of `mastic_tpu/obs/trace.py`).

A span is one timed operation with attributes and point-in-time
events; spans nest through an explicit parent link, so a trace of a
service epoch reconstructs the epoch -> round -> chunk hierarchy that
the scattered `extra` dicts could never express.  Design constraints
the runtime imposes:

* **cheap when idle** — starting/ending a span is a few dict ops and
  one `time.perf_counter()` pair; no I/O unless `MASTIC_TRACE_FILE`
  is set, so tracing is always on;
* **bounded memory** — finished spans land in a ring buffer
  (default 4096); eviction is counted (`dropped()`), never silent;
* **one clock with the device trace** — the epoch is read on the wall
  clock too (`epoch_wall_ns`, `time.time_ns`), and `wall_ns` turns a
  span's `t_start_ms` into wall nanoseconds, the clock of a
  `torch.profiler` trace's device events;
* **thread-aware** — the active-span stack is thread-local (the
  statusz server thread must not adopt the scheduler's spans), while
  the ring and the JSONL sink are lock-protected so any thread may
  finish a span;
* **crash-friendly JSONL** — with `MASTIC_TRACE_FILE=path` every
  finished span appends one JSON line (O_APPEND, single write), so a
  killed process loses at most the span in flight and two processes
  sharing the file interleave whole lines.

Span records (`Span.as_dict`, the JSONL line) carry:

    name, span_id, parent_id, t_start_ms, duration_ms, attrs, events

where `t_start_ms` is milliseconds on the tracer's monotonic epoch
(comparable within one process; `Tracer.wall_ns` places it on the
wall clock) and each event is
`{"name", "t_ms", "attrs"}`.  `read_jsonl` / `build_tree` reconstruct
the hierarchy for tests and offline diffing — bench runs and the live
service emit the same schema, so their traces diff directly.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Iterator, Optional

# Ring capacity.  A chunked round from the root leaves 2 spans and 10 a
# chunk (`chunk.stage` with both aggregators' `vidpf.eval_full`,
# `prep.eval_proof` and `prep.weight_check` and `round.checks`,
# `chunk.collect` with `collect.wait`): a 100 000-report
# attribute job in 7 chunks leaves 72, so 4096 hold ~55 jobs.  A chunked
# incremental round leaves 1 and 3 a chunk: a 256-level collection in 8
# chunks leaves 6400, and the ring keeps its last ~160 rounds.
DEFAULT_CAPACITY = 4096


class Span:
    """One timed operation.  Created by Tracer.span / start_span;
    by convention mutated only by its owning thread until `end`, and
    the convention is enforced: every post-construction mutation
    happens under the span's own lock, so a mis-shared span degrades
    to racy-but-sound instead of torn."""

    __slots__ = ("name", "span_id", "parent_id", "t_start_ms",
                 "duration_ms", "attrs", "events", "_tracer",
                 "_lock")

    def __init__(self, name: str, span_id: int,
                 parent_id: Optional[int], t_start_ms: float,
                 attrs: dict, tracer: "Tracer",
                 duration_ms: Optional[float] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start_ms = t_start_ms
        # Pre-set only by Tracer.record_span (the already-finished
        # single-call form); live spans get it at end_span.
        self.duration_ms: Optional[float] = duration_ms
        self.attrs = attrs
        self.events: list = []
        self._tracer = tracer
        self._lock = threading.Lock()

    def set(self, **attrs) -> "Span":
        with self._lock:
            self.attrs.update(attrs)
        return self

    def set_default(self, name: str, value) -> None:
        """`attrs.setdefault`, under the span lock (the error-attr
        stamp the drivers' collect paths use)."""
        with self._lock:
            self.attrs.setdefault(name, value)

    def event(self, name: str, **attrs) -> None:
        t_ms = round(self._tracer.now_ms(), 3)
        with self._lock:
            self.events.append({
                "name": name,
                "t_ms": t_ms,
                "attrs": attrs,
            })

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start_ms": round(self.t_start_ms, 3),
            "duration_ms": (None if self.duration_ms is None
                            else round(self.duration_ms, 3)),
            "attrs": self.attrs,
            "events": self.events,
        }


class _SpanContext:
    """Context-manager wrapper so `with tracer.span(...) as sp:` both
    times the block and pops the thread-local stack on exit."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._span.set_default("error", exc_type.__name__)
        self._tracer.end_span(self._span)


class _ParentContext:
    """Push an ALREADY-OPEN span as the current parent without timing
    it (the service scheduler holds an epoch span open across many
    `step()` quanta; each quantum's round span must still parent to
    it)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Optional[Span]):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Optional[Span]:
        if self._span is not None:
            self._tracer._stack().append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is None:
            return
        stack = self._tracer._stack()
        if stack and stack[-1] is self._span:
            stack.pop()


class Tracer:
    """The process-wide span recorder (module singleton via
    `get_tracer`; tests build private instances)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 trace_file: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._finished = 0
        self._seq = 0
        self._local = threading.local()
        # The epoch on both clocks, read back to back: spans are timed
        # on the monotonic one, and placed on the wall clock by it.
        self._epoch = time.perf_counter()
        self.epoch_wall_ns = time.time_ns()
        # The JSONL sink: explicit arg wins; otherwise the env lever,
        # read once at construction (configure() rebuilds the
        # singleton, so a long-lived process CAN be re-aimed).
        self.trace_file = (trace_file
                           if trace_file is not None
                           else os.environ.get("MASTIC_TRACE_FILE")
                           or None)

    # -- clock / stack plumbing ------------------------------------

    def now_ms(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e3

    def wall_ns(self, t_ms: float) -> int:
        """A time on this tracer's clock (a span's `t_start_ms`, or its
        end, `t_start_ms + duration_ms`) in wall-clock nanoseconds
        (`time.time_ns`)."""
        return self.epoch_wall_ns + round(t_ms * 1e6)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- span lifecycle --------------------------------------------

    def start_span(self, name: str, parent: Optional[Span] = None,
                   **attrs) -> Span:
        """Open a span and make it the thread's current parent.  The
        caller MUST pass it to `end_span` (or use `span()` for the
        with-block form)."""
        with self._lock:
            self._seq += 1
            span_id = self._seq
        if parent is None:
            parent = self.current()
        sp = Span(name, span_id,
                  parent.span_id if parent is not None else None,
                  self.now_ms(), dict(attrs), self)
        self._stack().append(sp)
        return sp

    def start_detached_span(self, name: str,
                            parent: Optional[Span] = None,
                            **attrs) -> Span:
        """Open a span WITHOUT making it the thread's current parent
        — for long-lived spans that interleave (the service holds one
        epoch span per tenant open across round-robined quanta; each
        quantum adopts the right one via `use_parent`)."""
        sp = self.start_span(name, parent, **attrs)
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        return sp

    def record_span(self, name: str, duration_ms: float = 0.0,
                    parent: Optional[Span] = None, **attrs) -> Span:
        """One ALREADY-FINISHED span in a single call — the form for
        server/handler threads: every field lands in the
        constructor, so there is no post-construction mutation for
        another thread to race, and the ring/sink append is the same lock-guarded
        `_record` every span takes.  Never touches the thread-local
        stack."""
        with self._lock:
            self._seq += 1
            span_id = self._seq
        sp = Span(name, span_id,
                  parent.span_id if parent is not None else None,
                  self.now_ms() - duration_ms, dict(attrs), self,
                  duration_ms=duration_ms)
        self._record(sp)
        return sp

    def end_span(self, span: Span) -> None:
        # Under the tracer lock: ending is the only cross-thread-
        # visible mutation a span ever gets (record_span's are all
        # constructor-time), and the ring append below re-takes the
        # same lock anyway.
        with self._lock:
            span.duration_ms = self.now_ms() - span.t_start_ms
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            # Ended out of order (nested spans closed non-LIFO):
            # remove wherever it sits, keep going.  Detached spans
            # (start_detached_span) are never on the stack at all.
            stack.remove(span)
        self._record(span)

    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> _SpanContext:
        """`with tracer.span("round", level=3) as sp:` — times the
        block, pops on exit, records an `error` attr on exception."""
        return _SpanContext(self, self.start_span(name, parent,
                                                  **attrs))

    def use_parent(self, span: Optional[Span]) -> _ParentContext:
        """Adopt an open span as the current parent for a block
        without re-timing it (see _ParentContext)."""
        return _ParentContext(self, span)

    def event(self, name: str, **attrs) -> None:
        """Attach a point-in-time event to the current span; with no
        span open, record a standalone zero-duration span so the
        event still reaches the ring and the JSONL sink (the session
        layer's retry events fire outside any span in the in-process
        fault tests)."""
        cur = self.current()
        if cur is not None:
            cur.event(name, **attrs)
            return
        # The marker rides the constructor (record_span discipline:
        # no post-construction span mutation off the owning thread).
        sp = self.start_span(name, standalone_event=True, **attrs)
        self.end_span(sp)

    # -- ring / sink -----------------------------------------------

    def _record(self, span: Span) -> None:
        line = None
        if self.trace_file:
            line = json.dumps(span.as_dict(),
                              separators=(",", ":")) + "\n"
        with self._lock:
            evicted = len(self._ring) == self._ring.maxlen
            if evicted:
                self._dropped += 1
            self._ring.append(span)
            self._finished += 1
        # Mirror into the registry so span volume / ring pressure is
        # scrapeable (imported here, not at module top, purely to
        # keep the two singletons independently replaceable in tests).
        from .registry import get_registry

        get_registry().counter("mastic_trace_spans_total").inc()
        if evicted:
            get_registry().counter(
                "mastic_trace_spans_dropped_total").inc()
        if line is not None:
            # One write per span, append mode: whole lines interleave
            # safely when party subprocesses share the file.
            with open(self.trace_file, "a") as f:
                f.write(line)

    def spans(self) -> list:
        """Finished spans currently in the ring (snapshot copy)."""
        with self._lock:
            return list(self._ring)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def finished(self) -> int:
        with self._lock:
            return self._finished

    def snapshot(self) -> dict:
        """JSON-able tracer state for /varz."""
        with self._lock:
            return {
                "capacity": self._ring.maxlen,
                "buffered": len(self._ring),
                "finished": self._finished,
                "dropped": self._dropped,
                "trace_file": self.trace_file,
            }


# -- the process-wide singleton ---------------------------------------

_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def configure(capacity: int = DEFAULT_CAPACITY,
              trace_file: Optional[str] = None) -> Tracer:
    """Rebuild the singleton (tests, and long-lived processes that
    re-aim the JSONL sink).  Passing trace_file=None re-reads the
    MASTIC_TRACE_FILE lever."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(capacity=capacity, trace_file=trace_file)
    return _tracer


def span(name: str, **attrs) -> _SpanContext:
    """Module-level convenience: `with trace.span("round", ...):`."""
    return get_tracer().span(name, **attrs)


def event(name: str, **attrs) -> None:
    get_tracer().event(name, **attrs)


# -- offline reconstruction (tests, trace diffing) ---------------------

def read_jsonl(path: str) -> list:
    """Parse a MASTIC_TRACE_FILE back into span dicts.  Truncated
    final lines (a crash mid-write) are skipped, not fatal."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                # A torn tail line from a killed writer is expected;
                # whole spans before it are intact.
                continue
    return out


def build_tree(spans: list) -> dict:
    """span_id -> list of child span dicts (roots under key None),
    children in start order — the hierarchy assertion helper."""
    tree: dict = {}
    for sp in sorted(spans, key=lambda s: s["t_start_ms"]):
        tree.setdefault(sp["parent_id"], []).append(sp)
    return tree


def walk(spans: list, name: str) -> Iterator[dict]:
    """Spans with a given name, in start order."""
    for sp in sorted(spans, key=lambda s: s["t_start_ms"]):
        if sp["name"] == name:
            yield sp
