"""Spans of the port: `ddt:<name>` ranges at its layer boundaries and
around the ops' own stages (port of ddt_tpu/telemetry/annotations.py).

When a span is live. A span site (`traced_scope`, `op_scope`, and the
trainers' `phase_ctx`) is live in two cases:

- a torch profiler is recording (`torch.autograd.profiler.
  _is_profiler_enabled`, which torch.profiler sets while it records, for
  every thread of the process);
- a profiled trainer has installed its sub-phase timer (`sub_phases`):
  the span is then also that timer's phase, nested in the trainer's own
  phase (utils/profiling).

Otherwise a site costs one module-global read plus that flag's read, and
hands back the shared `nullcontext`.

A live span is a `record_function` range, so it shows on the host track
of a profiler's trace, and each idle gap of the device's timeline falls
inside the innermost span the host was in. Every name carries the
`ddt:` prefix, by which a trace's readers tell the program's ranges from
device work.

The store. Each live span is also kept in memory: its name, its start
and end in ns on the clock of torch.profiler's events (the Unix epoch,
`time.time_ns()`, read just inside the range), and its parent, the span
open below it on the same thread (a per-thread stack: scoring threads do
not parent each other's spans). Per name the store keeps the count, the
total seconds and the self seconds (a span's duration minus its
children's); raw records are kept for the last RING spans.
`span_totals()`, `span_records()` and `reset_spans()` read and clear it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

PREFIX = "ddt:"
#: Raw span records kept: the most recent this many.
RING = 1 << 16

#: What a site hands back when no span is live.
_NULL = contextlib.nullcontext()

# None, or the PhaseTimer a profiled trainer installed (`sub_phases`).
_sink = None


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int                # time.time_ns(), torch.profiler's clock
    end_ns: int
    parent: int | None           # id of the enclosing span on this thread
    thread: int                  # threading.get_ident()


class SpanStore:
    """Live spans' per-name aggregates and a bounded ring of records,
    shared by every thread; each thread keeps its own stack of open
    spans."""

    def __init__(self, ring: int = RING):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._totals: dict[str, list] = {}   # name -> [n, total, self] ns
        self._ring: collections.deque = collections.deque(maxlen=ring)

    def stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def next_id(self) -> int:
        return next(self._ids)

    def add(self, rec: SpanRecord, children_ns: int) -> None:
        d = rec.end_ns - rec.start_ns
        with self._lock:
            t = self._totals.get(rec.name)
            if t is None:
                t = self._totals[rec.name] = [0, 0, 0]
            t[0] += 1
            t[1] += d
            t[2] += d - children_ns
            self._ring.append(rec)

    def totals(self) -> dict:
        with self._lock:
            return {n: {"count": c, "total_s": tot * 1e-9,
                        "self_s": own * 1e-9}
                    for n, (c, tot, own) in self._totals.items()}

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._ring.clear()


_store = SpanStore()


def span_totals() -> dict:
    """name -> {count, total_s, self_s} of the spans closed since the
    last reset_spans(), names with their `ddt:` prefix."""
    return _store.totals()


def span_records() -> list:
    """The last RING spans closed, as SpanRecords in closing order."""
    return _store.records()


def reset_spans() -> None:
    """Drop the aggregates and the records (spans open now still close
    into the store)."""
    _store.reset()


class _Span:
    """One live span: a record_function range, the store's record, and
    with `phase` (a PhaseTimer's phase context) that phase inside it."""

    __slots__ = ("name", "phase", "_rf", "_frame")

    def __init__(self, name: str, phase=None):
        self.name = name
        self.phase = phase

    def __enter__(self):
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        # The clock next to the range's edges, where the profiler reads its
        # own.
        start = time.time_ns()
        stack = _store.stack()
        # [id, parent id, start ns, children's ns]
        self._frame = [_store.next_id(), stack[-1][0] if stack else None,
                       start, 0]
        stack.append(self._frame)
        if self.phase is not None:
            self.phase.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.phase is not None:
                self.phase.__exit__(*exc)
        finally:
            end = time.time_ns()
            self._rf.__exit__(*exc)
            sid, parent, start, children = f = self._frame
            stack = _store.stack()
            if stack and stack[-1] is f:
                stack.pop()
            if stack:
                stack[-1][3] += end - start
            _store.add(SpanRecord(sid, self.name, start, end, parent,
                                  threading.get_ident()), children)
        return False


@contextlib.contextmanager
def sub_phases(timer):
    """Install `timer` as the op scopes' timer for the block (a profiled
    trainer's granular loop); restores what was there before."""
    global _sink
    prev = _sink
    _sink = timer
    try:
        yield
    finally:
        _sink = prev


def _scope(name: str, timer):
    """The one liveness rule: `timer`'s phase `name` (or the shared
    nullcontext, without a timer) unless a profiled trainer's sub-phase
    timer is installed or a torch profiler records; then the span
    `ddt:<name>` around that phase."""
    if _sink is None and not _profiler._is_profiler_enabled:
        return _NULL if timer is None else timer.phase(name)
    return _Span(PREFIX + name, None if timer is None else timer.phase(name))


def traced_scope(name: str):
    """The span `ddt:<name>`, with the installed sub-phase timer's phase
    inside it; the shared nullcontext unless it is live (module
    docstring)."""
    return _scope(name, _sink)


def op_scope(name: str):
    """traced_scope around a whole function, as a decorator (the layer
    boundaries and ops' dispatchers whose whole body is one span)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            cm = traced_scope(name)
            if cm is _NULL:
                return fn(*args, **kwargs)
            with cm:
                return fn(*args, **kwargs)
        return wrapper
    return deco


def phase_ctx(timer):
    """Phase-context factory shared by the trainers' loops: with None,
    traced_scope; with a PhaseTimer, `ph(name)` is its phase, inside the
    span `ddt:<name>` when spans are live."""
    if timer is None:
        return traced_scope
    return functools.partial(_scope, timer=timer)
