"""Admission batching: coalesce concurrent small requests into micro-batches.

Port of ddt_tpu/serve/batcher.py (stdlib only; the logic is the
reference's). Submitters enqueue and one dispatcher thread admits work in
micro-batches:

- a batch closes when `max_wait_ms` has elapsed since its OLDEST admitted
  request (the deadline is pinned to that request when its window opens
  and never re-armed by later arrivals, so a steady trickle cannot stretch
  a batch past the head request's budget), or when it reaches `max_batch`
  rows;
- the dispatcher never sleeps: it parks on a Condition and wakes on
  submit, so an idle server burns nothing;
- express lane: when the queue is empty and no batch is mid-dispatch, a
  single-row request skips the admission window and `express()` scores it
  on the caller's thread. Under load the lane closes (queue non-empty, or
  the dispatch gate held) and requests coalesce as before. The gate is
  held around every dispatch, so an express dispatch and a batch dispatch
  never overlap on the device;
- requests are never split across batches and never reordered within
  one: each remembers its row count, so the dispatcher's scatter is
  positional and a request's rows can neither drop nor duplicate.

Driven mode (serve/fleet.py): with `cv=` the batcher shares the fleet's
one Condition and, with `own_thread=False`, has no dispatcher thread of
its own; the fleet's single dispatcher drives it through the *_locked
surface (called with that Condition held) and `dispatch_under_gate`.
`request_traces=False` turns the per-request trace marks off (a
client-supplied trace id is still echoed).

No `time.sleep` and no file I/O in here: a blocked dispatcher stalls
every in-flight request.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import uuid


class ShuttingDown(RuntimeError):
    """Raised to waiters whose request cannot be served because the
    batcher is closing."""


#: Trace ids: a random process prefix and a monotonic sequence.
_TRACE_PREFIX = uuid.uuid4().hex[:12]
_TRACE_SEQ = itertools.count(1)


def _gen_trace_id() -> str:
    return f"{_TRACE_PREFIX}-{next(_TRACE_SEQ):08x}"


def trace_breakdown(req: "PendingRequest") -> "dict | None":
    """A completed request's timing breakdown, in ms on the batcher's
    clock: handler_ms (accept -> admit), queue_ms (admit -> dispatch gate),
    gate_ms (batch assembly: width checks, binning, concat), device_ms
    (the scoring call), wake_ms (scoring done -> result published) and
    total_ms. None for a request not yet delivered."""
    m = req.marks
    if m is None or "wake" not in m:
        return None
    acc = m["accept"]
    adm = m.get("admit", acc)
    gate = m.get("gate", adm)
    dev = m.get("device", gate)
    done = m.get("done", dev)
    wake = m["wake"]
    return {
        "handler_ms": round((adm - acc) * 1e3, 3),
        "queue_ms": round((gate - adm) * 1e3, 3),
        "gate_ms": round((dev - gate) * 1e3, 3),
        "device_ms": round((done - dev) * 1e3, 3),
        "wake_ms": round((wake - done) * 1e3, 3),
        "total_ms": round((wake - acc) * 1e3, 3),
    }


class PendingRequest:
    """One submitted request: rows in, scores (or an exception) out.

    `result()` blocks the submitter only; the dispatcher signals after the
    scatter. `t_submit` is stamped at enqueue, so the latency covers queue
    wait, admission window and dispatch. `model_token` is stamped by the
    dispatcher with the token of the model that actually scored this
    request (reading the engine's token around submit/result instead races
    a hot swap). `express` marks a request the express lane dispatched.
    `trace_id`/`marks` carry the request trace (trace_breakdown); marks
    are None with request traces off and on a request made outside a
    MicroBatcher."""

    __slots__ = ("rows", "n", "t_submit", "model_token", "express",
                 "trace_id", "marks", "_event", "_result", "_error")

    def __init__(self, rows, n: int):
        self.rows = rows
        self.n = n
        self.t_submit = time.perf_counter()
        self.model_token = None
        self.express = False
        self.trace_id = None
        self.marks = None
        self._event = threading.Event()
        self._result = None
        self._error = None

    def set_result(self, scores) -> None:
        self._result = scores
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve request timed out")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self) -> "BaseException | None":
        """The delivered error without raising it (None while pending or
        on success): the fleet's express path reads it to turn an
        eviction racing the lane into a reload and a requeue."""
        return self._error


class MicroBatcher:
    """The admission queue and its dispatcher thread.

    `dispatch(batch: list[PendingRequest], queue_depth: int)` is called
    with the admitted batch (total rows <= max_batch unless one oversize
    request exceeds it alone; those dispatch solo) and the queue depth at
    close time. The dispatch callable delivers every request's result or
    error; if it raises, the batcher fails the batch's requests with the
    exception so no submitter hangs. `cv` / `own_thread=False` is the
    driven mode (module docstring)."""

    def __init__(self, dispatch, max_wait_ms: float = 1.0,
                 max_batch: int = 256, clock=None, cv=None,
                 own_thread: bool = True, request_traces: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._dispatch = dispatch
        self.request_traces = bool(request_traces)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_batch = int(max_batch)
        # Injectable clock for t_submit stamps and deadline arithmetic
        # (tests drive the deadline with a fake clock); the Condition
        # waits themselves are real time.
        self._clock = clock if clock is not None else time.perf_counter
        self._q: collections.deque[PendingRequest] = collections.deque()
        self._cv = threading.Condition()
        if cv is not None:
            # Driven mode shares the fleet's Condition (reentrant), so its
            # one dispatcher parks on every model's queue at once.
            self._cv = cv
        # Held around every dispatch, batch loop and express lane alike.
        self._gate = threading.Lock()
        self._closed = False
        self._thread = None
        if own_thread:
            self._thread = threading.Thread(
                target=self._loop, name="ddt-serve-batcher", daemon=True)
            self._thread.start()

    def submit(self, rows, n: int,
               trace_id: "str | None" = None) -> PendingRequest:
        """Enqueue one request (`rows` its row block, `n` its row count).
        Returns at once; wait on the PendingRequest."""
        req = PendingRequest(rows, n)
        t = self._clock()
        req.t_submit = t
        if self.request_traces:
            req.trace_id = trace_id if trace_id else _gen_trace_id()
            # The clock rides along so the dispatch body stamps its marks
            # on the same timebase.
            req.marks = {"_clock": self._clock, "accept": t}
        else:
            req.trace_id = trace_id
        with self._cv:
            if self._closed:
                raise ShuttingDown("serve batcher is shut down")
            self._q.append(req)
            if req.marks is not None:
                req.marks["admit"] = self._clock()
            self._cv.notify_all()
        return req

    def express(self, rows, n: int,
                trace_id: "str | None" = None) -> "PendingRequest | None":
        """Dispatch ONE request on the calling thread, bypassing the
        admission window, when the lane is open (queue empty, dispatch
        gate free). Returns the completed request, or None when the lane
        is closed and the caller should `submit()`. The lane is entered
        only from an empty queue, so no queued request is overtaken."""
        with self._cv:
            if self._closed:
                raise ShuttingDown("serve batcher is shut down")
            if self._q:
                return None                  # load: coalesce as before
            if not self._gate.acquire(blocking=False):
                return None                  # a dispatch is in flight
        # The try opens right after a successful acquire: any raise before
        # the release would otherwise leak the gate and close the lane
        # (and stall the dispatcher) for good.
        try:
            req = PendingRequest(rows, n)
            t = self._clock()
            req.t_submit = t
            req.express = True
            if self.request_traces:
                req.trace_id = trace_id if trace_id else _gen_trace_id()
                req.marks = {"_clock": self._clock, "accept": t,
                             "admit": t}
            else:
                req.trace_id = trace_id
            try:
                self._dispatch([req], 0)
            # Same contract as the dispatcher loop: a scoring failure
            # reaches this request's waiter.
            except Exception as e:
                if not req.done():
                    req.set_error(e)
        finally:
            self._gate.release()
        return req

    def backlog_rows(self) -> int:
        """Live queued-row count (read-only)."""
        with self._cv:
            return self.backlog_rows_locked()

    def close(self, timeout: float = 5.0) -> None:
        """Stop admitting, drain what is queued, join the dispatcher (a
        driven batcher has no thread: the fleet loop drains it)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------------ #
    # the fleet dispatcher's surface (serve/fleet.py), called with the shared
    # Condition held; none of these takes a lock itself
    # ------------------------------------------------------------------ #

    def backlog_rows_locked(self) -> int:
        return sum(r.n for r in self._q)

    def head_deadline_locked(self) -> "float | None":
        """Admission deadline of the oldest queued request (pinned to it,
        as in `_loop`), or None on an empty queue."""
        if not self._q:
            return None
        return self._q[0].t_submit + self.max_wait_s

    def ready_locked(self, now: float) -> bool:
        """True when a batch should close now: the head request's window
        expired, or the row budget is full."""
        if not self._q:
            return False
        if self._q[0].t_submit + self.max_wait_s <= now:
            return True
        return self.backlog_rows_locked() >= self.max_batch

    def admit_locked(self) -> "tuple[list[PendingRequest], int]":
        """Pop the next micro-batch for the fleet dispatcher (the same FIFO,
        never-split admission as the owned loop)."""
        return self._admit_locked()

    def fail_pending_locked(self, err: BaseException) -> int:
        """Fail every queued request with `err` (the fleet's remove
        path); returns how many waiters were failed."""
        n = 0
        while self._q:
            self._q.popleft().set_error(err)
            n += 1
        return n

    def dispatch_under_gate(self, fn, batch, depth: int) -> None:
        """Run one admitted batch through `fn(batch, depth)` under the
        dispatch gate (never overlapping an express dispatch of the same
        model); a raising `fn` fails the batch's waiters instead of the
        dispatcher thread."""
        try:
            with self._gate:
                fn(batch, depth)
        except Exception as e:
            for req in batch:
                if not req.done():
                    req.set_error(e)

    def _admit_locked(self) -> "tuple[list[PendingRequest], int]":
        """Pop the next micro-batch (lock held, queue non-empty): FIFO
        until the row budget is hit; an over-budget first request
        dispatches alone."""
        batch: list[PendingRequest] = []
        rows = 0
        while self._q:
            nxt = self._q[0]
            if batch and rows + nxt.n > self.max_batch:
                break
            batch.append(self._q.popleft())
            rows += nxt.n
            if rows >= self.max_batch:
                break
        return batch, len(self._q)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return                       # closed and drained
                # Admission window: the deadline is computed once from
                # the oldest queued request and never re-armed in the wake
                # loop below.
                deadline = self._q[0].t_submit + self.max_wait_s
                while (not self._closed
                       and sum(r.n for r in self._q) < self.max_batch):
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                    if not self._q:              # spurious wake post-drain
                        break
                if not self._q:
                    continue
                batch, depth = self._admit_locked()
            try:
                with self._gate:
                    self._dispatch(batch, depth)
            # The dispatcher thread must survive any scoring failure:
            # deliver it to the batch's waiters and keep serving.
            except Exception as e:
                for req in batch:
                    if not req.done():
                        req.set_error(e)
