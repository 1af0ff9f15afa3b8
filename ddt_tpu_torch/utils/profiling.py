"""Phase timings and whole-run profiler capture (port of
ddt_tpu/utils/profiling.py).

- PhaseTimer: per-phase time of the training phases. On a card each
  phase is a pair of CUDA events recorded on the current stream (the
  stream the phase's work was queued on), and the pairs are read at the
  end: `totals`, `as_json()` and `report()` synchronize once on the last
  event, never once a phase. A phase is then the device time from its
  first queued op to its last, plus any wait for the host in between. On
  the CPU a phase is host wall time.

  Phases nest: a phase opened inside another is billed to itself, and
  its time is taken out of the enclosing phase's (the Driver's profiled
  `grow` phase holds the `hist` and `gain` phases the ops open, and keeps
  the rest: routing, leaves, the collectives), so the phases of a round
  sum to its time and no time is counted twice.

- trace(log_dir): a torch.profiler capture of CPU and CUDA activity
  around a block (`--trace-dir`), written as a Chrome trace JSON into
  log_dir.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

#: Closed phases held before the completed ones are read (a non-blocking
#: query of each end event; an unfinished one stays queued), so a long
#: run's events stay bounded without a sync.
_FOLD_AT = 4096


class _Open:
    """One open phase: its name, its start mark, the time its closed
    children took, and its parent."""

    __slots__ = ("name", "start", "child_ms", "parent")

    def __init__(self, name, start, parent):
        self.name = name
        self.start = start
        self.child_ms = 0.0
        self.parent = parent


class PhaseTimer:
    """Accumulate time per named phase; report ms and share.

    `device`: where the timed work runs. A CUDA device times phases with
    events on its current stream; None or the CPU with perf_counter."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._device = dev
        self._totals: dict[str, float] = defaultdict(float)   # seconds
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list[_Open] = []
        self._closed: list[tuple] = []       # (open phase, end event)

    def _mark(self):
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    @contextlib.contextmanager
    def phase(self, name: str):
        op = _Open(name, self._mark(),
                   self._stack[-1] if self._stack else None)
        self._stack.append(op)
        try:
            yield
        finally:
            self._stack.pop()
            end = self._mark()
            self.counts[name] += 1
            if self._cuda:
                self._closed.append((op, end))
                if len(self._closed) >= _FOLD_AT:
                    self._fold(block=False)
            else:
                self._bill(op, end - op.start)

    def _bill(self, op: _Open, seconds: float) -> None:
        self._totals[op.name] += seconds - op.child_ms / 1e3
        if op.parent is not None:
            op.parent.child_ms += seconds * 1e3

    def _fold(self, block: bool) -> None:
        """Read the closed phases' events in closing order (a child
        closes before its parent, so its time is in the parent's before
        the parent is read); with block=False stop at the first one the
        card has not reached."""
        if not self._closed:
            return
        if block:
            self._closed[-1][1].synchronize()
        n = 0
        for op, end in self._closed:
            if not block and not end.query():
                break
            self._bill(op, op.start.elapsed_time(end) / 1e3)
            n += 1
        del self._closed[:n]

    @property
    def totals(self) -> dict[str, float]:
        """Seconds per phase (exclusive of nested phases). On a card this
        reads every pending event: one synchronize."""
        self._fold(block=True)
        return self._totals

    def as_json(self) -> list[dict]:
        """The phase breakdown as embedded in the run log's
        `phase_timings.phases` (the reference's keys: phase, ms_total,
        ms_per_call, calls, share)."""
        totals = self.totals
        total = sum(totals.values()) or 1.0
        return [
            {
                "phase": k,
                "ms_total": round(v * 1e3, 2),
                "ms_per_call": round(v * 1e3 / max(1, self.counts[k]), 3),
                "calls": self.counts[k],
                "share": round(v / total, 3),
            }
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
        ]

    def report(self) -> list[dict]:
        """as_json() under the name the Driver logs with."""
        return self.as_json()

    def log_report(self, logger) -> None:
        """The INFO-level phase table of every trainer."""
        for rec in self.as_json():
            logger.info("phase %-12s %8.2f ms total  %7.3f ms/call  "
                        "x%-5d %5.1f%%", rec["phase"], rec["ms_total"],
                        rec["ms_per_call"], rec["calls"],
                        100 * rec["share"])


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture of CPU and CUDA activity around the block:
    `with trace("/tmp/prof"): fit()`; the Chrome trace lands in
    log_dir/trace.json (open it in ui.perfetto.dev). The `ddt:<phase>`
    spans of telemetry.annotations show on the host track."""
    from torch.profiler import ProfilerActivity, profile

    from ddt_tpu_torch.telemetry import annotations

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof, annotations.tracing():
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
