"""Spans of the harness and, in a traced run, torch.profiler over the
window: device time by kernel and by copy, the device's busy time, and
the longest idle gaps labelled by what the host was doing.

The harness's spans (`span`) time its own calls into the program's
layers on the host clock in every run; in a traced run they also appear
as profiler ranges, so the idle gaps can name them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time

import numpy as np
import torch


#: A kernel's name in the breakdown is cut to this many characters (a
#: template's full signature runs to thousands).
NAME_CHARS = 120
#: Names of host ranges (the harness's spans, the program's phases), which
#: the profiler also draws on the device's timeline.
RANGES = ("bench.", "setup.", "ddt:")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict          # name -> device seconds
    copies: dict           # name -> device seconds
    device_ops: list       # [[name, seconds]], the 10 largest
    idle_gaps: list        # [[what the host was doing, seconds]], longest

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernels.items() if rx.search(n))


def _union(starts: list, ends: list, t0_ns: int, t1_ns: int):
    """The union of the intervals clipped to [t0_ns, t1_ns], intervals
    that touch joined: (starts, ends) of its pieces in order, int64."""
    s = np.maximum(np.asarray(starts, np.int64), t0_ns)
    e = np.minimum(np.asarray(ends, np.int64), t1_ns)
    s, e = s[e > s], e[e > s]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, reach = s[order], np.maximum.accumulate(e[order])
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > reach[:-1]
    last = np.r_[np.flatnonzero(first)[1:] - 1, len(s) - 1]
    return s[first], reach[last]


def summarize(events, device_index: int, t0_ns: int, t1_ns: int) -> Summary:
    """One pass over the events, as few calls into each as its kind needs
    (a traced window can hold millions); a host event's name is read only
    where it labels an idle gap."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = collections.defaultdict(float)
    copies = collections.defaultdict(float)
    starts, ends = [], []
    host, host_s, host_e = [], [], []
    for ev in events:
        if ev.device_type() == cuda:
            name, s, d = ev.name(), ev.start_ns(), ev.duration_ns()
            # A range of the harness's spans (or the program's) drawn on the
            # device's timeline is no device work.
            if ev.device_index() != device_index or d <= 0 \
                    or name.startswith(RANGES):
                continue
            copy = name.startswith(("Memcpy", "Memset"))
            (copies if copy else kernels)[name] += d * 1e-9
            starts.append(s)
            ends.append(s + d)
        else:
            d = ev.duration_ns()
            if d > 0:
                s = ev.start_ns()
                host.append(ev)
                host_s.append(s)
                host_e.append(s + d)
    seg_s, seg_e = _union(starts, ends, t0_ns, t1_ns)
    busy = int((seg_e - seg_s).sum())
    gap_s = np.r_[np.int64(t0_ns), seg_e]
    gap_len = np.r_[seg_s, np.int64(t1_ns)] - gap_s
    gap_s, gap_len = gap_s[gap_len > 0], gap_len[gap_len > 0]
    longest = np.lexsort((gap_s, gap_len))[::-1][:10]
    hs, he = np.asarray(host_s, np.int64), np.asarray(host_e, np.int64)
    idle = []
    for i in longest:
        length, start = int(gap_len[i]), int(gap_s[i])
        mid = start + length // 2
        inside = [(int(he[k] - hs[k]), host[k].name())
                  for k in np.flatnonzero((hs <= mid) & (mid <= he))]
        idle.append([min(inside)[1] if inside else "host (no traced op)",
                     length * 1e-9])
    ops = sorted(list(kernels.items()) + list(copies.items()),
                 key=lambda kv: -kv[1])[:10]
    return Summary(window_s=(t1_ns - t0_ns) * 1e-9, busy_s=busy * 1e-9,
                   kernels=dict(kernels), copies=dict(copies),
                   device_ops=[[n[:NAME_CHARS], s] for n, s in ops],
                   idle_gaps=idle)


def idle_pct(x) -> float | None:
    """The share of the traced window in which no kernel and no copy ran
    on the (rank 0) card, in %; None without a trace."""
    s = x["summary"]
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


class Tracer:
    """Host spans always; the profiler between `start` and `stop` when
    enabled."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.spans = collections.defaultdict(list)
        self.summary: Summary | None = None
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function(name) if self._prof is not None
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        prof, self._prof = self._prof, None
        # The profiler's own stop, then the read-back and reduction of its
        # events: the two costs of a traced run after its window.
        with self.span("trace.stop"):
            prof.__exit__(None, None, None)
        index = self.device.index if self.device.index is not None else 0
        with self.span("trace.reduce"):
            self.summary = summarize(prof.profiler.kineto_results.events(),
                                     index, self._t0, t1)
