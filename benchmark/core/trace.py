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


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def summarize(events, device_index: int, t0_ns: int, t1_ns: int) -> Summary:
    kernels = collections.defaultdict(float)
    copies = collections.defaultdict(float)
    spans, host = [], []
    for ev in events:
        if _is_device(ev):
            name, s, d = ev.name(), ev.start_ns(), ev.duration_ns()
            # A range of the harness's spans (or the program's) drawn on the
            # device's timeline is no device work.
            if ev.device_index() != device_index or d <= 0 \
                    or name.startswith(RANGES):
                continue
            copy = name.startswith(("Memcpy", "Memset"))
            (copies if copy else kernels)[name] += d * 1e-9
            spans.append((s, s + d))
        else:
            d = ev.duration_ns()
            if d > 0:
                host.append((ev.start_ns(), ev.start_ns() + d, ev.name()))
    spans.sort()
    merged = []
    for s, e in spans:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [t0_ns] + [x for se in merged for x in se] + [t1_ns]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    idle = []
    for length, start in gaps:
        mid = start + length // 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
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
        prof.__exit__(None, None, None)
        index = self.device.index if self.device.index is not None else 0
        self.summary = summarize(prof.profiler.kineto_results.events(),
                                 index, self._t0, t1)
