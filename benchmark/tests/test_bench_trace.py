"""The trace's reduction (benchmark/core/trace.summarize) against the
plain loop it replaced, kept here as the reference: the same kernels,
copies, busy time and idle gaps, exactly, on events made from a seed
(overlapping, touching and clipped intervals, another card's events,
span ranges on the device's timeline, host events of equal length)."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.core import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@dataclasses.dataclass
class Event:
    kind: object
    label: str
    start: int
    length: int
    index: int = 0

    def device_type(self):
        return self.kind

    def name(self):
        return self.label

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.length

    def device_index(self):
        return self.index


def plain_summarize(events, device_index, t0_ns, t1_ns):
    kernels = collections.defaultdict(float)
    copies = collections.defaultdict(float)
    spans, host = [], []
    for ev in events:
        if str(ev.device_type()).endswith("CUDA"):
            name, s, d = ev.name(), ev.start_ns(), ev.duration_ns()
            if ev.device_index() != device_index or d <= 0 \
                    or name.startswith(trace.RANGES):
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
    return trace.Summary(window_s=(t1_ns - t0_ns) * 1e-9,
                         busy_s=busy * 1e-9, kernels=dict(kernels),
                         copies=dict(copies),
                         device_ops=[[n[:trace.NAME_CHARS], s]
                                     for n, s in ops],
                         idle_gaps=idle)


def _events(seed, n_device, n_host, t0):
    rng = np.random.default_rng(seed)
    names = ["hist_kernel<float, true>", "scan", "Memcpy HtoD", "Memset",
             "ddt:grow_block", "bench.train", "gather" + "x" * 300]
    out = []
    at = t0 - 5_000
    for _ in range(n_device):
        at += int(rng.integers(-300, 2_000))
        out.append(Event(CUDA, names[rng.integers(len(names))], at,
                         int(rng.choice([0, 50, 400, 1_000, 2_500])),
                         int(rng.random() < 0.1)))
    # Touching intervals join.
    out += [Event(CUDA, "scan", t0 + 100, 50), Event(CUDA, "scan", t0 + 150,
                                                     50)]
    end = max(at, t0 + 10_000)
    for _ in range(n_host):
        s = int(rng.integers(t0 - 2_000, end))
        out.append(Event(CPU, f"host{rng.integers(6)}", s,
                         int(rng.choice([0, 5_000, 20_000, 80_000]))))
    rng.shuffle(out)
    return out, end - 1_000


@pytest.mark.parametrize("seed,n_device,n_host", [
    (1, 3000, 400), (2, 200, 0), (3, 0, 50), (4, 1, 1), (5, 5000, 2000)])
def test_summarize_equals_the_plain_loop(seed, n_device, n_host):
    t0 = 1_700_000_000_000_000_000
    events, t1 = _events(seed, n_device, n_host, t0)
    for index in (0, 1):
        assert trace.summarize(events, index, t0, t1) == \
            plain_summarize(events, index, t0, t1)
