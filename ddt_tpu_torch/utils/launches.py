"""Kernel launch counters that count the launches which really run.

Each kernel wrapper keeps plain integer counters on its module
(ops/hist_cuda.launches and .launches_int, ops/predict_cuda.launches,
ops/predict_lut_cuda.launches_lut and .launches_lut4), and parallel/comms
its collectives and their bytes; chip_smoke zeroes them just before a
path and reads them just after. A wrapper calls
`count(module, name)` where it launches its kernel. Inside a CUDA-graph
capture nothing runs: the launch goes into the capture's `Recording`
instead, and every replay of the graph adds what its capture recorded
(`Recording.replayed`), so a counter reads the same whether a round ran
eagerly or as a replay. A capture also keeps the costed calls it met
(telemetry/costmodel): each replay adds them to the cost collector
active at replay time, whichever was active (if any) at capture.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch

_local = threading.local()      # the Recording open on this thread
_lock = threading.Lock()
#: Recordings open on any thread: a costed call with no cost collector
#: active looks for a capture only while this is non-zero.
open_recordings = 0


class Recording:
    """What one capture recorded: launches, (module, counter) -> count,
    and costed calls, (op, signature) -> [cost record, calls]."""

    def __init__(self):
        self.counts: dict[tuple[str, str], int] = {}
        self.costs: dict[tuple, list] = {}

    def replayed(self) -> None:
        """Add one replay's launches to the module counters, and its
        costed calls to the cost collector active now."""
        for (module, name), n in self.counts.items():
            mod = sys.modules[module]
            setattr(mod, name, getattr(mod, name) + n)
        if self.costs:
            from ddt_tpu_torch.telemetry import costmodel

            costmodel.add_replay(self.costs)


@contextlib.contextmanager
def recording():
    """Open a Recording on this thread for the length of a capture."""
    global open_recordings
    rec = Recording()
    prev = getattr(_local, "rec", None)
    _local.rec = rec
    with _lock:
        open_recordings += 1
    try:
        yield rec
    finally:
        _local.rec = prev
        with _lock:
            open_recordings -= 1


def capturing() -> bool:
    """Is the current stream capturing a CUDA graph? (False without a
    card.)"""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def capture_recording(what: str) -> Recording | None:
    """The Recording of the capture the current stream is in, or None
    when it is not capturing. A capture with no Recording open raises:
    its replays would go uncounted."""
    if not capturing():
        return None
    rec = getattr(_local, "rec", None)
    if rec is None:
        raise RuntimeError(
            f"{what}: kernel launched inside a CUDA-graph capture with no "
            "launch recording open (wrap the capture in "
            "utils.launches.recording())")
    return rec


def count(module: str, name: str, n: int = 1) -> None:
    """One launch of the kernel behind counter `module`.`name` (or `n` of
    whatever that counter counts, such as a collective's bytes): added
    now, or recorded when the current stream is capturing a graph
    (capture_recording)."""
    rec = capture_recording(f"{module}.{name}")
    if rec is not None:
        key = (module, name)
        rec.counts[key] = rec.counts.get(key, 0) + n
        return
    mod = sys.modules[module]
    setattr(mod, name, getattr(mod, name) + n)
