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
eagerly or as a replay.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch

_local = threading.local()      # the Recording open on this thread


class Recording:
    """The launches one capture recorded: (module, counter) -> count."""

    def __init__(self):
        self.counts: dict[tuple[str, str], int] = {}

    def replayed(self) -> None:
        """Add one replay's launches to the module counters."""
        for (module, name), n in self.counts.items():
            mod = sys.modules[module]
            setattr(mod, name, getattr(mod, name) + n)


@contextlib.contextmanager
def recording():
    """Open a Recording on this thread for the length of a capture."""
    rec = Recording()
    prev = getattr(_local, "rec", None)
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = prev


def count(module: str, name: str, n: int = 1) -> None:
    """One launch of the kernel behind counter `module`.`name` (or `n` of
    whatever that counter counts, such as a collective's bytes): added
    now, or recorded when the current stream is capturing a graph. A
    capture with no Recording open raises: its replays would go
    uncounted."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        rec = getattr(_local, "rec", None)
        if rec is None:
            raise RuntimeError(
                f"{module}.{name}: kernel launched inside a CUDA-graph "
                "capture with no launch recording open (wrap the capture "
                "in utils.launches.recording())")
        key = (module, name)
        rec.counts[key] = rec.counts.get(key, 0) + n
        return
    mod = sys.modules[module]
    setattr(mod, name, getattr(mod, name) + n)
