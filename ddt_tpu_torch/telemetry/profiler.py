"""Profiler capture windows around selected rounds (port of
ddt_tpu/telemetry/profiler.py, on torch.profiler).

`--trace-dir` wraps the whole fit in one capture (utils/profiling.trace);
this module captures a round range instead:

    train --xprof-dir /tmp/prof --xprof-rounds 5:8 --run-log run.jsonl

starts a torch.profiler capture of CPU and CUDA activity at round 5's
first launch and stops it after round 8, so round 1's builds and graph
capture stay out of it. The Chrome trace lands in
`<xprof-dir>/run_<run_id>/trace.json` and the run manifest carries
`xprof_dir` and `xprof_rounds` (the schema's names), so a run log and
its trace cross-reference by run_id. While the window is open the ops'
`ddt:` scopes are profiler ranges (telemetry.annotations).

The fused Driver loop runs blocks of replayed rounds; the window caps a
block (`block_cap`) so that blocks start and end on the window's edges,
and the block's fetch (its one sync) ends the capture, so the trace
holds the window's rounds' device work and no other's. With no window
(`None`) the trainers skip every hook.
"""

from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger("ddt_tpu_torch.telemetry.profiler")


def parse_rounds(spec: str) -> tuple[int, int]:
    """"5:8" -> (5, 8), 1-based inclusive. A single "5" means 5:5."""
    s = str(spec).strip()
    try:
        if ":" in s:
            lo_s, hi_s = s.split(":", 1)
            lo, hi = int(lo_s), int(hi_s)
        else:
            lo = hi = int(s)
    except ValueError:
        raise ValueError(
            f"--xprof-rounds must be LO:HI (1-based, inclusive) or a "
            f"single round, got {spec!r}") from None
    if lo < 1 or hi < lo:
        raise ValueError(
            f"--xprof-rounds window {spec!r} is empty or starts before "
            "round 1")
    return lo, hi


class CaptureWindow:
    """One torch.profiler capture around rounds [lo, hi] (1-based,
    inclusive).

    Protocol (the trainers drive it; every hook is a no-op once done):
    bind(run_id) names the trace directory <dir>/run_<run_id>;
    round_start(rnd0) / round_end(rnd0) are the 0-based round edges;
    block_cap(rnd0, K) caps a fused block at the window's edges; close()
    stops a capture still open (the run ended inside the window, an early
    stop, an exception), and the trainers call it in `finally`."""

    def __init__(self, out_dir: str, rounds: str = "2:3"):
        self.out_dir = str(out_dir)
        self.lo, self.hi = parse_rounds(rounds)
        self.trace_dir = self.out_dir      # until bind() names the run
        self._prof = None
        self._scopes = None
        self._started = False
        self._done = False

    def bind(self, run_id: str | None) -> None:
        if run_id:
            self.trace_dir = os.path.join(self.out_dir, f"run_{run_id}")

    def manifest_fields(self) -> dict:
        """The run-manifest extras that cross-reference the trace."""
        return {"xprof_dir": self.trace_dir,
                "xprof_rounds": [self.lo, self.hi]}

    @property
    def trace_file(self) -> str:
        return os.path.join(self.trace_dir, "trace.json")

    @property
    def active(self) -> bool:
        return self._started and not self._done

    def round_start(self, rnd0: int) -> None:
        """Start the capture when 0-based round `rnd0` enters the window
        (a resume past the window retires it)."""
        if rnd0 + 1 > self.hi:
            self.close()
            return
        if self._started or self._done or rnd0 + 1 < self.lo:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ddt_tpu_torch.telemetry import annotations

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        try:
            prof.__enter__()
        except RuntimeError as e:        # another capture already running
            log.warning("profiler capture not started: %s", e)
            self._done = True
            return
        self._prof = prof
        self._scopes = contextlib.ExitStack()
        self._scopes.enter_context(annotations.tracing())
        self._started = True
        log.info("profiler capture started at round %d -> %s",
                 rnd0 + 1, self.trace_dir)

    def round_end(self, rnd0: int) -> None:
        if self.active and rnd0 + 1 >= self.hi:
            self._stop()

    def block_cap(self, rnd0: int, K: int) -> int:
        """Largest K' <= K such that the block [rnd0, rnd0+K') does not
        straddle a window edge (0-based block boundaries lo-1 and hi)."""
        for b in (self.lo - 1, self.hi):
            if rnd0 < b < rnd0 + K:
                K = b - rnd0
        return max(1, K)

    def close(self) -> None:
        if self.active:
            self._stop()
        self._done = True

    def _stop(self) -> None:
        self._done = True
        self._started = False
        prof, self._prof = self._prof, None
        self._scopes.close()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.trace_file)
        except RuntimeError as e:
            log.warning("profiler capture stop failed: %s", e)
            return
        log.info("profiler capture written: %s", self.trace_file)
