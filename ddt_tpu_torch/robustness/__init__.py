"""Robustness of the port (port of ddt_tpu/robustness): fault injection,
retry seams, and the straggler watchdog.

- `faultplan` — a seeded, config-driven fault-injection plan
  (`cfg.fault_plan` / `cli train --fault-plan`) that fires named faults
  at the real seams (torn checkpoint write, stream-chunk IOError,
  torch.distributed bootstrap timeout, a histogram build's allocation
  failure, a tree fetch's transient fault, a straggler's delay). With no
  plan active each seam is one module-global read.
- `watchdog` — the straggler watchdog over the partition recorder's
  per-round lanes (telemetry/events.PartitionRecorder).
- the process-wide FAULT SINK below: deep seams (retry loops, the
  checkpoint fallback, the histogram ladder) emit `fault` events into the
  active run log without threading a handle through every layer. The
  trainers set it for the duration of a fit; with no sink attached an
  emission is one global read and a return.

The retry engine lives in `ddt_tpu_torch.utils.retry`.
"""

from __future__ import annotations

# The active fault sink: a telemetry RunLog, or None. Process-wide on
# purpose, like faultplan's active plan: a trainer sets it and restores
# the previous value in `finally`.
_SINK = None


def set_fault_sink(run_log) -> "object | None":
    """Install `run_log` (may be None) as the fault-event sink; returns
    the previous sink, for the caller to restore."""
    global _SINK
    prev = _SINK
    _SINK = run_log
    return prev


def emit_fault(kind: str, **fields) -> None:
    """Emit a `fault` run-log event through the active sink (no-op when
    none is attached). The schema requires only `kind`; seams add their
    extras (seam, attempt, round, device, ...)."""
    sink = _SINK
    if sink is None:
        return
    sink.emit("fault", kind=kind, **fields)


class fit_scope:
    """The trainers' robustness scope for one fit: the fault sink points
    at the run's log, and cfg.fault_plan (a JSON path) is loaded and
    activated unless a plan is already active process-wide (the CLI arms
    one before the torch.distributed bootstrap). Both are restored on
    every exit. The plan is loaded before any process-wide state is
    touched, so a bad plan file fails clean."""

    def __init__(self, cfg, run_log):
        from ddt_tpu_torch.robustness import faultplan

        self._plan = None
        if cfg.fault_plan and faultplan.active_plan() is None:
            self._plan = faultplan.load_plan(cfg.fault_plan)
        self._run_log = run_log

    def __enter__(self) -> "fit_scope":
        from ddt_tpu_torch.robustness import faultplan

        self._prev_sink = set_fault_sink(self._run_log)
        self._prev_plan = (faultplan.activate(self._plan)
                           if self._plan is not None else None)
        return self

    def __exit__(self, *exc) -> None:
        from ddt_tpu_torch.robustness import faultplan

        if self._plan is not None:
            faultplan.deactivate(self._prev_plan)
        set_fault_sink(self._prev_sink)
