"""Run-log -> Chrome trace-event JSON (loadable in ui.perfetto.dev).
(Copied from ddt_tpu/telemetry/perfetto.py.)

The run log is an event stream with wall-clock stamps and durations;
this module re-expresses it in the trace-event format Perfetto (and
chrome://tracing, and TensorBoard's trace viewer) load natively, so a
training run's rounds, phases, and per-partition lanes become a
scrollable timeline without a profiler capture. Wholly host-side
post-processing — no jax, no device, works on a log copied off a pod.

Layout (one trace "process" per HOST, as stamped by the cross-host
merge — a single-host log is pid 0):

- tid 0, "rounds": one complete ("X") slice per `round` event, spanning
  the recorded ms_per_round and ENDING at the event's emit time (the
  round record is written at round end). Early-stop / fault / run_end
  land here as instant ("i") events.
- tid 1+d, "partition d": per-device lanes from `partition_phases`.
  The run log stores per-phase DURATIONS plus the event's emit time,
  not per-phase start stamps (the collection is one probe per phase,
  not a tracer), so each device's phases are laid out back-to-back
  ending at the emit time — true durations, synthesized offsets,
  documented here and in docs/OBSERVABILITY.md. Slice args carry the
  device id and the round's hist_allreduce payload estimate.
- `phase_timings` / `counters` become instant events on the rounds
  lane with their full payload in args (aggregates have no extent);
  `train_heartbeat` rides the same lane (it summarizes the adjacent
  round slices).
- tid 999, "events": the catch-all lane — every run-log kind without a
  dedicated mapping (drift, artifact, future schema additions) renders
  here as an instant with its full payload, never a silent drop.

Contract (tests/test_flight_recorder.py validates it field by field):
every record has string `name`, `ph` in {X, i, M}, numeric `ts` >= 0
(microseconds), integer `pid`/`tid`; every X record a numeric
`dur` >= 0; the top level is {"traceEvents": [...], "displayTimeUnit":
"ms"} — the JSON object form, which Perfetto's trace-event importer
accepts.
"""

from __future__ import annotations

import json

#: one metadata slot per aggregate event type on the rounds lane
#: (cost_analysis since schema v3: the observatory's per-op records ride
#: the export as instants so a trace viewer can read the cost model next
#: to the lanes; train_heartbeat too: the checkpoint-cadence
#: progress pulse belongs next to the round slices it summarizes).
_INSTANT_EVENTS = ("early_stop", "fault", "run_end", "phase_timings",
                   "serve_latency",
                   "counters", "partition_skew", "cost_analysis",
                   "train_heartbeat")

#: the catch-all lane: run-log kinds with no dedicated
#: mapping — serve-era events like drift/artifact, and whatever schema
#: additions come next — used to be DROPPED silently, so the trace
#: looked complete while hiding whole subsystems. They now render as
#: instants on one "events" lane. The tid is fixed and high so it never
#: collides with the per-device partition lanes (tid 1+d).
_MISC_TID = 999


def _payload(rec: dict) -> dict:
    return {k: v for k, v in rec.items()
            if k not in ("event", "schema", "t", "seq", "host")}


def to_trace_events(events: list[dict]) -> dict:
    """Convert a (possibly merged) run-log event list into the
    trace-event JSON object. Timestamps are microseconds relative to
    the earliest event."""
    if not events:
        raise ValueError("no run-log events to export")
    base = min(e["t"] for e in events)

    def ts(t: float) -> float:
        return max(0.0, (t - base) * 1e6)

    out: list[dict] = []
    hosts_done: set[int] = set()
    lanes_done: set[tuple[int, int]] = set()

    def lane(pid: int, tid: int, name: str) -> None:
        if (pid, tid) in lanes_done:
            return
        lanes_done.add((pid, tid))
        out.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                    "pid": pid, "tid": tid, "args": {"name": name}})

    for e in events:
        pid = int(e.get("host", 0))
        ev = e["event"]
        if ev == "run_manifest":
            if pid not in hosts_done:
                hosts_done.add(pid)
                m = _payload(e)
                label = (f"ddt host {pid} "
                         f"({m.get('trainer', '?')}/{m.get('backend', '?')})")
                out.append({"name": "process_name", "ph": "M", "ts": 0.0,
                            "pid": pid, "tid": 0, "args": {"name": label}})
            lane(pid, 0, "rounds")
            continue
        if ev == "round":
            lane(pid, 0, "rounds")
            dur_us = float(e["ms_per_round"]) * 1e3
            out.append({
                "name": f"round {e['round']}", "ph": "X",
                "ts": max(0.0, ts(e["t"]) - dur_us), "dur": dur_us,
                "pid": pid, "tid": 0, "args": _payload(e),
            })
            continue
        if ev == "partition_phases":
            for part in e["partitions"]:
                dev = int(part["device"])
                tid = 1 + dev
                lane(pid, tid, f"partition {dev}")
                phases = part.get("phases", {})
                total_us = sum(phases.values()) * 1e3
                cursor = max(0.0, ts(e["t"]) - total_us)
                for name, ms in phases.items():
                    dur_us = float(ms) * 1e3
                    out.append({
                        "name": f"ddt:{name}", "ph": "X",
                        "ts": cursor, "dur": dur_us,
                        "pid": pid, "tid": tid,
                        "args": {
                            "device": dev, "round": e["round"],
                            "hist_allreduce_bytes":
                                part.get("hist_allreduce_bytes"),
                        },
                    })
                    cursor += dur_us
            continue
        if ev in _INSTANT_EVENTS:
            lane(pid, 0, "rounds")
            out.append({"name": ev, "ph": "i", "ts": ts(e["t"]), "s": "t",
                        "pid": pid, "tid": 0, "args": _payload(e)})
            continue
        # Unmapped kinds (drift, artifact, future schema additions):
        # instants on the catch-all lane, never a silent drop.
        lane(pid, _MISC_TID, "events")
        out.append({"name": ev, "ph": "i", "ts": ts(e["t"]), "s": "t",
                    "pid": pid, "tid": _MISC_TID, "args": _payload(e)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_trace(events: list[dict], path: str) -> int:
    """Serialize to_trace_events(events) to `path`; returns the trace
    record count (the CLI's summary line)."""
    trace = to_trace_events(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
