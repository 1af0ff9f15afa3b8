"""Run-log events: schema-versioned JSONL records and a ring buffer
(port of ddt_tpu/telemetry/events.py: the schema tables,
`validate_event`, `RunLog`, `derive_run_id`, and the trainers' emit
homes `RoundRecorder`, `emit_early_stop`, `emit_train_heartbeat`,
`finish_run_log`, `comms_manifest_fields`, with the pure reduction
`partition_skew_summary` that report reads).

Every record is one JSON object per line with the envelope (`event`,
`schema`, `t`, `seq`) plus its event type's required fields
(EVENT_FIELDS) and any declared extras (EVENT_EXTRAS). The tables are
the reference's schema v5, copied, so a log written by the port
validates in the reference's reader and renders through its `report`
and `merge` (tests/test_torch_telemetry.py). The schema is checked at
emit time.

Writes are line-buffered appends of whole lines: a process killed
mid-write loses at most its last partial line. One RunLog may be shared
by the registry loader, the engine and the fleet on several threads;
`emit` holds a lock, so `seq` stays strictly increasing in the file.

The partition recorder (per-rank phase lanes of a mesh run, the
straggler watchdog's feed) is not ported: it comes with straggler
repartition.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time

# v4 added `serve_latency` and the `hot_swap` fault kind; v5 the
# registry's `artifact` event and the `artifact_digest` / `old_artifact`
# / `new_artifact` extras. Later extras (the fleet's `model_name`, the
# fleet_* / slo_breach fault kinds, `serve_trace`, `drift`,
# `train_heartbeat`) were schema-additive: no version bump.
SCHEMA_VERSION = 5

#: event type -> required payload fields (the reference's table; extras
#: are allowed, e.g. `round` records carry `valid_<metric>` keys).
EVENT_FIELDS: dict[str, set] = {
    "run_manifest": {"trainer", "backend", "loss", "n_trees", "max_depth",
                     "rows", "features"},
    "round": {"round", "ms_per_round"},
    "phase_timings": {"phases"},
    "partition_phases": {"round", "partitions"},
    "partition_skew": {"phases"},
    "early_stop": {"round", "best_round", "best_score", "metric"},
    # Fault and lifecycle events; the serving plane writes the kinds
    # hot_swap (engine swap, fleet retag), fleet_eviction / fleet_reload
    # / fleet_remove and slo_breach (serve/fleet.py).
    "fault": {"kind"},
    "counters": {"jit_compiles", "h2d_bytes", "d2h_bytes",
                 "collective_bytes_est"},
    "cost_analysis": {"op", "flops", "bytes_accessed"},
    # Registry provenance: action push / load, digest the 16-hex content
    # address (registry/store.push, registry/loader.load_servable).
    "artifact": {"action", "digest"},
    # One emitted latency window of a served model (serve/engine.py,
    # serve/fleet.py: one per model with traffic).
    "serve_latency": {"requests", "p50_ms", "p99_ms"},
    # A flushed ring of per-request timing breakdowns (serve/batcher.py
    # trace_breakdown is the record's shape).
    "serve_trace": {"traces"},
    # A latched drift alert: psi_max is the worst per-feature PSI of the
    # window against the artifact's training histogram (serve/drift.py).
    "drift": {"psi_max"},
    "train_heartbeat": {"round"},
    "run_end": {"completed_rounds", "wallclock_s"},
}

#: event type -> declared optional extras (fnmatch globs allowed). Extras
#: stay optional; every keyword the port emits is one of these.
EVENT_EXTRAS: dict[str, tuple] = {
    "run_manifest": (
        "n_bins", "n_classes", "seed", "distributed", "run_id", "host",
        "n_chunks", "grad_dtype", "split_comms", "hist_comms_dtype",
        "hist_comms_slabs", "mesh_layout", "xprof_dir", "xprof_rounds",
    ),
    "round": ("train_loss", "valid_*"),
    "phase_timings": (),
    "partition_phases": ("rounds",),
    "partition_skew": ("n_partitions",),
    "early_stop": (),
    # The union of every fault kind's extras.
    "fault": (
        "round", "rotation", "device", "skew", "streak",      # stragglers
        "seam", "attempt", "error", "message", "deadline_s",  # retries
        "site",                                               # injected
        "from_impl", "to_impl", "row_chunk",                  # OOM degrade
        "old", "new", "old_artifact", "new_artifact",         # hot swap
        "model_name", "artifact_digest", "evictions",         # fleet
        "reloads", "failed_requests",
        "candidate", "reason",                                # checkpoints
        "burn_rate", "objective_ms", "window_s", "requests",  # slo_breach
    ),
    "counters": (
        "jit_compile_seconds", "compiled_ensemble_cache_hits",
        "fault_retries", "hist_oom_degrades",
        "serve_requests", "serve_batches", "serve_hot_swaps",
        "serve_express", "fleet_evictions", "fleet_reloads",
        "slo_breaches", "drift_alerts",
        "grad_stream_bytes_est", "grad_quant_rounds",
        "train_rounds", "train_heartbeats",
        "device_peak_bytes", "host_peak_rss_bytes",
    ),
    "cost_analysis": ("phase", "calls", "platform", "signature",
                      "arg_bytes", "output_bytes", "temp_bytes"),
    "artifact": ("name", "version", "kind", "run_id", "model_token",
                 "mode"),
    "serve_latency": ("batches", "window_s", "p999_ms", "max_ms",
                      "coalesce_mean", "coalesce_max", "queue_depth_max",
                      "express", "model_token", "model_name",
                      "predict_impl", "artifact_digest", "slo_p99_ms",
                      "drift_psi_max", "drift_js_max", "drift_alerting",
                      "shadow_model", "shadow_rows",
                      "shadow_mean_abs_diff", "shadow_ms_p50",
                      "shadow_dropped"),
    "serve_trace": ("model_name", "model_token", "reason", "count"),
    "train_heartbeat": ("total_rounds", "checkpoint_round",
                        "ms_per_round", "rows_per_s"),
    "drift": ("model_name", "feature", "js_max", "psi_mean",
              "window_rows", "window_s", "threshold", "alerts"),
    "run_end": (),
}

#: every `fault` event kind an emitter may use.
FAULT_KINDS = (
    "checkpoint_resume", "checkpoint_corrupt", "checkpoint_fallback",
    "checkpoint_unrecoverable",
    "retry", "retry_exhausted", "retry_deadline",
    "injected", "hist_oom_degrade",
    "straggler_detected", "repartition",
    "hot_swap", "fleet_eviction", "fleet_reload", "fleet_remove",
    "slo_breach",
)

ENVELOPE_FIELDS = ("event", "schema", "t", "seq")


def validate_event(rec: dict) -> None:
    """Raise ValueError unless `rec` is a well-formed run-log record."""
    if not isinstance(rec, dict):
        raise ValueError(f"run-log record must be an object, got "
                         f"{type(rec).__name__}")
    missing = [k for k in ENVELOPE_FIELDS if k not in rec]
    if missing:
        raise ValueError(f"run-log record missing envelope fields {missing}")
    if not isinstance(rec["schema"], int) or isinstance(rec["schema"], bool):
        raise ValueError(
            f"run-log schema must be an integer, got {rec['schema']!r}")
    if rec["schema"] > SCHEMA_VERSION:
        raise ValueError(
            f"run-log schema {rec['schema']} is newer than this reader "
            f"(schema {SCHEMA_VERSION}); upgrade ddt_tpu_torch to report on it")
    ev = rec["event"]
    if ev not in EVENT_FIELDS:
        raise ValueError(
            f"unknown run-log event {ev!r}; have {sorted(EVENT_FIELDS)}")
    missing = [k for k in EVENT_FIELDS[ev] if k not in rec]
    if missing:
        raise ValueError(f"{ev} record missing required fields {missing}")


class RunLog:
    """Append-only JSONL run log + bounded in-memory ring buffer.

    `path=None` keeps events in the ring only (tests, library callers).
    The file handle opens lazily on the first emit and is line-buffered;
    `close()` (or context-manager exit) releases it. Emission never
    touches the device: every field is host data."""

    def __init__(self, path: str | None = None, ring_size: int = 4096):
        self.path = path
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self._fh = None
        self._seq = 0
        self._lock = threading.Lock()
        # The run's identity, bound by whoever derives it; survives
        # close().
        self.run_id: str | None = None

    @classmethod
    def coerce(cls, run_log) -> "RunLog | None":
        """None | path-str | RunLog -> RunLog | None (the `run_log=`
        argument convention)."""
        if run_log is None or isinstance(run_log, cls):
            return run_log
        return cls(str(run_log))

    def emit(self, event: str, **fields) -> dict:
        with self._lock:
            rec = {"event": event, "schema": SCHEMA_VERSION,
                   "t": time.time(), "seq": self._seq, **fields}
            validate_event(rec)
            self._seq += 1
            self.ring.append(rec)
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a", buffering=1,
                                    encoding="utf-8")
                self._fh.write(json.dumps(rec, sort_keys=False) + "\n")
        return rec

    def events(self, event: str | None = None) -> list[dict]:
        """Ring-buffer contents (oldest first), optionally one type."""
        with self._lock:
            return [r for r in self.ring
                    if event is None or r["event"] == event]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def derive_run_id(**fields) -> str:
    """Deterministic 12-hex run id from the run's config facts (the
    reference's digest, bit for bit): every host of a multi-host run
    derives the same id, the key a cross-host merge joins logs on."""
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def emit_early_stop(run_log: "RunLog | None", stop_round: int, metric,
                    best_round: int, best_score) -> None:
    """The early_stop event, one emit site for the Driver's two loops and
    the streamed loop (rounds are 1-based here)."""
    if run_log is None:
        return
    run_log.emit("early_stop", round=stop_round, metric=metric,
                 best_round=best_round, best_score=best_score)


def finish_run_log(run_log: "RunLog | None", timer, counters_start,
                   completed_rounds: int, wallclock_s: float,
                   costs=None) -> None:
    """Run-log epilogue: [cost_analysis... +] phase_timings + counters +
    run_end, shared by the Driver and fit_streaming. `timer` is a
    utils.profiling.PhaseTimer or None (reading its totals is the one
    device sync of a timed run on the card); `counters_start` a
    counters.snapshot() or None; `costs` the run's costmodel.Collector
    or None. Closing a path-owned log is the trainers' job, which also
    covers the exception paths."""
    if run_log is None:
        return
    from ddt_tpu_torch.telemetry import costmodel
    from ddt_tpu_torch.telemetry import counters as tele_counters

    if costs is not None:
        costmodel.flush_into(run_log, costs)
    if timer is not None and timer.totals:
        run_log.emit("phase_timings", phases=timer.as_json())
    d = tele_counters.delta(counters_start or {})
    d["device_peak_bytes"] = tele_counters.device_peak_bytes()
    d["host_peak_rss_bytes"] = tele_counters.host_peak_rss_bytes()
    run_log.emit("counters", **d)
    run_log.emit("run_end", completed_rounds=completed_rounds,
                 wallclock_s=wallclock_s)


def emit_train_heartbeat(run_log, *, rnd, total_rounds,
                         checkpoint_round=None, ms_per_round=None,
                         rows_per_s=None) -> None:
    """One heartbeat at a checkpoint-cadence boundary, the one emit home
    of every trainer path. `rnd` is 0-based (the loop variable); the
    event's `round` is the 1-based completed count, as in `round`
    records. No-op without a run log."""
    if run_log is None:
        return
    from ddt_tpu_torch.telemetry import counters as tele_counters

    tele_counters.record_train_heartbeat()
    extras = {}
    if checkpoint_round is not None:
        extras["checkpoint_round"] = checkpoint_round
    if ms_per_round is not None:
        extras["ms_per_round"] = round(float(ms_per_round), 3)
    if rows_per_s is not None:
        extras["rows_per_s"] = round(float(rows_per_s), 1)
    run_log.emit("train_heartbeat", round=rnd + 1,
                 total_rounds=total_rounds, **extras)


def comms_manifest_fields(backend) -> dict:
    """run_manifest extras of the resolved split-finding comms: always
    `grad_dtype` when the quantized path is armed; on a mesh also the
    comms mode, wire dtype, slabs and the live (row shards, feature
    shards) layout (`mesh_layout`: hosts x rows folded into the first)."""
    out = {}
    cfg = getattr(backend, "cfg", None)
    if cfg is not None and getattr(cfg, "grad_dtype", "f32") != "f32":
        out["grad_dtype"] = cfg.grad_dtype
    m = getattr(backend, "mesh", None)
    if m is None:
        return out
    return {
        **out,
        "split_comms": backend.split_comms,
        "hist_comms_dtype": backend.cfg.hist_comms_dtype,
        "hist_comms_slabs": int(backend.comms_slabs),
        "mesh_layout": [int(m.row_shards), int(m.n_feature_shards)],
    }


def partition_skew_summary(totals: dict) -> list[dict]:
    """Straggler reduction: {lane: {phase: ms}} accumulated per-lane phase
    wall times -> [{phase, ms_max, ms_median, skew, max_device}], phases
    by ms_max descending. A lane key is a device id or a (host, device)
    tuple (the record then also carries max_host). `skew` is max/median
    (1.0 = balanced). Report recomputes it across hosts from
    `partition_phases` events."""
    phases: dict[str, dict] = {}
    for lane, per_phase in totals.items():
        for name, ms in per_phase.items():
            phases.setdefault(name, {})[lane] = ms
    out = []
    for name, by_lane in phases.items():
        vals = sorted(by_lane.values())
        n = len(vals)
        median = (vals[n // 2] if n % 2 else
                  (vals[n // 2 - 1] + vals[n // 2]) / 2.0)
        # The smallest lane wins exact ties.
        max_lane = max(sorted(by_lane), key=lambda k: by_lane[k])
        ms_max = by_lane[max_lane]
        rec = {
            "phase": name,
            "ms_max": round(ms_max, 3),
            "ms_median": round(median, 3),
            "skew": round(ms_max / median, 3) if median > 0 else None,
        }
        if isinstance(max_lane, tuple):
            rec["max_host"] = int(max_lane[0])
            rec["max_device"] = int(max_lane[1])
        else:
            rec["max_device"] = int(max_lane)
        out.append(rec)
    out.sort(key=lambda r: -r["ms_max"])
    return out


class RoundRecorder:
    """Per-round history record + run-log event + progress log line, the
    one home of the round-record shape for the Driver's two loops.

    The train loss is read at the `log_every` cadence and on the last
    round only (the loss thunk may cost a device sync; off-cadence records
    carry train_loss=None), the eval metric every round, so the history
    depends neither on the logging level nor on the loop. A record joins
    `history` on a cadence round or a round with an eval score; with a run
    log every round is emitted. ms_per_round is the caller's number: the
    round's wall time on the granular loop, the block's mean on the fused
    loop."""

    def __init__(self, history: list, run_log: RunLog | None,
                 log_every: int, n_rounds: int, metric_name: str | None,
                 logger):
        self.history = history
        self.run_log = run_log
        self.log_every = log_every
        self.n_rounds = n_rounds
        self.metric_name = metric_name
        self.log = logger

    @staticmethod
    def make_record(r: int, ms: float, train_loss,
                    metric_name=None, val_score=None) -> dict:
        """The round record ({round, train_loss, ms_per_round
        [, valid_<metric>]})."""
        rec = {"round": r + 1, "train_loss": train_loss,
               "ms_per_round": ms}
        if val_score is not None:
            rec[f"valid_{metric_name}"] = val_score
        return rec

    def record(self, r: int, ms: float, val_score, loss_fn) -> None:
        on_cadence = (r + 1) % self.log_every == 0 or r == self.n_rounds - 1
        if not on_cadence and val_score is None and self.run_log is None:
            return
        loss = loss_fn() if on_cadence else None
        rec = self.make_record(r, ms, loss, self.metric_name, val_score)
        if on_cadence or val_score is not None:
            self.history.append(rec)
        if self.run_log is not None:
            self.run_log.emit("round", **rec)
        if on_cadence:
            self.log.info(
                "round %4d/%d  loss=%.6f  %.1f ms/round%s",
                r + 1, self.n_rounds, loss, ms,
                f"  valid_{self.metric_name}={val_score:.6f}"
                if val_score is not None else "")
