"""Run-log events: schema-versioned JSONL records and a ring buffer
(port of the part of ddt_tpu/telemetry/events.py that serving and the
registry write: the schema tables, `validate_event`, `RunLog` and
`derive_run_id`).

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

The training-side recorders (partition phases, rounds, heartbeats, the
run epilogue) come with the port's training telemetry.
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
