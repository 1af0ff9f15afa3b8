"""Process-wide counters behind `/metrics` and the run log (port of
ddt_tpu/telemetry/counters.py: the same `_c` key set, the same `record_*`
functions, `snapshot` and `delta`).

Every counter is a monotonic process-wide number: consumers take a
`snapshot()` and later read `delta(start)`, so a scrape of either
package reads the same `ddt_<name>_total` series (serve/metrics.py).

What the port counts under the reference's names:

- `jit_compiles` / `jit_compile_seconds` count nvcc builds: the
  libraries `_build.build_all` compiled in this process and the seconds
  those calls took (`_build.builds`, `_build.build_seconds`, read at
  snapshot time; there is no JAX compile listener here). A serving
  process whose kernels are built reads 0 here.
- `h2d_bytes`: the binned chunk rows the streamed trainer and scorer move
  host to device (backends/cuda `upload_chunk` / `upload_row_shards`);
  this module is their one home.
- `compiled_ensemble_cache_hits`: hits of CUDADevice's scoring-operand
  cache (api.predict's per-model LRU).
- the serving counters (`serve_*`, `fleet_*`, `slo_breaches`,
  `drift_alerts`) from serve/engine.py, serve/fleet.py and serve/drift.py.

The training-plane counters (`d2h_bytes`, `collective_bytes_est`,
`fault_retries`, `hist_oom_degrades`, `grad_stream_bytes_est`,
`grad_quant_rounds`, `train_rounds`, `train_heartbeats`) keep their
names and their record functions, but no training path of the port
records them yet (they come with the training telemetry): they read 0.

Plain ints under the GIL: a lost update between two threads is possible
and harmless, since these feed reports, not invariants.
"""

from __future__ import annotations

from ddt_tpu_torch import _build

_c = {
    "jit_compiles": 0,
    "jit_compile_seconds": 0.0,
    "h2d_bytes": 0,
    "d2h_bytes": 0,
    "collective_bytes_est": 0,
    "compiled_ensemble_cache_hits": 0,
    "fault_retries": 0,
    "hist_oom_degrades": 0,
    # Serving tier: requests completed, micro-batches dispatched, hot
    # swaps, and requests the express lane dispatched.
    "serve_requests": 0,
    "serve_batches": 0,
    "serve_hot_swaps": 0,
    "serve_express": 0,
    # Fleet tenancy: LRU evictions and reloads of evicted models.
    "fleet_evictions": 0,
    "fleet_reloads": 0,
    # Latched SLO burn-rate breaches and drift alerts.
    "slo_breaches": 0,
    "grad_stream_bytes_est": 0,
    "grad_quant_rounds": 0,
    "drift_alerts": 0,
    "train_rounds": 0,
    "train_heartbeats": 0,
}


def record_h2d(nbytes: int) -> None:
    _c["h2d_bytes"] += int(nbytes)


def record_d2h(nbytes: int) -> None:
    _c["d2h_bytes"] += int(nbytes)


def record_collective(nbytes: int) -> None:
    _c["collective_bytes_est"] += int(nbytes)


def record_compiled_ensemble_hit() -> None:
    _c["compiled_ensemble_cache_hits"] += 1


def record_fault_retry() -> None:
    _c["fault_retries"] += 1


def record_hist_oom_degrade() -> None:
    _c["hist_oom_degrades"] += 1


def record_serve_requests(n: int) -> None:
    _c["serve_requests"] += int(n)


def record_serve_batch() -> None:
    _c["serve_batches"] += 1


def record_serve_hot_swap() -> None:
    _c["serve_hot_swaps"] += 1


def record_serve_express() -> None:
    _c["serve_express"] += 1


def record_fleet_eviction() -> None:
    _c["fleet_evictions"] += 1


def record_fleet_reload() -> None:
    _c["fleet_reloads"] += 1


def record_slo_breach() -> None:
    _c["slo_breaches"] += 1


def record_drift_alert() -> None:
    _c["drift_alerts"] += 1


def record_grad_stream(nbytes: int) -> None:
    _c["grad_stream_bytes_est"] += int(nbytes)


def record_grad_quant_round(n: int = 1) -> None:
    _c["grad_quant_rounds"] += int(n)


def record_train_round(n: int = 1) -> None:
    _c["train_rounds"] += int(n)


def record_train_heartbeat() -> None:
    _c["train_heartbeats"] += 1


def snapshot() -> dict:
    """Point-in-time copy of the monotonic counters (the nvcc builds read
    from _build)."""
    out = dict(_c)
    out["jit_compiles"] = _build.builds
    out["jit_compile_seconds"] = _build.build_seconds
    return out


def delta(start: dict, end: dict | None = None) -> dict:
    """Counter movement since `start` (a snapshot()); `end` defaults to
    now. The float counter (build seconds) is rounded; integer counters
    pass through exact."""
    end = end if end is not None else snapshot()
    out = {k: end[k] - start.get(k, 0) for k in _c}
    out["jit_compile_seconds"] = round(out["jit_compile_seconds"], 4)
    return out
