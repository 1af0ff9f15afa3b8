"""Process-wide counters behind `/metrics` and the run log (port of
ddt_tpu/telemetry/counters.py: the same `_c` key set, the same `record_*`
functions, `snapshot`, `delta`, `device_peak_bytes`,
`host_peak_rss_bytes`, `hist_allreduce_bytes(_by_level)` and
`grad_stream_bytes`).

Every counter is a monotonic process-wide number: consumers take a
`snapshot()` and later read `delta(start)`, so a scrape or a run log of
either package reads the same `ddt_<name>` keys (serve/metrics.py,
`report diff`).

What the port counts under the reference's names:

- `jit_compiles` / `jit_compile_seconds` count what the port compiles:
  the nvcc builds `_build.build_all` ran in this process and the CUDA
  graphs the fused loop captured (one per new round graph,
  `graph_captured`), with the host seconds of both (a capture's
  seconds include the warm-up round before it). There is no JAX compile
  listener here. A process whose kernels are built and whose round is
  captured reads 0 here.
- `h2d_bytes`: the binned chunk rows the streamed trainer and scorer move
  host to device (backends/cuda `upload_chunk` / `upload_row_shards`).
- `d2h_bytes`: the fused loop's block fetches of trees and losses.
- `collective_bytes_est`: the histogram collectives' modeled payload a
  round on a mesh (CUDADevice.collective_bytes_per_tree).
- `grad_stream_bytes_est`, `grad_quant_rounds`, `train_rounds`,
  `train_heartbeats`: recorded by the Driver and the streamed trainer
  every round (heartbeats at the checkpoint cadence, with a run log).
- `compiled_ensemble_cache_hits`: hits of CUDADevice's scoring-operand
  cache (api.predict's per-model LRU).
- the serving counters (`serve_*`, `fleet_*`, `slo_breaches`,
  `drift_alerts`) from serve/engine.py, serve/fleet.py and serve/drift.py.
- `fault_retries`: every failed attempt a retry seam retries
  (utils/retry); `hist_oom_degrades`: every step down the histogram
  ladder (ops/histogram.HistLadder, one a backend).

`device_peak_bytes()` is torch.cuda.max_memory_allocated of the current
card since `reset_device_peak` (the trainers reset it at run start), None
on a process that has not used a card.

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


# CUDA-graph captures and their host seconds (graph_captured);
# snapshot folds them into jit_compiles / jit_compile_seconds beside the
# nvcc builds, which _build counts itself.
_captures = 0
_capture_seconds = 0.0


def graph_captured(seconds: float) -> None:
    global _captures, _capture_seconds
    _captures += 1
    _capture_seconds += float(seconds)


def graph_captures() -> int:
    """CUDA graphs captured in this process so far (never reset)."""
    return _captures


def snapshot() -> dict:
    """Point-in-time copy of the monotonic counters (jit_compiles: nvcc
    builds plus graph captures)."""
    out = dict(_c)
    out["jit_compiles"] = _build.builds + _captures
    out["jit_compile_seconds"] = _build.build_seconds + _capture_seconds
    return out


def delta(start: dict, end: dict | None = None) -> dict:
    """Counter movement since `start` (a snapshot()); `end` defaults to
    now. The float counter (build seconds) is rounded; integer counters
    pass through exact."""
    end = end if end is not None else snapshot()
    out = {k: end[k] - start.get(k, 0) for k in _c}
    out["jit_compile_seconds"] = round(out["jit_compile_seconds"], 4)
    return out


def reset_device_peak() -> None:
    """Start a new high-water mark on the current card (a trainer's run
    start); nothing without a card or before the process has used one."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()


def device_peak_bytes() -> int | None:
    """Device memory high-water mark of the current card (torch's
    caching allocator, bytes allocated to tensors), or None on a process
    that has no card or has not used it."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.max_memory_allocated())


def host_peak_rss_bytes() -> int | None:
    """Peak host resident-set size of this process (ru_maxrss), or None
    where the resource module is unavailable. Linux reports KiB, macOS
    bytes; normalised to bytes."""
    try:
        import resource
        import sys
    except ImportError:
        return None
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(ru) if sys.platform == "darwin" else int(ru) * 1024


def hist_allreduce_bytes_by_level(
        max_depth: int, n_features: int, n_bins: int,
        *, partitions: int = 1, mode: str = "allreduce",
        subtraction: bool = False, comms_dtype: str = "f32",
        feature_partitions: int = 1,
        grad_dtype: str = "f32") -> "list[int]":
    """Per-level modeled collective payload (levels 0..max_depth-1); the
    wire this models is parallel/comms.hist_reduce, whose own
    `hist_allreduce_bytes_by_level` it equals."""
    from ddt_tpu_torch.parallel.comms import hist_allreduce_bytes_by_level \
        as by_level

    return by_level(max_depth, n_features, n_bins, partitions=partitions,
                    mode=mode, subtraction=subtraction,
                    comms_dtype=comms_dtype,
                    feature_partitions=feature_partitions,
                    grad_dtype=grad_dtype)


def hist_allreduce_bytes(max_depth: int, n_features: int, n_bins: int,
                         *, partitions: int = 1, mode: str = "allreduce",
                         subtraction: bool = False,
                         comms_dtype: str = "f32",
                         feature_partitions: int = 1,
                         grad_dtype: str = "f32") -> int:
    """Modeled per-rank collective payload of one tree's histogram
    phases: the levels plus the final level's [2^d, 2] leaf aggregates
    (parallel/comms.hist_allreduce_bytes)."""
    from ddt_tpu_torch.parallel.comms import hist_allreduce_bytes as whole

    return whole(max_depth, n_features, n_bins, partitions=partitions,
                 mode=mode, subtraction=subtraction,
                 comms_dtype=comms_dtype,
                 feature_partitions=feature_partitions,
                 grad_dtype=grad_dtype)


def grad_stream_bytes(rows: int, max_depth: int,
                      grad_dtype: str = "f32") -> int:
    """Modeled g/h bytes a tree reads: every histogram pass (max_depth
    levels and the leaf pass) reads both gradient rows at their stored
    itemsize (ops/grad.GRAD_ITEMSIZE)."""
    from ddt_tpu_torch.ops.grad import GRAD_ITEMSIZE

    return (max_depth + 1) * rows * 2 * GRAD_ITEMSIZE[grad_dtype]
