"""Prometheus-style text exposition for `GET /metrics` (port of
ddt_tpu/serve/metrics.py: the same series names and labels).

A pure renderer: `render_metrics(counters, snapshot)` turns a process
counter dict (telemetry/counters `snapshot()`) and an engine's
`metrics_snapshot()` into the text exposition format (version 0.0.4).
Read-only: a scrape never resets a window, emits an event or moves a
counter; the histograms are the engines' cumulative-since-boot series on
the fixed HIST_BUCKETS_MS ladder.

Series:

- ``ddt_<counter>_total``            one per process counter;
- ``ddt_serve_latency_ms_bucket{model,le}`` / ``_sum`` / ``_count``
  per-model cumulative histogram, with ``le="+Inf"`` equal to ``_count``;
- ``ddt_serve_backlog_rows{model}``  live queued rows;
- ``ddt_serve_resident_models`` / ``ddt_serve_max_resident_models``
  fleet residency (max omitted when unbounded);
- ``ddt_serve_slo_objective_ms{model}`` /
  ``ddt_serve_slo_burn_rate{model,window}`` /
  ``ddt_serve_slo_breaches_total{model}`` for models with an SLO (burn
  windows with too few samples omitted, not rendered as 0);
- ``ddt_drift_psi_max{model}`` / ``ddt_drift_js_max{model}`` /
  ``ddt_drift_window_rows{model}`` / ``ddt_drift_alerting{model}`` /
  ``ddt_drift_psi_threshold{model}`` /
  ``ddt_drift_model_alerts_total{model}`` for models whose artifact
  carried a training histogram (divergence gauges omitted below the
  tracker's min-rows floor);
- ``ddt_shadow_scored_rows_total{model,shadow}`` /
  ``ddt_shadow_mean_abs_diff{model,shadow}`` /
  ``ddt_shadow_dropped_total{model,shadow}`` on shadowed champions.

No HTTP, no locks, no engine imports: http.py collects the snapshots.
"""

from __future__ import annotations

from ddt_tpu_torch.telemetry.exposition import (_esc, _num,
                                                parse_exposition,
                                                render_counters)

__all__ = ["render_counters", "render_metrics", "parse_exposition"]


def _render_hist(model: str, hist: dict) -> "list[str]":
    """Per-bucket counts -> cumulative le-semantics bucket series."""
    out = []
    label = _esc(model)
    cum = 0
    buckets = hist.get("buckets_ms") or []
    counts = hist.get("counts") or []
    for i, le in enumerate(buckets):
        cum += counts[i] if i < len(counts) else 0
        out.append(
            f'ddt_serve_latency_ms_bucket{{model="{label}",'
            f'le="{_num(float(le))}"}} {cum}')
    # The implicit overflow slot: +Inf must equal _count by contract.
    if len(counts) > len(buckets):
        cum += counts[len(buckets)]
    out.append(
        f'ddt_serve_latency_ms_bucket{{model="{label}",le="+Inf"}} {cum}')
    out.append(f'ddt_serve_latency_ms_sum{{model="{label}"}} '
               f'{_num(float(hist.get("sum_ms", 0.0)))}')
    out.append(f'ddt_serve_latency_ms_count{{model="{label}"}} '
               f'{_num(hist.get("count", 0))}')
    return out


def render_metrics(counters: dict, snapshot: dict) -> str:
    """The full `/metrics` body (trailing newline included)."""
    out = render_counters(counters)
    models = snapshot.get("models") or {}
    if models:
        out.append("# TYPE ddt_serve_latency_ms histogram")
        for name in sorted(models):
            out.extend(_render_hist(name, models[name].get("hist") or {}))
        out.append("# TYPE ddt_serve_backlog_rows gauge")
        for name in sorted(models):
            out.append(f'ddt_serve_backlog_rows{{model="{_esc(name)}"}} '
                       f'{_num(models[name].get("backlog_rows", 0))}')
    if snapshot.get("resident_models") is not None:
        out.append("# TYPE ddt_serve_resident_models gauge")
        out.append(f"ddt_serve_resident_models "
                   f"{_num(snapshot['resident_models'])}")
    if snapshot.get("max_resident") is not None:
        out.append("# TYPE ddt_serve_max_resident_models gauge")
        out.append(f"ddt_serve_max_resident_models "
                   f"{_num(snapshot['max_resident'])}")
    slo_models = {n: m["slo"] for n, m in sorted(models.items())
                  if m.get("slo")}
    if slo_models:
        out.append("# TYPE ddt_serve_slo_objective_ms gauge")
        for name, slo in slo_models.items():
            out.append(
                f'ddt_serve_slo_objective_ms{{model="{_esc(name)}"}} '
                f'{_num(float(slo["objective_ms"]))}')
        out.append("# TYPE ddt_serve_slo_burn_rate gauge")
        for name, slo in slo_models.items():
            for window, rate in sorted(
                    (slo.get("burn_rates") or {}).items()):
                if rate is None:
                    continue        # not enough samples: omit, don't lie
                out.append(
                    f'ddt_serve_slo_burn_rate{{model="{_esc(name)}",'
                    f'window="{_esc(window)}"}} {_num(float(rate))}')
        out.append("# TYPE ddt_serve_slo_breaches_total counter")
        for name, slo in slo_models.items():
            out.append(
                f'ddt_serve_slo_breaches_total{{model="{_esc(name)}"}} '
                f'{_num(slo.get("breaches", 0))}')
    drift_models = {n: m["drift"] for n, m in sorted(models.items())
                    if m.get("drift")}
    if drift_models:
        out.append("# TYPE ddt_drift_window_rows gauge")
        for name, d in drift_models.items():
            out.append(
                f'ddt_drift_window_rows{{model="{_esc(name)}"}} '
                f'{_num(d.get("window_rows", 0))}')
        out.append("# TYPE ddt_drift_psi_threshold gauge")
        for name, d in drift_models.items():
            out.append(
                f'ddt_drift_psi_threshold{{model="{_esc(name)}"}} '
                f'{_num(float(d["threshold"]))}')
        # Divergence gauges only once the window clears the tracker's
        # min-rows floor (psi_max is None below it): omit, don't lie.
        scored = {n: d for n, d in drift_models.items()
                  if d.get("psi_max") is not None}
        if scored:
            out.append("# TYPE ddt_drift_psi_max gauge")
            for name, d in scored.items():
                out.append(
                    f'ddt_drift_psi_max{{model="{_esc(name)}"}} '
                    f'{_num(float(d["psi_max"]))}')
            out.append("# TYPE ddt_drift_js_max gauge")
            for name, d in scored.items():
                out.append(
                    f'ddt_drift_js_max{{model="{_esc(name)}"}} '
                    f'{_num(float(d["js_max"]))}')
        out.append("# TYPE ddt_drift_alerting gauge")
        for name, d in drift_models.items():
            out.append(
                f'ddt_drift_alerting{{model="{_esc(name)}"}} '
                f'{_num(bool(d.get("alerting")))}')
        out.append("# TYPE ddt_drift_model_alerts_total counter")
        for name, d in drift_models.items():
            out.append(
                f'ddt_drift_model_alerts_total{{model="{_esc(name)}"}} '
                f'{_num(d.get("alerts", 0))}')
    shadow_models = {n: m["shadow"] for n, m in sorted(models.items())
                     if m.get("shadow")}
    if shadow_models:
        out.append("# TYPE ddt_shadow_scored_rows_total counter")
        for name, sh in shadow_models.items():
            out.append(
                f'ddt_shadow_scored_rows_total{{model="{_esc(name)}",'
                f'shadow="{_esc(sh["model"])}"}} '
                f'{_num(sh.get("rows", 0))}')
        diffed = {n: sh for n, sh in shadow_models.items()
                  if sh.get("mean_abs_diff") is not None}
        if diffed:
            out.append("# TYPE ddt_shadow_mean_abs_diff gauge")
            for name, sh in diffed.items():
                out.append(
                    f'ddt_shadow_mean_abs_diff{{model="{_esc(name)}",'
                    f'shadow="{_esc(sh["model"])}"}} '
                    f'{_num(float(sh["mean_abs_diff"]))}')
        out.append("# TYPE ddt_shadow_dropped_total counter")
        for name, sh in shadow_models.items():
            out.append(
                f'ddt_shadow_dropped_total{{model="{_esc(name)}",'
                f'shadow="{_esc(sh["model"])}"}} '
                f'{_num(sh.get("dropped", 0))}')
    return "\n".join(out) + "\n"
