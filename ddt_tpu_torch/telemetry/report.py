"""Render a run summary from a JSONL run log (`ddt_tpu_torch.cli report`;
copied from ddt_tpu/telemetry/report.py, so either package renders a log
of either to the same text).

Pure host-side post-processing: read_events -> summarize -> render. The
summary is a plain dict (the CLI's --json form); render() formats it for
a terminal. No jax, no device, no repo state — a run log copied off a
pod host reports anywhere.
"""

from __future__ import annotations

import json

from ddt_tpu_torch.telemetry.events import (partition_skew_summary,
                                            validate_event)


def read_events(path: str) -> list[dict]:
    """Parse + validate a JSONL run log. Raises ValueError naming the
    line on a malformed record; a TRAILING partial line (the run was
    killed mid-write) is tolerated and dropped — everything above it is
    intact by the append-only write contract."""
    events: list[dict] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if i == len(lines):
                # Torn FINAL line (the run was killed mid-write): the
                # crash-consistency contract (events.py) says everything
                # above it is intact, so drop just the tail. Records stay
                # schema-pure — no out-of-schema marker keys.
                break
            raise ValueError(f"{path}:{i}: not JSON: {e}") from None
        try:
            validate_event(rec)
        except ValueError as e:
            raise ValueError(f"{path}:{i}: {e}") from None
        events.append(rec)
    if not events:
        raise ValueError(f"{path}: no run-log events")
    return events


def _metric_key(rec: dict) -> str | None:
    for k in rec:
        if k.startswith("valid_"):
            return k
    return None


def _cross_host_totals(part_ev: list[dict]) -> dict:
    """{(host, device): {phase: ms}} accumulated over every host's
    partition_phases stream — the merged-log straggler recompute's
    input (device ids are lane-local per host's probe, so the composite
    key keeps hosts' lanes distinct even if ids collide)."""
    totals: dict = {}
    for e in part_ev:
        h = e.get("host", 0)
        for part in e["partitions"]:
            lane = totals.setdefault((h, part["device"]), {})
            for name, ms in part["phases"].items():
                lane[name] = lane.get(name, 0.0) + ms
    return totals


def summarize(events: list[dict], slowest: int = 5) -> dict:
    """Aggregate a run log into the report dict (see render for the
    shape as prose)."""
    # Append-mode logs can hold several run segments (a preemptible
    # restart re-runs the command into the same file; each fit emits its
    # own manifest). Report the LAST segment — the run that completed —
    # and surface the segment count so earlier attempts stay visible.
    # A cross-host MERGE (telemetry.merge) holds one manifest per host
    # for the SAME run: manifests sharing a run_id (v2) count as ONE
    # segment, and the report covers every host's events of that run.
    manifests = [e for e in events if e["event"] == "run_manifest"]
    hosts = sorted({m.get("host", 0) for m in manifests}) or [0]
    # Segment grouping: consecutive manifests join the current segment
    # only when they share its run_id AND come from a host not yet in it
    # (a restart re-derives the same config-deterministic run_id on the
    # same host — that is a new segment, not a new lane).
    segments: list[dict] = []          # {"first": manifest, "hosts": set}
    for m in manifests:
        rid = m.get("run_id")
        h = m.get("host", 0)
        cur = segments[-1] if segments else None
        if (cur is not None and rid is not None
                and cur["first"].get("run_id") == rid
                and h not in cur["hosts"]):
            cur["hosts"].add(h)
        else:
            segments.append({"first": m, "hosts": {h}})
    n_runs = len(segments)
    if segments:
        anchor = segments[-1]["first"]
        first = next(i for i, e in enumerate(events) if e is anchor)
        events = events[first:]
        hosts = sorted(segments[-1]["hosts"])   # the REPORTED segment's

    manifest = next((e for e in events if e["event"] == "run_manifest"), {})
    rounds = [e for e in events if e["event"] == "round"]
    if len(hosts) > 1:
        # Merged pod logs: every host emitted its own (SPMD-identical)
        # round records — report one lane's curve, not N copies.
        rounds = [r for r in rounds if r.get("host", 0) == hosts[0]]
    phase_ev = [e for e in events if e["event"] == "phase_timings"]
    counter_ev = [e for e in events if e["event"] == "counters"]
    cost_ev = [e for e in events if e["event"] == "cost_analysis"]
    if len(hosts) > 1 and phase_ev:
        # Merged pod logs: every host captured its own (SPMD-identical)
        # programs — join ONE host's cost stream against that SAME
        # host's phase wall-times (the reported phases are the last
        # phase_timings event's; summing all hosts' flops against one
        # host's wallclock would overstate achieved rates by the host
        # count).
        ph_host = phase_ev[-1].get("host", 0)
        cost_ev = [e for e in cost_ev if e.get("host", 0) == ph_host]
    hb_ev = [e for e in events if e["event"] == "train_heartbeat"]
    if len(hosts) > 1:
        # Same single-lane rule as the round curve: SPMD hosts emit
        # identical heartbeats.
        hb_ev = [e for e in hb_ev if e.get("host", 0) == hosts[0]]
    part_ev = [e for e in events if e["event"] == "partition_phases"]
    skew_ev = [e for e in events if e["event"] == "partition_skew"]
    cross_totals = (_cross_host_totals(part_ev)
                    if len(hosts) > 1 and part_ev else None)
    run_end = next((e for e in events if e["event"] == "run_end"), None)

    metric_curve = []
    metric = None
    for r in rounds:
        mk = _metric_key(r)
        if mk is not None:
            metric = mk[len("valid_"):]
            metric_curve.append({"round": r["round"], "score": r[mk]})
    losses = [{"round": r["round"], "train_loss": r["train_loss"]}
              for r in rounds if r.get("train_loss") is not None]

    timed = sorted((r for r in rounds if r.get("ms_per_round") is not None),
                   key=lambda r: -r["ms_per_round"])
    summary = {
        "manifest": {k: v for k, v in manifest.items()
                     if k not in ("event", "schema", "t", "seq")},
        "n_runs_in_log": n_runs,
        "n_round_records": len(rounds),
        "completed_rounds": run_end["completed_rounds"] if run_end else None,
        "wallclock_s": run_end["wallclock_s"] if run_end else None,
        "metric": metric,
        "metric_curve": metric_curve,
        "train_loss_curve": losses,
        "phases": phase_ev[-1]["phases"] if phase_ev else [],
        "counters": (
            {k: v for k, v in counter_ev[-1].items()
             if k not in ("event", "schema", "t", "seq")}
            if counter_ev else {}),
        "slowest_rounds": [
            {"round": r["round"], "ms_per_round": r["ms_per_round"]}
            for r in timed[:slowest]],
        "hosts": hosts,
        # Straggler view (distributed flight recorder): the run's
        # partition_skew reduction + how many rounds carried per-device
        # lanes (fused blocks cover `rounds` rounds per event; merged
        # logs count one host's stream, like the round curve above —
        # single logs are never host-filtered: a lone pod host's events
        # carry no host field). A single host's own skew event is used
        # verbatim (exact, as emitted); a MERGE recomputes over every
        # host's raw lanes, since each per-host event covers only its
        # addressable devices. Empty/None on single-device logs.
        "partition_skew": (
            partition_skew_summary(cross_totals)
            if cross_totals is not None
            else (skew_ev[-1]["phases"] if skew_ev else None)),
        "n_partitions": (
            len(cross_totals) if cross_totals is not None
            else (skew_ev[-1].get("n_partitions") if skew_ev else None)),
        "partition_rounds_observed": sum(
            e.get("rounds", 1) for e in part_ev
            if len(hosts) == 1 or e.get("host", 0) == hosts[0]),
        "early_stop": next(
            ({k: e[k] for k in ("round", "best_round", "best_score",
                                "metric")}
             for e in events if e["event"] == "early_stop"), None),
        "faults": [
            {k: v for k, v in e.items()
             if k not in ("event", "schema", "t", "seq")}
            for e in events if e["event"] == "fault"],
        # Device-truth cost observatory (schema v3): the raw
        # cost_analysis records (the diff tool reads them) — absent-as-
        # empty on pre-v3 logs.
        "cost_events": [
            {k: v for k, v in e.items()
             if k not in ("event", "schema", "t", "seq")}
            for e in cost_ev],
        # Serving tier (schema v4): SLO windows from ServeEngine.
        # emit_latency — None on pre-v4 / non-serving logs so older
        # summaries render exactly as before.
        "serving": _serving_summary(
            [e for e in events if e["event"] == "serve_latency"]),
        # Fleet rollup: per-model join of serve_latency
        # windows (the model_name dimension), eviction/reload lifecycle
        # faults, and artifact provenance — None unless some window
        # carries model_name, so single-model and pre-fleet logs render
        # exactly as before. `cli report --log L fleet` renders just
        # this table.
        "fleet": _fleet_summary(
            [e for e in events if e["event"] == "serve_latency"],
            [e for e in events if e["event"] == "fault"],
            [e for e in events if e["event"] == "artifact"]),
        # SLO rollup: per-model join of declared objectives
        # (the slo_p99_ms extra serve_latency windows carry) against
        # observed tails and slo_breach faults — None unless the log
        # carries EITHER signal, so pre-SLO logs render exactly as
        # before. `cli report --log L slo` renders just this table.
        "slo": _slo_summary(
            [e for e in events if e["event"] == "serve_latency"],
            [e for e in events if e["event"] == "fault"]),
        # Drift rollup: per-model join of latched `drift`
        # alert events against the drift_*/shadow_* extras riding
        # serve_latency windows — None unless the log carries EITHER
        # signal, so pre-drift logs render exactly as before.
        # `cli report --log L drift` renders just this table.
        "drift": _drift_summary(
            [e for e in events if e["event"] == "serve_latency"],
            [e for e in events if e["event"] == "drift"]),
        # Training-progress rollup: how far the run got, from
        # the checkpoint-cadence train_heartbeat events — the signal
        # built for logs of runs that DIED mid-round (read_events
        # tolerates the torn final line; the last intact heartbeat
        # still places the run). None on logs without heartbeats, so
        # every earlier log renders exactly as before. `cli report
        # --log L progress` renders just this table.
        "progress": _progress_summary(hb_ev, rounds, run_end,
                                      manifest),
        # Registry provenance (schema v5): artifact push/load events,
        # each cross-referenced against THIS run's id when they carry
        # one — None on pre-v5 logs.
        "registry": _registry_summary(
            [e for e in events if e["event"] == "artifact"],
            manifest.get("run_id")),
    }
    # Split-finding comms (manifest schema extras — absent on
    # single-device runs and every pre-existing log, which render
    # exactly as before).
    summary["comms"] = None
    if manifest.get("split_comms"):
        summary["comms"] = {
            "split_comms": manifest["split_comms"],
            "hist_comms_dtype": manifest.get("hist_comms_dtype", "f32"),
            "hist_comms_slabs": manifest.get("hist_comms_slabs", 1),
        }
    # Roofline join (telemetry/costmodel.py): only when the log carries
    # cost_analysis events — pre-v3 logs render exactly as before.
    summary["roofline"] = None
    if cost_ev and summary["phases"]:
        from ddt_tpu_torch.telemetry.costmodel import roofline_table

        summary["roofline"] = roofline_table(
            summary["phases"], summary["cost_events"],
            counters=summary["counters"],
            wallclock_s=summary["wallclock_s"])
    return summary


def _serving_summary(serve_ev: list[dict]) -> dict | None:
    """Reduce a run's serve_latency windows for the report: totals
    across windows, the LAST window's quantiles (current behavior), and
    the WORST p99/p999 seen in any window (tail attribution wants the
    worst window, not the most recent one)."""
    if not serve_ev:
        return None
    last = serve_ev[-1]
    return {
        "windows": len(serve_ev),
        "requests": sum(e["requests"] for e in serve_ev),
        "batches": sum(e.get("batches", 0) for e in serve_ev),
        "p50_ms": last["p50_ms"],
        "p99_ms": last["p99_ms"],
        "p999_ms": last.get("p999_ms"),
        "worst_p99_ms": max(e["p99_ms"] for e in serve_ev),
        "worst_p999_ms": max((e.get("p999_ms") or 0.0)
                             for e in serve_ev) or None,
        "coalesce_mean": last.get("coalesce_mean"),
        "coalesce_max": max((e.get("coalesce_max") or 0)
                            for e in serve_ev),
        "queue_depth_max": max((e.get("queue_depth_max") or 0)
                               for e in serve_ev),
        # Quantized-tier extras (None/0 on pre-int4 logs): the quantization
        # tier that ACTUALLY served the last window, and how much
        # traffic rode the express lane across all windows.
        "predict_impl": last.get("predict_impl"),
        "express": sum(e.get("express", 0) or 0 for e in serve_ev),
        "model_tokens": sorted({e["model_token"][:12] for e in serve_ev
                                if e.get("model_token")}),
    }


def _fleet_summary(serve_ev: list[dict], fault_ev: list[dict],
                   artifact_ev: list[dict]) -> dict | None:
    """Per-model fleet rollup: every model's serve_latency windows,
    the tier that actually served its last window, eviction/reload
    counts (fleet_eviction/fleet_reload faults), and the artifact each
    model served (joined to the artifact events' name@version/run_id
    provenance by digest). None unless the log carries the model_name
    dimension — pre-fleet logs summarize exactly as before."""
    named = [e for e in serve_ev if e.get("model_name")]
    if not named:
        return None
    models: dict = {}

    def rec(name) -> dict:
        return models.setdefault(name, {
            "windows": 0, "requests": 0, "express": 0,
            "p50_ms": None, "p99_ms": None, "worst_p99_ms": None,
            "tier": None, "model_token": None, "artifact_digest": None,
            "evictions": 0, "reloads": 0, "artifact": None,
        })

    for e in named:
        m = rec(e["model_name"])
        m["windows"] += 1
        m["requests"] += e["requests"]
        m["express"] += e.get("express", 0) or 0
        m["p50_ms"] = e["p50_ms"]            # last window's quantiles
        m["p99_ms"] = e["p99_ms"]
        m["worst_p99_ms"] = max(m["worst_p99_ms"] or 0.0, e["p99_ms"])
        m["tier"] = e.get("predict_impl") or m["tier"]
        m["model_token"] = e.get("model_token") or m["model_token"]
        m["artifact_digest"] = (e.get("artifact_digest")
                                or m["artifact_digest"])
    for f in fault_ev:
        name = f.get("model_name")
        if not name:
            continue
        if f.get("kind") == "fleet_eviction":
            rec(name)["evictions"] += 1
        elif f.get("kind") == "fleet_reload":
            rec(name)["reloads"] += 1
    # Provenance join: the artifact event stream knows name@version,
    # run_id, and restore mode per digest — attach each model's.
    by_digest = {}
    for a in artifact_ev:
        d = a.get("digest")
        if d:
            by_digest[d] = {
                "name": a.get("name"), "version": a.get("version"),
                "run_id": a.get("run_id"), "mode": a.get("mode")}
    for m in models.values():
        if m["artifact_digest"]:
            m["artifact"] = by_digest.get(m["artifact_digest"])
    return {
        "models": dict(sorted(models.items())),
        "evictions": sum(m["evictions"] for m in models.values()),
        "reloads": sum(m["reloads"] for m in models.values()),
    }


def _slo_summary(serve_ev: list[dict],
                 fault_ev: list[dict]) -> dict | None:
    """Per-model SLO rollup: join declared objectives (the
    slo_p99_ms extra on serve_latency windows) against the observed
    tail and the run's slo_breach faults (burn rate at the transition).
    Mixed-era logs degrade gracefully by construction: pre-SLO windows
    simply carry no objective (rendered `-`, never an error), and a
    model that breached before ever emitting a window enters the table
    through its faults alone — objective recovered from the breach
    event's own objective_ms, quantiles honestly absent. None when the
    log carries neither signal, so pre-SLO logs summarize exactly as
    before."""
    breaches = [f for f in fault_ev if f.get("kind") == "slo_breach"]
    objective_windows = [e for e in serve_ev if e.get("slo_p99_ms")]
    if not breaches and not objective_windows:
        return None
    models: dict = {}

    def rec(name) -> dict:
        return models.setdefault(name, {
            "objective_ms": None, "windows": 0, "requests": 0,
            "p99_ms": None, "worst_p99_ms": None,
            "breaches": 0, "max_burn_rate": None,
        })

    for e in serve_ev:
        name = e.get("model_name") or "default"
        # Only SLO-era windows open a row; older windows still fold
        # into an existing row's tail so the worst p99 is honest.
        if not e.get("slo_p99_ms") and name not in models:
            continue
        m = rec(name)
        m["objective_ms"] = e.get("slo_p99_ms") or m["objective_ms"]
        m["windows"] += 1
        m["requests"] += e["requests"]
        m["p99_ms"] = e["p99_ms"]            # last window's tail
        m["worst_p99_ms"] = max(m["worst_p99_ms"] or 0.0, e["p99_ms"])
    for f in breaches:
        m = rec(f.get("model_name") or "default")
        m["breaches"] += 1
        if m["objective_ms"] is None:
            m["objective_ms"] = f.get("objective_ms")
        burn = f.get("burn_rate")
        if burn is not None:
            m["max_burn_rate"] = max(m["max_burn_rate"] or 0.0, burn)
    return {
        "models": dict(sorted(models.items())),
        "breaches": len(breaches),
    }


def _drift_summary(serve_ev: list[dict],
                   drift_ev: list[dict]) -> dict | None:
    """Per-model drift rollup: join the observatory's two
    log signals — latched `drift` alert events and the drift_*/shadow_*
    extras serve_latency windows carry — into one table. Mixed-era logs
    degrade gracefully by construction: pre-drift windows simply carry
    no divergence (rendered `-`, never an error), and a model that
    alerted before ever emitting a window enters the table through its
    events alone. None when the log carries neither signal, so
    pre-drift logs summarize exactly as before."""
    windows = [e for e in serve_ev
               if e.get("drift_psi_max") is not None
               or e.get("shadow_model")]
    if not drift_ev and not windows:
        return None
    models: dict = {}

    def rec(name) -> dict:
        return models.setdefault(name, {
            "windows": 0, "requests": 0,
            "psi_max": None, "worst_psi_max": None, "js_max": None,
            "alerting": False, "alerts": 0,
            "worst_feature": None, "threshold": None,
            "shadow": None,
        })

    for e in serve_ev:
        name = e.get("model_name") or "default"
        has_drift = e.get("drift_psi_max") is not None
        has_shadow = bool(e.get("shadow_model"))
        # Only drift-era windows open a row; older windows still fold
        # into an existing row's traffic so the request count is honest.
        if not has_drift and not has_shadow and name not in models:
            continue
        m = rec(name)
        m["windows"] += 1
        m["requests"] += e["requests"]
        if has_drift:
            m["psi_max"] = e["drift_psi_max"]     # last window's score
            m["js_max"] = e.get("drift_js_max")
            m["worst_psi_max"] = max(m["worst_psi_max"] or 0.0,
                                     e["drift_psi_max"])
            m["alerting"] = bool(e.get("drift_alerting"))
        if has_shadow:
            m["shadow"] = {
                "model": e["shadow_model"],
                "rows": e.get("shadow_rows"),
                "mean_abs_diff": e.get("shadow_mean_abs_diff"),
                "ms_p50": e.get("shadow_ms_p50"),
                "dropped": e.get("shadow_dropped", 0) or 0,
            }
    for d in drift_ev:
        m = rec(d.get("model_name") or "default")
        m["alerts"] += 1
        m["worst_psi_max"] = max(m["worst_psi_max"] or 0.0,
                                 d["psi_max"])
        m["worst_feature"] = d.get("feature", m["worst_feature"])
        m["threshold"] = d.get("threshold") or m["threshold"]
    return {"models": dict(sorted(models.items())),
            "alerts": len(drift_ev)}


def _progress_summary(hb_ev: list[dict], rounds: list[dict],
                      run_end, manifest: dict) -> dict | None:
    """Training-progress rollup: reduce the checkpoint-
    cadence train_heartbeat events into "how far did this run get" —
    the question asked about a run log whose process died mid-round
    (no run_end, possibly a torn final line). The furthest round is the
    max over heartbeats AND intact round records, so a run that died
    between heartbeats is still placed as precisely as the log allows.
    None when the log carries no heartbeats, so every log without heartbeats
    summarizes exactly as before."""
    if not hb_ev:
        return None
    last_hb = max((h.get("round", 0) for h in hb_ev), default=0)
    last_rec = max((r.get("round", 0) for r in rounds), default=0)
    last_round = max(last_hb, last_rec)
    total = (hb_ev[-1].get("total_rounds")
             or manifest.get("n_trees"))
    ckpt = next((h["checkpoint_round"] for h in reversed(hb_ev)
                 if h.get("checkpoint_round") is not None), None)
    return {
        "heartbeats": len(hb_ev),
        "last_round": last_round,
        "total_rounds": total,
        "pct": (round(100.0 * last_round / total, 1)
                if total else None),
        "last_checkpoint_round": ckpt,
        # A run_end event means the epilogue ran — the run FINISHED
        # (possibly early-stopped); its absence is the mid-run-death
        # signal this rollup exists for.
        "completed": run_end is not None,
        "beats": [
            {k: h.get(k) for k in ("round", "total_rounds",
                                   "checkpoint_round", "ms_per_round",
                                   "rows_per_s")}
            for h in hb_ev],
    }


def _registry_summary(artifact_ev: list[dict],
                      log_run_id) -> dict | None:
    """Reduce a run's artifact events for the report: one record per
    event (they are rare — lifecycle steps, not request traffic), with
    `same_run` marking artifacts whose embedded training run_id matches
    this log's own manifest — the provenance join the registry exists
    to provide (train --run-log L; registry push; report --log L shows
    the push against its own run)."""
    if not artifact_ev:
        return None
    events = []
    for e in artifact_ev:
        rec = {
            "action": e["action"],
            "digest": e["digest"],
            "name": e.get("name"),
            "version": e.get("version"),
            "run_id": e.get("run_id"),
            "mode": e.get("mode"),
            "same_run": (e.get("run_id") is not None
                         and e.get("run_id") == log_run_id),
        }
        events.append(rec)
    return {
        "events": events,
        "pushes": sum(1 for e in events if e["action"] == "push"),
        "loads": sum(1 for e in events if e["action"] == "load"),
        "digests": sorted({e["digest"] for e in events if e["digest"]}),
    }


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n}"


def render_fleet(summary: dict) -> str:
    """The `report fleet` rollup: one row per model joining its SLO
    windows, serving tier, eviction/reload counts, and artifact
    provenance (docs/OBSERVABILITY.md). Raises ValueError when the log
    carries no fleet data (no model_name-dimensioned windows)."""
    fl = summary.get("fleet")
    if not fl:
        raise ValueError(
            "log carries no fleet serve_latency windows (no model_name "
            "dimension) — is this a single-model serve log?")
    out = [f"fleet: {len(fl['models'])} model(s), "
           f"{fl['evictions']} eviction(s), {fl['reloads']} reload(s)"]
    out.append(
        f"  {'model':<12} {'reqs':>7} {'win':>4} {'p50_ms':>8} "
        f"{'p99_ms':>8} {'worst_p99':>9} {'tier':<5} {'evic':>4} "
        f"{'reld':>4}  artifact")
    def ms(v) -> str:
        # A model can enter the rollup through lifecycle faults alone
        # (evicted before it ever served a window) — its quantiles are
        # honestly absent, not zero.
        return f"{v:>8.3f}" if v is not None else f"{'-':>8}"

    for name, m in fl["models"].items():
        art = m.get("artifact_digest") or "-"
        prov = m.get("artifact")
        if prov and prov.get("name") and prov.get("version") is not None:
            art += f" ({prov['name']}@{prov['version']}"
            if prov.get("mode"):
                art += f", {prov['mode']}"
            art += ")"
        out.append(
            f"  {name:<12} {m['requests']:>7} {m['windows']:>4} "
            f"{ms(m['p50_ms'])} {ms(m['p99_ms'])} "
            f"{ms(m['worst_p99_ms']):>9} "
            f"{(m['tier'] or '-'):<5} {m['evictions']:>4} "
            f"{m['reloads']:>4}  {art}")
    return "\n".join(out)


def render_slo(summary: dict) -> str:
    """The `report slo` rollup: one row per model joining its declared
    p99 objective against the observed tail and the run's slo_breach
    burn rates (docs/OBSERVABILITY.md). Absent values — a pre-SLO
    window's objective, a breached-before-first-window model's
    quantiles — render `-`, never an error. Raises ValueError when the
    log carries no SLO signal at all (no objectives, no breaches)."""
    slo = summary.get("slo")
    if not slo:
        raise ValueError(
            "log carries no SLO data (no slo_p99_ms objectives on "
            "serve_latency windows and no slo_breach faults) — was "
            "this server configured with an SLO (slo_p99_ms=)?")

    def ms(v) -> str:
        return f"{v:>9.3f}" if v is not None else f"{'-':>9}"

    out = [f"slo: {len(slo['models'])} model(s), "
           f"{slo['breaches']} breach(es)"]
    out.append(
        f"  {'model':<12} {'objective':>9} {'p99_ms':>9} "
        f"{'worst_p99':>9} {'win':>4} {'reqs':>7} {'breach':>6} "
        f"{'max_burn':>8}")
    for name, m in slo["models"].items():
        burn = (f"{m['max_burn_rate']:>8.2f}"
                if m.get("max_burn_rate") is not None else f"{'-':>8}")
        out.append(
            f"  {name:<12} {ms(m['objective_ms'])} {ms(m['p99_ms'])} "
            f"{ms(m['worst_p99_ms'])} {m['windows']:>4} "
            f"{m['requests']:>7} {m['breaches']:>6} {burn}")
    return "\n".join(out)


def render_drift(summary: dict) -> str:
    """The `report drift` rollup: one row per model joining rolling-
    window divergence (PSI / JS against the training reference) with
    latched drift alerts, plus one champion/challenger line per
    shadowed model (docs/OBSERVABILITY.md "Drift observatory"). Absent
    values — a pre-drift window's divergence, an alert-only model's
    window stats — render `-`, never an error. Raises ValueError when
    the log carries no drift signal at all (no drift events, no
    drift/shadow window extras)."""
    dr = summary.get("drift")
    if not dr:
        raise ValueError(
            "log carries no drift data (no drift events and no "
            "drift_*/shadow_* extras on serve_latency windows) — did "
            "this fleet serve an artifact with a training reference "
            "histogram (drift_reference)?")

    def f(v) -> str:
        return f"{v:>8.4f}" if v is not None else f"{'-':>8}"

    out = [f"drift: {len(dr['models'])} model(s), "
           f"{dr['alerts']} alert(s)"]
    out.append(
        f"  {'model':<12} {'psi_max':>8} {'worst':>8} {'js_max':>8} "
        f"{'win':>4} {'reqs':>7} {'alerts':>6} {'state':<8} feature")
    for name, m in dr["models"].items():
        state = "ALERTING" if m["alerting"] else "ok"
        feat = m["worst_feature"] if m["worst_feature"] is not None \
            else "-"
        out.append(
            f"  {name:<12} {f(m['psi_max'])} {f(m['worst_psi_max'])} "
            f"{f(m['js_max'])} {m['windows']:>4} {m['requests']:>7} "
            f"{m['alerts']:>6} {state:<8} {feat}")
    for name, m in dr["models"].items():
        sh = m.get("shadow")
        if not sh:
            continue
        diff = (f"mean_abs_diff={sh['mean_abs_diff']:.6f}"
                if sh.get("mean_abs_diff") is not None
                else "mean_abs_diff=-")
        p50 = (f"p50={sh['ms_p50']:.3f} ms"
               if sh.get("ms_p50") is not None else "p50=-")
        out.append(
            f"  shadow {sh['model']} -> {name}: "
            f"rows={sh.get('rows') or 0}  {diff}  {p50}  "
            f"dropped={sh['dropped']}")
    return "\n".join(out)


def render_progress(summary: dict) -> str:
    """The `report progress` rollup: round reached vs total, the last
    checkpoint round, and one row per heartbeat with its pace
    (docs/OBSERVABILITY.md "Training operations plane"). Raises
    ValueError on a log with no train_heartbeat events — the loud
    failure `cli report progress` converts into a clean SystemExit."""
    pg = summary.get("progress")
    if not pg:
        raise ValueError(
            "log carries no training heartbeat data (no "
            "train_heartbeat events) — heartbeats are emitted at "
            "checkpoint cadence by schema-v5+ training runs; was this "
            "log written by an older run, or did the run die before "
            "the first checkpoint boundary?")
    state = "completed" if pg["completed"] else "DIED MID-RUN"
    total = pg["total_rounds"]
    pct = f" ({pg['pct']:.1f}%)" if pg.get("pct") is not None else ""
    ckpt = (str(pg["last_checkpoint_round"])
            if pg.get("last_checkpoint_round") is not None else "-")
    out = [
        f"progress: round {pg['last_round']}/{total or '?'}{pct}  "
        f"[{state}]  heartbeats={pg['heartbeats']}  "
        f"last_checkpoint={ckpt}"]
    out.append(
        f"  {'round':>6} {'ms/round':>9} {'rows/s':>10} {'ckpt':>5}")
    for h in pg["beats"]:
        ms = (f"{h['ms_per_round']:>9.1f}"
              if h.get("ms_per_round") is not None else f"{'-':>9}")
        rps = (f"{h['rows_per_s']:>10.1f}"
               if h.get("rows_per_s") is not None else f"{'-':>10}")
        ck = (str(h["checkpoint_round"])
              if h.get("checkpoint_round") is not None else "-")
        out.append(f"  {h.get('round', 0):>6} {ms} {rps} {ck:>5}")
    return "\n".join(out)


def render(summary: dict) -> str:
    """Terminal rendering of summarize()'s dict."""
    out: list[str] = []
    m = summary["manifest"]
    head = " ".join(
        f"{k}={m[k]}" for k in ("trainer", "backend", "loss", "n_trees",
                                "max_depth", "rows", "features") if k in m)
    out.append(f"run: {head or '(no manifest)'}")
    if summary.get("n_runs_in_log", 1) > 1:
        out.append(f"note: log holds {summary['n_runs_in_log']} run "
                   "segments; reporting the last")
    done = summary["completed_rounds"]
    wc = summary["wallclock_s"]
    out.append(
        f"rounds: {summary['n_round_records']} recorded"
        + (f", {done} completed" if done is not None else "")
        + (f", {wc:.2f}s wallclock" if wc is not None else ""))

    if summary["early_stop"]:
        es = summary["early_stop"]
        out.append(
            f"early stop at round {es['round']} "
            f"(best {es['metric']}={es['best_score']:.6f} "
            f"at round {es['best_round']})")
    for f in summary["faults"]:
        detail = {k: v for k, v in f.items() if k != "kind"}
        out.append(f"fault/recovery: {f['kind']} {detail or ''}".rstrip())

    if len(summary.get("hosts", [0])) > 1:
        out.append(f"hosts: {len(summary['hosts'])} merged "
                   f"({', '.join(str(h) for h in summary['hosts'])})")

    if summary["phases"]:
        out.append("phases (host wallclock):")
        for p in summary["phases"]:
            out.append(
                f"  {p['phase']:<14} {p['ms_total']:>9.1f} ms total  "
                f"{p['ms_per_call']:>8.2f} ms/call  x{p['calls']:<6} "
                f"{100 * p['share']:5.1f}%")

    if summary.get("roofline"):
        out.append("roofline (XLA cost model vs host wallclock; "
                   "achieved against per-platform peak ceilings):")
        for r in summary["roofline"]:
            if r.get("coll_util") is not None:
                dev = (f"{r['gbs']:>8.2f} GB/s wire "
                       f"({100 * r['coll_util']:5.1f}% interconnect)")
            elif r.get("gflops") is None:
                dev = "no device cost registered"
            else:
                dev = (f"{r['gflops']:>9.2f} GFLOP/s "
                       f"({100 * r['flops_util']:5.1f}%)  "
                       f"{r['gbs']:>8.2f} GB/s "
                       f"({100 * r['hbm_util']:5.1f}%)")
            out.append(
                f"  {r['phase']:<14} {r['ms']:>9.1f} ms  {dev:<44} "
                f"-> {r['verdict']}")

    if summary.get("partition_skew"):
        n = summary.get("n_partitions")
        out.append(
            f"partitions ({n} lanes, "
            f"{summary.get('partition_rounds_observed', 0)} rounds "
            "observed; straggler = max/median completion):")
        for p in summary["partition_skew"]:
            skew = f"{p['skew']:.2f}x" if p.get("skew") is not None \
                else "n/a"
            where = (f"h{p['max_host']}/dev{p['max_device']}"
                     if "max_host" in p else f"dev{p['max_device']}")
            out.append(
                f"  {p['phase']:<14} max {p['ms_max']:>9.1f} ms "
                f"@{where:<8} median "
                f"{p['ms_median']:>9.1f} ms  skew {skew}")

    if summary.get("serving"):
        s = summary["serving"]
        out.append(
            f"serving: {s['requests']} requests in {s['windows']} "
            f"window(s), {s['batches']} micro-batches  "
            f"(coalesce max {s['coalesce_max']}, "
            f"queue depth max {s['queue_depth_max']})")
        p999 = (f"  p999={s['p999_ms']:.3f} ms"
                if s.get("p999_ms") is not None else "")
        worst = (f"  worst-window p99={s['worst_p99_ms']:.3f} ms"
                 if s.get("worst_p99_ms") is not None else "")
        out.append(
            f"  latency: p50={s['p50_ms']:.3f} ms  "
            f"p99={s['p99_ms']:.3f} ms{p999}{worst}")
        extras = []
        if s.get("predict_impl"):
            extras.append(f"tier={s['predict_impl']}")
        if s.get("express"):
            extras.append(f"express={s['express']}")
        if extras:
            out.append("  " + "  ".join(extras))
        if s.get("model_tokens"):
            out.append("  models served: "
                       + ", ".join(s["model_tokens"]))

    if summary.get("fleet"):
        out.append(render_fleet(summary))

    if summary.get("slo"):
        out.append(render_slo(summary))

    if summary.get("drift"):
        out.append(render_drift(summary))

    if summary.get("registry"):
        r = summary["registry"]
        out.append(
            f"registry: {r['pushes']} push(es), {r['loads']} load(s) "
            f"across {len(r['digests'])} artifact(s)")
        for e in r["events"]:
            where = (f"{e['name']}@{e['version']}"
                     if e.get("name") and e.get("version") else "")
            bits = [b for b in (
                where,
                e["digest"],
                f"mode={e['mode']}" if e.get("mode") else "",
                f"run_id={e['run_id']}" + (
                    " (this run)" if e["same_run"] else "")
                if e.get("run_id") else "",
            ) if b]
            out.append(f"  {e['action']:<5} " + "  ".join(bits))

    curve = summary["metric_curve"]
    if curve:
        name = summary["metric"]
        first, last = curve[0], curve[-1]
        # Direction from the ONE metrics table (utils.metrics) — a copy
        # here would silently label the worst round "best" for any
        # metric added there later. Unknown names (a log from a newer
        # build) default to lower-is-better, the loss convention.
        from ddt_tpu_torch.utils.metrics import GREATER_IS_BETTER

        best = max(curve, key=lambda c: c["score"]) \
            if GREATER_IS_BETTER.get(name, False) \
            else min(curve, key=lambda c: c["score"])
        out.append(
            f"valid_{name}: first={first['score']:.6f} "
            f"(round {first['round']})  best={best['score']:.6f} "
            f"(round {best['round']})  last={last['score']:.6f} "
            f"(round {last['round']})  [{len(curve)} rounds]")
    losses = summary["train_loss_curve"]
    if losses:
        out.append(
            f"train_loss: first={losses[0]['train_loss']:.6f} "
            f"(round {losses[0]['round']})  "
            f"last={losses[-1]['train_loss']:.6f} "
            f"(round {losses[-1]['round']})")

    c = summary["counters"]
    if c:
        compile_s = c.get("jit_compile_seconds")
        out.append(
            "counters: "
            f"jit_compiles={c.get('jit_compiles')}"
            + (f" ({compile_s:.2f}s compiling)"
               if compile_s is not None else "")
            + "  "
            f"h2d={_fmt_bytes(c.get('h2d_bytes'))}  "
            f"d2h={_fmt_bytes(c.get('d2h_bytes'))}  "
            f"collective≈{_fmt_bytes(c.get('collective_bytes_est'))}  "
            f"device_peak={_fmt_bytes(c.get('device_peak_bytes'))}  "
            f"host_rss_peak={_fmt_bytes(c.get('host_peak_rss_bytes'))}")
        # Per-mode comms line: the resolved split-finding
        # collective + wire dtype next to the EFFECTIVE payload the
        # counter above already reflects (subtraction-halved levels,
        # scattered slabs, compressed entries).
        cm = summary.get("comms")
        if cm:
            out.append(
                "comms: "
                f"split_comms={cm['split_comms']}  "
                f"wire_dtype={cm['hist_comms_dtype']}  "
                f"slabs={cm['hist_comms_slabs']}  "
                f"payload≈{_fmt_bytes(c.get('collective_bytes_est'))} "
                "(effective)")
        # Scoring-cache effectiveness (absent in pre-overhaul logs).
        hits = c.get("compiled_ensemble_cache_hits")
        if hits is not None:
            out.append(f"predict: compiled_ensemble_cache_hits={hits}")
        # Robustness health pair (docs/ROBUSTNESS.md): nonzero means the
        # run limped through faults — say so even when it finished green.
        retries = c.get("fault_retries") or 0
        degrades = c.get("hist_oom_degrades") or 0
        if retries or degrades:
            out.append(f"robustness: fault_retries={retries}  "
                       f"hist_oom_degrades={degrades}")

    if summary["slowest_rounds"]:
        slow = ", ".join(f"#{r['round']} ({r['ms_per_round']:.1f} ms)"
                         for r in summary["slowest_rounds"])
        out.append(f"slowest rounds: {slow}")
    return "\n".join(out)
