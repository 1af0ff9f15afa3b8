"""Run-log diffing: `cli report diff A B` — "r06 got slower" -> why.
(Copied from ddt_tpu/telemetry/diffing.py.)

Given two run logs (same config or not — the diff says what changed,
the reader judges comparability), align by phase and counter and compute
per-phase wall-time and per-counter deltas, plus cost-analysis byte/flop
movement per phase. Excursions are flagged with benchwatch's band logic
degenerated to a single baseline: tools/benchwatch bands a metric at
median ± max(3·MAD, REL_FLOOR·|median|); with exactly one baseline run
the MAD term is zero, so the gate is the relative floor — an ADVERSE
move past REL_FLOOR (20%) of A's value flags, a favorable move never
does (one-sided, direction-aware, exactly the sentinel's semantics;
keep REL_FLOOR in sync with tools.benchwatch.REL_FLOOR).

The output turns "round 6 got slower" into "gain +34% (ms_total
120.1 -> 161.0), jit_compiles 12 -> 48, hist bytes-accessed x2.1".
Pure host-side post-processing (read -> summarize -> diff): no jax, no
device — two logs copied off a pod diff anywhere.
"""

from __future__ import annotations

#: mirror of tools.benchwatch.REL_FLOOR (the library must not import the
#: repo-layout tools/ package; the value is contract-commented there).
REL_FLOOR = 0.20

#: counter -> the direction whose GAIN is adverse. "lower" = an increase
#: flags; "higher" = a decrease flags; "neutral" = declared
#: workload-shape, never banded (request mix, fleet churn — a move in
#: either direction is a different workload, not a regression). EVERY
#: registered counter must appear here: a counter absent from this table
#: renders with a loud `direction=?` marker (and fails ddtlint's
#: counter-direction-missing rule) because an unknown direction silently
#: exempts the counter from the gate. Unknown numeric counters are still
#: reported, never flagged (benchwatch's unknown-metric rule: a guessed
#: direction can invert the gate).
COUNTER_DIRECTIONS: dict[str, str] = {
    "jit_compiles": "lower",
    "jit_compile_seconds": "lower",
    "h2d_bytes": "lower",
    "d2h_bytes": "lower",
    "collective_bytes_est": "lower",
    # Quantized gradients: the effective g/h HBM-stream
    # model — an f32 run diffed against an int8 run of the same shape
    # shows the 4x drop here; a quantized run regressing UP means the
    # integer path silently fell back to f32 streams.
    "grad_stream_bytes_est": "lower",
    "device_peak_bytes": "lower",
    "host_peak_rss_bytes": "lower",
    "compiled_ensemble_cache_hits": "higher",
    # Robustness counters: any uptick means the fault path fired — a
    # chaos run is EXPECTED to move these, but an ordinary A/B diff that
    # shows retries or OOM degradations appearing is a regression.
    "fault_retries": "lower",
    "hist_oom_degrades": "lower",
    # SLO breach transitions (serve/fleet.py): a serving A/B
    # whose B run starts burning its latency budget is a regression no
    # matter what the request mix looked like.
    "slo_breaches": "lower",
    # Drift alert transitions (serve/drift.py): a serving A/B
    # whose B run starts diverging from its training reference is a
    # regression regardless of the request mix — drift is a property of
    # the traffic-vs-model pairing, not of load.
    "drift_alerts": "lower",
    # Workload-shape counters: request mix and fleet churn track what
    # was ASKED of the system, not how well it did — deliberately
    # "neutral" so a bigger replay never reads as a regression.
    "serve_requests": "neutral",
    "serve_batches": "neutral",
    "serve_hot_swaps": "neutral",
    "serve_express": "neutral",
    "fleet_evictions": "neutral",
    "fleet_reloads": "neutral",
    "grad_quant_rounds": "neutral",
    # Training operations plane: rounds completed and
    # heartbeats emitted track the run's configured shape (n_trees,
    # checkpoint cadence), not its quality — a longer run must never
    # read as a regression, so both are "neutral".
    "train_rounds": "neutral",
    "train_heartbeats": "neutral",
}

#: flag floor for near-zero baselines (a 0 -> 3 ms phase is noise, a
#: 0 -> 300 ms phase is not).
ABS_FLOOR_MS = 50.0


def _cost_by_phase(summary: dict) -> dict:
    out: dict[str, dict] = {}
    for e in summary.get("cost_events") or []:
        rec = out.setdefault(e.get("phase", e.get("op")),
                             {"flops": 0.0, "bytes_accessed": 0.0})
        rec["flops"] += e.get("flops", 0.0) * e.get("calls", 1)
        rec["bytes_accessed"] += (e.get("bytes_accessed", 0.0)
                                  * e.get("calls", 1))
    return out


def _ratio(a, b):
    if not a:
        return None
    return round(b / a, 3)


def diff_summaries(sa: dict, sb: dict, threshold: float = REL_FLOOR,
                   abs_floor_ms: float = ABS_FLOOR_MS) -> dict:
    """Diff two report.summarize() dicts (A = baseline, B = current).
    Returns {"phases", "counters", "cost", "rounds", "flagged"} — the
    flagged list is the headline: human-ready attribution strings,
    worst first. `abs_floor_ms` suppresses phase flags on sub-noise
    absolute moves (drop it to 0 to band micro-runs)."""
    out: dict = {"phases": [], "counters": [], "cost": [],
                 "rounds": {}, "flagged": []}

    pa = {p["phase"]: p for p in sa.get("phases") or []}
    pb = {p["phase"]: p for p in sb.get("phases") or []}
    names = sorted(set(pa) | set(pb),
                   key=lambda n: -(pa.get(n, pb.get(n))["ms_total"]))
    for name in names:
        a, b = pa.get(name), pb.get(name)
        rec = {
            "phase": name,
            "a_ms": a["ms_total"] if a else None,
            "b_ms": b["ms_total"] if b else None,
            "a_ms_per_call": a["ms_per_call"] if a else None,
            "b_ms_per_call": b["ms_per_call"] if b else None,
            "a_calls": a["calls"] if a else 0,
            "b_calls": b["calls"] if b else 0,
            "flag": None,
        }
        if a and b:
            delta = b["ms_total"] - a["ms_total"]
            rec["delta_ms"] = round(delta, 2)
            rec["ratio"] = _ratio(a["ms_total"], b["ms_total"])
            if delta > max(threshold * a["ms_total"], abs_floor_ms):
                rec["flag"] = "slower"
                pct = 100.0 * delta / a["ms_total"]
                out["flagged"].append(
                    f"{name} +{pct:.0f}% ({a['ms_total']:.1f} -> "
                    f"{b['ms_total']:.1f} ms total, "
                    f"{a['ms_per_call']:.2f} -> {b['ms_per_call']:.2f} "
                    "ms/call)")
        elif b and not a:
            rec["flag"] = "new"
        elif a and not b:
            rec["flag"] = "gone"
        out["phases"].append(rec)

    ca = sa.get("counters") or {}
    cb = sb.get("counters") or {}
    for key in sorted(set(ca) | set(cb)):
        va, vb = ca.get(key), cb.get(key)
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in (va, vb) if v is not None):
            continue
        direction = COUNTER_DIRECTIONS.get(key)
        # "?" marks a counter missing from COUNTER_DIRECTIONS — loud in
        # both the JSON record and the text rendering so the gap is
        # visible at the point of use, not just in the lint gate.
        rec = {"counter": key, "a": va, "b": vb, "flag": None,
               "direction": direction or "?"}
        # A zero/absent baseline has no band to measure against — the
        # benchwatch rule (metrics with no usable history are reported,
        # never guessed at): a single-chip baseline's
        # collective_bytes_est=0 vs a pod run's N must not fail --check.
        # "neutral" (and unknown) directions are reported, never banded.
        if va and vb is not None and direction in ("lower", "higher"):
            delta = vb - va
            adverse = delta if direction == "lower" else -delta
            if adverse > threshold * abs(va) and adverse > 0:
                rec["flag"] = "worse"
                out["flagged"].append(f"{key} {va:g} -> {vb:g}")
        out["counters"].append(rec)

    costa, costb = _cost_by_phase(sa), _cost_by_phase(sb)
    for name in sorted(set(costa) | set(costb)):
        a = costa.get(name, {"flops": 0.0, "bytes_accessed": 0.0})
        b = costb.get(name, {"flops": 0.0, "bytes_accessed": 0.0})
        rec = {"phase": name,
               "a_bytes": a["bytes_accessed"], "b_bytes": b["bytes_accessed"],
               "bytes_ratio": _ratio(a["bytes_accessed"],
                                     b["bytes_accessed"]),
               "a_flops": a["flops"], "b_flops": b["flops"],
               "flops_ratio": _ratio(a["flops"], b["flops"]),
               "flag": None}
        br = rec["bytes_ratio"]
        if br is not None and br > 1.0 + threshold:
            rec["flag"] = "bytes-bloat"
            out["flagged"].append(f"{name} bytes-accessed x{br:.1f}")
        out["cost"].append(rec)

    wa, wb = sa.get("wallclock_s"), sb.get("wallclock_s")
    out["rounds"] = {
        "a_rounds": sa.get("completed_rounds"),
        "b_rounds": sb.get("completed_rounds"),
        "a_wallclock_s": wa, "b_wallclock_s": wb,
        "wallclock_ratio": _ratio(wa, wb) if wa and wb else None,
    }
    return out


def render_diff(d: dict, label_a: str = "A", label_b: str = "B") -> str:
    """Terminal rendering of diff_summaries()."""
    out = [f"run diff: A={label_a}  B={label_b}"]
    r = d["rounds"]
    if r.get("a_wallclock_s") is not None \
            and r.get("b_wallclock_s") is not None:
        out.append(
            f"wallclock: {r['a_wallclock_s']:.2f}s -> "
            f"{r['b_wallclock_s']:.2f}s"
            + (f"  (x{r['wallclock_ratio']:.2f})"
               if r.get("wallclock_ratio") else "")
            + f"  rounds {r['a_rounds']} -> {r['b_rounds']}")
    if d["flagged"]:
        out.append("flagged excursions (adverse move past the "
                   f"{int(100 * REL_FLOOR)}% band):")
        for f in d["flagged"]:
            out.append(f"  ! {f}")
    else:
        out.append("no adverse excursions past the band")
    if d["phases"]:
        out.append("phases (ms total A -> B):")
        for p in d["phases"]:
            a = f"{p['a_ms']:.1f}" if p["a_ms"] is not None else "-"
            b = f"{p['b_ms']:.1f}" if p["b_ms"] is not None else "-"
            extra = f"  x{p['ratio']:.2f}" if p.get("ratio") else ""
            flag = f"  [{p['flag']}]" if p["flag"] else ""
            out.append(f"  {p['phase']:<14} {a:>10} -> {b:>10}"
                       f"{extra}{flag}")
    changed = [c for c in d["counters"]
               if c["a"] != c["b"] or c["flag"]]
    if changed:
        out.append("counters (A -> B):")
        for c in changed:
            flag = "  [worse]" if c["flag"] else ""
            # Loud marker: this counter has no registered direction, so
            # it can NEVER flag — the gate is silently blind to it until
            # COUNTER_DIRECTIONS (and the lint contract) learn it.
            unknown = ("  direction=? (unregistered counter — add it to "
                       "COUNTER_DIRECTIONS)"
                       if c.get("direction") == "?" else "")
            out.append(f"  {c['counter']:<28} {c['a']} -> {c['b']}"
                       f"{flag}{unknown}")
    bloat = [c for c in d["cost"] if c["bytes_ratio"] not in (None, 1.0)]
    if bloat:
        out.append("cost-analysis bytes accessed per phase (A -> B):")
        for c in bloat:
            flag = "  [bytes-bloat]" if c["flag"] else ""
            out.append(
                f"  {c['phase']:<14} {c['a_bytes']:.3g} -> "
                f"{c['b_bytes']:.3g}  x{c['bytes_ratio']:.2f}{flag}")
    return "\n".join(out)
