"""Cost observatory: what each kernel's call costs, wired to the run log
(port of ddt_tpu/telemetry/costmodel.py).

The reference reads XLA's compiled-executable cost analysis. The port
has no compiler cost model, so each costed dispatcher carries an
analytic one: the bytes its call must move (each input read once, each
output written once) and the operations it does, from its arguments'
shapes, by the same formulas chip_smoke.py's bounds use. A count that
would depend on the data (the active rows of a histogram level, the
compares a row's path takes) takes the shape's full count, so the bytes
and operations are upper bounds, and so are the achieved rates the
roofline computes from them.

- costed(op, phase, cost) wraps a dispatcher. With a collector
  active (a run with a run log), the first call of a new argument
  signature records the analytic cost, and every call adds one to its
  count. Inside a CUDA-graph capture the call, with its cost, goes into
  the capture's utils/launches.Recording whether or not a collector is
  active, and each replay adds it to the collector active at replay time
  (add_replay): a wrapper met once at capture counts once a replay, also
  in a run that replays a round captured by an earlier run without one.
  With no collector and no capture open, a call costs two module-global
  reads.
- Collector / activate() / flush_into(): one run's records, flushed by
  telemetry.events.finish_run_log as `cost_analysis` events, one per
  (op, signature), the per-call flops and bytes_accessed with the count.
- roofline_table(): the read side, copied from the reference: cost
  events joined to the run's phase_timings, achieved GFLOP/s and GB/s
  against the platform's peak ceilings, and a bound-by verdict.
"""

from __future__ import annotations

import functools

from ddt_tpu_torch.utils import launches

#: Per-platform roofline ceilings: peak GFLOP/s, memory GB/s and the
#: collective link's GB/s. The tpu / gpu / cpu rows are the reference's
#: (its logs render with the same verdicts here); the "gpu" row stands
#: for any card without a row of its own. The H100 SXM row is NVIDIA's
#: data sheet, not a measurement: HBM3 bandwidth, f32 FLOP/s outside the
#: tensor cores (an FMA counted as two operations on 128 FP32 lanes an
#: SM) and NVLink's bandwidth one way. peaks_for() picks a card's row
#: from its name; chip_smoke.py's kernel bounds read the same row.
PEAK_CEILINGS: dict[str, dict] = {
    "tpu": {"gflops": 197_000.0, "gbs": 819.0, "coll_gbs": 90.0},
    "gpu": {"gflops": 19_500.0, "gbs": 900.0, "coll_gbs": 300.0},
    "cpu": {"gflops": 150.0, "gbs": 30.0, "coll_gbs": 10.0},
    "h100_sxm": {"gflops": 67_000.0, "gbs": 3_350.0, "coll_gbs": 450.0,
                 "source": "H100 SXM data sheet"},
}

#: Below this utilization on both roofline axes the device was mostly
#: idle during the phase: the phase is host/dispatch-bound.
HOST_BOUND_UTIL = 0.02
#: Run-level compile share (counters.jit_compile_seconds over the run's
#: wall) above which idle-device phases are attributed to compiling.
RECOMPILE_WALL_SHARE = 0.25

# ------------------------------------------------------------------ #
# collection
# ------------------------------------------------------------------ #

_active: "Collector | None" = None


def _platform(args) -> str:
    """The card's name for a CUDA tensor argument, else "cpu"."""
    for a in args:
        dev = getattr(a, "device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            return torch.cuda.get_device_name(dev)
    return "cpu"


class Collector:
    """Capture state for one telemetry run: (op, signature) -> record."""

    def __init__(self):
        self.records: dict[tuple, dict] = {}

    def events(self) -> list[dict]:
        """Flushable cost_analysis payloads, op-sorted for stable logs."""
        return [dict(r) for r in sorted(
            self.records.values(),
            key=lambda r: (r["op"], r["signature"]))]


def _record(op: str, phase: str, cost, sig: tuple, args, kwargs) -> dict:
    """A signature's cost record, with no calls yet."""
    flops, nbytes = cost(*args, **kwargs)
    return {"op": op, "phase": phase, "calls": 0, "signature": _sig_str(sig),
            "flops": float(flops), "bytes_accessed": float(nbytes),
            "platform": _platform(args)}


def _on_call(col: "Collector | None", op: str, phase: str, cost, args,
             kwargs) -> None:
    """One costed call: into the capture's recording when the current
    stream is capturing a graph, else into `col` (when there is one)."""
    rec = launches.capture_recording(op)
    if rec is None and col is None:
        return
    key = (op, _signature(args, kwargs))
    if rec is None:
        if key not in col.records:
            col.records[key] = _record(op, phase, cost, key[1], args, kwargs)
        col.records[key]["calls"] += 1
        return
    slot = rec.costs.get(key)
    if slot is None:
        slot = rec.costs[key] = [
            _record(op, phase, cost, key[1], args, kwargs), 0]
    slot[1] += 1


def add_replay(costs: dict) -> None:
    """One replay of a capture's costed calls ((op, signature) -> [cost
    record, calls], utils/launches.Recording.costs): added to the
    collector active now; nothing without one."""
    col = _active
    if col is None:
        return
    for key, (template, n) in costs.items():
        rec = col.records.get(key)
        if rec is None:
            rec = col.records[key] = dict(template)
        rec["calls"] += n


def activate() -> Collector:
    """Install a fresh collector (a telemetry run's prologue)."""
    global _active
    _active = Collector()
    return _active


def deactivate(collector: "Collector | None") -> None:
    """Remove `collector` if it is still the active one (the trainers'
    `finally`, so a failed run leaves no capture work to the next)."""
    global _active
    if collector is not None and _active is collector:
        _active = None


def flush_into(run_log, collector: "Collector | None") -> None:
    """One `cost_analysis` event per captured (op, signature)."""
    if run_log is None or collector is None:
        return
    for rec in collector.events():
        run_log.emit("cost_analysis", **rec)


def _sig_of(x):
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("a", tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (bool, int, float, str, type(None))):
        return ("v", x)
    if isinstance(x, tuple):
        return ("t", tuple(_sig_of(v) for v in x))
    return ("o", type(x).__name__)


def _signature(args, kwargs) -> tuple:
    return (tuple(_sig_of(a) for a in args),
            tuple(sorted((k, _sig_of(v)) for k, v in kwargs.items())))


def _fmt(s) -> str:
    if s[0] == "a":
        return f"{list(s[1])}:{s[2]}"
    if s[0] == "t":
        return "(" + ", ".join(_fmt(v) for v in s[1]) + ")"
    return str(s[1])


def _sig_str(sig: tuple) -> str:
    """A signature's readable form: shapes and dtypes, scalars, type
    names."""
    parts = [_fmt(s) for s in sig[0]]
    parts += [f"{k}={_fmt(s)}" for k, s in sig[1]]
    return "(" + ", ".join(parts) + ")"


def costed(op: str, phase: str | None = None, *, cost):
    """Decorator: `@costed("hist", phase="hist", cost=hist_cost)`. `op`
    names the dispatcher in cost_analysis events, `phase` (default `op`)
    the phase_timings name the roofline joins on, `cost(*args,
    **kwargs) -> (operations, bytes)` its analytic cost. Calls run as
    before; with a collector active or in a capture each is recorded
    (module docstring)."""
    phase = phase if phase is not None else op

    def wrap(fn):
        @functools.wraps(fn)
        def costed_fn(*args, **kwargs):
            col = _active
            if col is not None or launches.open_recordings:
                _on_call(col, op, phase, cost, args, kwargs)
            return fn(*args, **kwargs)

        costed_fn.op, costed_fn.phase = op, phase
        return costed_fn

    return wrap


# ------------------------------------------------------------------ #
# the read side: roofline join (pure host math)
# ------------------------------------------------------------------ #

def peaks_for(platform: str | None) -> dict:
    """The ceilings of a cost event's platform: a row of PEAK_CEILINGS by
    key, the H100 SXM row for the card whose name nvidia-smi and torch
    give ("NVIDIA H100 80GB HBM3"), any other card the "gpu" row,
    anything else the "cpu" row."""
    p = platform or ""
    if p in PEAK_CEILINGS:
        return PEAK_CEILINGS[p]
    n = p.upper()
    if "H100" in n and "HBM3" in n:
        return PEAK_CEILINGS["h100_sxm"]
    if n.startswith("NVIDIA") or "GPU" in n:
        return PEAK_CEILINGS["gpu"]
    return PEAK_CEILINGS["cpu"]


def roofline_table(phases: list[dict], cost_events: list[dict],
                   counters: dict | None = None,
                   wallclock_s: float | None = None) -> list[dict]:
    """Join `phase_timings` records against `cost_analysis` events into
    roofline rows: achieved GFLOP/s and GB/s per phase against the
    platform's peak ceilings, with a bound-by verdict (compute / hbm /
    host / recompile, and a comms row on a mesh). A phase without cost
    events still gets a row (verdict "host"). The fused loop's
    `grow_block` row folds in the `fetch_tree` that ends its block."""
    ms_by_phase = {p["phase"]: p for p in phases}
    ev_by_phase: dict[str, list] = {}
    platform = None
    for e in cost_events:
        ev_by_phase.setdefault(e.get("phase", e.get("op")), []).append(e)
        platform = platform or e.get("platform")
    peaks = peaks_for(platform)
    compile_s = float((counters or {}).get("jit_compile_seconds") or 0.0)
    compile_share = (compile_s / wallclock_s
                     if wallclock_s and wallclock_s > 0 else 0.0)

    rows = []
    for p in phases:
        name = p["phase"]
        if name == "fetch_tree" and "grow_block" in ms_by_phase:
            continue                      # folded into the grow_block row
        wall_ms = p["ms_total"]
        if name == "grow_block" and "fetch_tree" in ms_by_phase:
            wall_ms += ms_by_phase["fetch_tree"]["ms_total"]
        evs = ev_by_phase.get(name, [])
        flops = sum(e.get("flops", 0.0) * e.get("calls", 1) for e in evs)
        byts = sum(e.get("bytes_accessed", 0.0) * e.get("calls", 1)
                   for e in evs)
        row = {"phase": name, "ms": round(wall_ms, 1),
               "calls": p.get("calls"), "n_programs": len(evs)}
        if not evs or wall_ms <= 0 or (flops <= 0 and byts <= 0):
            row.update(gflops=None, gbs=None, flops_util=None,
                       hbm_util=None,
                       verdict="recompile"
                       if evs and compile_share > RECOMPILE_WALL_SHARE
                       else "host")
            rows.append(row)
            continue
        wall_s = wall_ms / 1e3
        gflops = flops / wall_s / 1e9
        gbs = byts / wall_s / 1e9
        uc = gflops / peaks["gflops"]
        ub = gbs / peaks["gbs"]
        if max(uc, ub) < HOST_BOUND_UTIL:
            verdict = ("recompile" if compile_share > RECOMPILE_WALL_SHARE
                       else "host")
        elif ub >= uc:
            verdict = "hbm"
        else:
            verdict = "compute"
        row.update(gflops=round(gflops, 2), gbs=round(gbs, 2),
                   flops_util=round(uc, 4), hbm_util=round(ub, 4),
                   verdict=verdict)
        rows.append(row)
    # Comms row: the run's modeled collective payload
    # (counters.collective_bytes_est) over the phase that carries the
    # collective, against the link's ceiling; "comms" when the wire's
    # utilization rivals that phase's memory leg, else "overlapped".
    coll_bytes = float((counters or {}).get("collective_bytes_est") or 0.0)
    if coll_bytes > 0:
        carrier = next((r for r in rows
                        if r["phase"] in ("grow_block", "grow", "hist")
                        and r["ms"] > 0), None)
        if carrier is not None:
            gbs = coll_bytes / (carrier["ms"] / 1e3) / 1e9
            cu = gbs / peaks.get("coll_gbs", peaks["gbs"])
            verdict = ("comms"
                       if cu >= HOST_BOUND_UTIL
                       and cu >= (carrier.get("hbm_util") or 0.0)
                       else "overlapped")
            rows.append({
                "phase": "comms", "ms": carrier["ms"], "calls": None,
                "n_programs": 0, "gflops": None, "gbs": round(gbs, 2),
                "flops_util": None, "hbm_util": None,
                "coll_util": round(cu, 4), "verdict": verdict})
    rows.sort(key=lambda r: -r["ms"])
    return rows
