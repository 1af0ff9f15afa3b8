"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: its entry in BENCHMARK.json,
its configuration file (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the loop of the mix's kind (loops/<kind>.py),
the limits of its check (limits/<cell>.json) and one reader a per-layer
metric (layers/<metric>.py). A later change adds a cell, a configuration,
a mix of an existing kind or a metric by adding files and entries.

A loop module provides:
  setup(ctx) -> state          make the inputs from the seed and warm every
                               shape the window uses (counted in setup_s)
  step(state)                  one job or batch of the window
  end_to_end(state, window_s)  the cell's end-to-end metrics but setup_s
  release(state)               drop the program's state before the check
  check(state) -> dict         name -> number, from the plain reference
  layer_inputs(state) -> dict  what the per-layer readers read
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from benchmark.core import card
from benchmark.core.trace import Tracer

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "ddt_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    loop: object
    limits: dict
    end_to_end: list     # metric entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with "workloads" is the listed cells'; a per-layer one
    without it is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json and every file it names."""
    manifest = load_json(root / "BENCHMARK.json")
    bench = root / "benchmark"
    w = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    loop = load_module(bench / "loops" / f"{traffic['kind']}.py",
                       f"benchmark_loop_{traffic['kind']}")
    limits = load_json(bench / "limits" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layers = [m for m in manifest["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, loop, limits, e2e,
                layers)


def read_layer(metric: str, inputs: dict, root: Path = ROOT):
    mod = load_module(root / "benchmark" / "layers" / f"{metric}.py",
                      "benchmark_layer_" + metric.replace(".", "_"))
    return mod.read(inputs)


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    device: torch.device
    rank: int
    world: int
    tracer: Tracer
    overrides: dict      # TrainConfig fields a control run changes


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather(values: list, ctx: Ctx) -> list:
    """[world, len(values)] float64 of every rank's values."""
    t = torch.tensor(values, dtype=torch.float64, device=ctx.device)
    if ctx.world == 1:
        return [t.tolist()]
    out = [torch.empty_like(t) for _ in range(ctx.world)]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def _go(ctx: Ctx, go: bool) -> bool:
    """Rank 0's decision, on every rank, after a barrier."""
    if ctx.world == 1:
        return go
    flag = torch.tensor([1 if go else 0], dtype=torch.int32,
                        device=ctx.device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, rank: int = 0, world: int = 1, t_start: float,
             overrides: dict | None = None) -> dict | None:
    """One run. Returns rank 0's result (None on the other ranks):
    {correct, attempted, failed, metrics, device[, breakdown], readings,
    checks}."""
    device = torch.device(device)
    ctx = Ctx(cell, seed, device, rank, world,
              Tracer(trace, device), dict(overrides or {}))
    loop = cell.loop
    # From the process's start (imports, the card's context) to here.
    ctx.tracer.spans["setup.start"].append(time.perf_counter() - t_start)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = loop.setup(ctx)
    _sync(device)
    if world > 1:
        dist.barrier()
    setup_s = time.perf_counter() - t_start
    # A traced run reads back every event of its window; a mix whose
    # jobs launch many kernels bounds that window with "trace_steps": it
    # closes after that many whole jobs or batches, if --seconds has not
    # closed it before.
    cap = cell.traffic.get("trace_steps") if trace else None
    ctx.tracer.start()
    attempted = failed = 0
    t0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            loop.step(state)
        except Exception:                     # a job that fails is counted
            failed += 1
            traceback.print_exc()
        _sync(device)
        if world > 1:
            dist.barrier()
        t1 = time.perf_counter()
        if not _go(ctx, t1 - t0 < seconds
                   and (cap is None or attempted < cap)):
            break
    ctx.tracer.stop()
    window_s = t1 - t0
    e2e = loop.end_to_end(state, window_s)
    summ = ctx.tracer.summary
    found = forbidden_modules()
    stats = _gather([card.memory_peak(device),
                     summ.busy_s if summ else 0.0,
                     summ.window_s if summ else 0.0, failed, len(found)],
                    ctx)
    # Every rank refuses, each naming what it found; rank 0 also for the
    # ranks whose modules it cannot see.
    if found:
        raise ForbiddenModules(found)
    others = [f"rank {k}" for k, s in enumerate(stats) if s[4]]
    if others:
        raise ForbiddenModules(others)
    if rank != 0:
        return None
    failed = int(sum(s[3] for s in stats))
    loop.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with ctx.tracer.span("check"):
        numbers = loop.check(state)
    checks, readings, correct = {}, {}, failed == 0 and attempted > 0
    for name, value in numbers.items():
        lim = cell.limits["numbers"].get(name)
        if lim is None:
            readings[name] = value
            continue
        ok = value is not None and math.isfinite(value) \
            and value <= lim["limit"]
        correct = correct and ok
        checks[name] = {"value": value, "limit": lim["limit"]}
    dev_info = card.describe(device, world, int(max(s[0] for s in stats)))
    metrics = {}
    if trace:
        dev_info["busy_s"] = sum(s[1] for s in stats) / world
        dev_info["window_s"] = sum(s[2] for s in stats) / world
        inputs = loop.layer_inputs(state)
        inputs.update(summary=summ, spans=dict(ctx.tracer.spans),
                      window_s=window_s, end_to_end=e2e,
                      peaks=card.load_peaks(BENCH, dev_info["kind"]))
        for m in cell.per_layer:
            v = read_layer(m["name"], inputs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and summ is not None:
        out["breakdown"] = {"device_ops": summ.device_ops,
                            "idle_gaps": summ.idle_gaps}
    out["card"] = card.power_limit() if device.type == "cuda" else "cpu"
    out["spans"] = {k: [len(v), sum(v)] for k, v in ctx.tracer.spans.items()}
    out["readings"] = readings
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    pass
