"""Shared helpers of the benchmark's CPU tests: cells cut to a size the
CPU trains in seconds."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(cell):
    """The cell at a CPU test's size: few rows, training trees and batch
    rows (the scored ensemble keeps its 1000 trees)."""
    c = cell.config
    c["rows"] = 6000
    if "eval_rows" in c:
        c["eval_rows"] = 2000
    c["train"]["n_trees"] = 5
    if "batch_rows" in cell.traffic:
        cell.traffic["batch_rows"] = 8000
    return cell


#: A cell whose files stay under benchmark/ while BENCHMARK.json leaves it
#: out (its traced run outlasts a run's time limit; PERF.md, Open
#: questions). The CPU tests still run it: the eval rows and early
#: stopping of the train_jobs loop are its alone.
UNLISTED = {
    "config": {"name": "covtype",
               "source": "https://archive.ics.uci.edu/dataset/31/covertype",
               "file": "benchmark/configs/covtype.json", "reduced": [],
               "why": "7-class softmax at depth 8, eval rows, early stopping"},
    "workload": {"name": "covtype.train", "config": "covtype",
                 "traffic": "train_jobs_es", "chips": 1,
                 "why": "K1 at depth 8 and 7 classes, the eval step"},
    "like": "higgs.train",
}


def resolve(name):
    """The cell `name` of BENCHMARK.json, or the unlisted one, resolved
    from a manifest that lists it beside a cell of its kind."""
    import json
    import tempfile

    from benchmark.core import harness
    if name != UNLISTED["workload"]["name"]:
        return harness.resolve(name)
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append(UNLISTED["config"])
    m["workloads"].append(UNLISTED["workload"])
    for e in m["end_to_end"] + m["per_layer"]:
        if UNLISTED["like"] in e.get("workloads", ()):
            e["workloads"].append(name)
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "BENCHMARK.json").write_text(json.dumps(m))
        (Path(d) / "benchmark").symlink_to(ROOT / "benchmark")
        return harness.resolve(name, root=Path(d))


def run_tiny(name, overrides=None, trace=False, seed=7, plant=None):
    import contextlib

    from benchmark.core import harness
    cell = tiny(resolve(name))
    with plant(cell) if plant else contextlib.nullcontext():
        return harness.run_cell(cell, seed=seed, seconds=0.0, trace=trace,
                                device="cpu", t_start=time.perf_counter(),
                                overrides=overrides)


@pytest.fixture
def manifest():
    import json
    return json.loads((ROOT / "BENCHMARK.json").read_text())
