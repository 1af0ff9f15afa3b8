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


def run_tiny(name, overrides=None, trace=False, seed=7, plant=None):
    import contextlib

    from benchmark.core import harness
    cell = tiny(harness.resolve(name))
    with plant(cell) if plant else contextlib.nullcontext():
        return harness.run_cell(cell, seed=seed, seconds=0.0, trace=trace,
                                device="cpu", t_start=time.perf_counter(),
                                overrides=overrides)


@pytest.fixture
def manifest():
    import json
    return json.loads((ROOT / "BENCHMARK.json").read_text())
