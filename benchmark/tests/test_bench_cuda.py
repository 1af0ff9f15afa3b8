"""Each cell through benchmark/run.py for a few seconds on the card:

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py

Skips where the machine has fewer cards than a cell asks for."""

import json
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["higgs.train", "higgs.score",
                                  "criteo.train4", "covtype.train"])
def test_cell_runs_on_the_card(name):
    from benchmark.core import harness
    chips = harness.resolve(name).chips
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        pytest.skip(f"{name} needs {chips} CUDA card(s), {have} visible")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2718281828", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
