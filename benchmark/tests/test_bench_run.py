"""Runs of the harness on the CPU with the card's look skipped: the
result's keys, the check's verdict on sound runs, on the program's own
lower-precision path (the control) and on planted faults, and the entry
point's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults
from benchmark.core import harness

from .conftest import ROOT, run_tiny, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["higgs.train", "higgs.score",
                                  "covtype.train"])
def test_sound_run_is_correct_and_its_last_key_is_the_checks(name):
    res = run_tiny(name)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_reports_per_layer_metrics_and_a_breakdown():
    res = run_tiny("higgs.train", trace=True)
    assert {"train.edges_ms", "train.loop_ms_per_round"} <= set(
        res["metrics"])
    assert "setup_s" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"] is True


@pytest.mark.parametrize("name", ["higgs.train", "higgs.score",
                                  "covtype.train"])
def test_control_is_not_correct(name):
    control = harness.resolve(name).traffic["control"]
    assert run_tiny(name, overrides=control)["correct"] is False


@pytest.mark.parametrize("name,fault", [
    ("higgs.train", "state_unchanged"), ("higgs.train", "half_rows"),
    ("higgs.train", "answer_altered"), ("covtype.train", "state_unchanged"),
    ("higgs.score", "half_rows"), ("higgs.score", "answer_altered")])
def test_planted_fault_is_not_correct(name, fault):
    res = run_tiny(name, plant=lambda cell: faults.plant(
        fault, cell.traffic["kind"]))
    assert res["correct"] is False


def _ranks(rank, world, port, fault, q):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    import contextlib
    import types

    from benchmark.core import harness
    from ddt_tpu_torch.parallel import mesh
    mesh.initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                              backend="gloo")
    cell = tiny(harness.resolve("criteo.train4"))
    if fault == "jax_on_rank_1":
        plant = contextlib.nullcontext()
        if rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
    else:
        plant = faults.plant(fault, "train_jobs") if fault \
            else contextlib.nullcontext()
    try:
        with plant:
            res = harness.run_cell(cell, seed=99, seconds=0.0, trace=False,
                                   device="cpu", rank=rank, world=world,
                                   t_start=time.perf_counter())
    except harness.ForbiddenModules as e:
        q.put((rank, e.args[0]))
        return
    torch.distributed.destroy_process_group()
    if res is not None:
        q.put(res["correct"])


def _on_two_gloo_ranks(fault, answers):
    import torch.multiprocessing as mp

    from benchmark.core.launch import free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_ranks, args=(r, 2, port, fault, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=300) for _ in range(answers)]
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return got


@pytest.mark.parametrize("fault,want", [("", True), ("no_exchange", False)])
def test_partitioned_cell_on_two_gloo_ranks(fault, want):
    assert _on_two_gloo_ranks(fault, 1) == [want]


def test_a_module_of_jax_on_another_rank_refuses_the_run():
    """Rank 1 alone loads `jax`: it refuses naming the module, and rank 0,
    which prints the result, refuses naming rank 1."""
    got = sorted(_on_two_gloo_ranks("jax_on_rank_1", 2))
    assert got == [(0, ["rank 1"]), (1, ["jax"])]


def test_run_without_a_card_exits_1_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "higgs.train",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "higgs.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_seed_beyond_32_bits_gives_the_same_rows():
    from benchmark.core import data
    cfg = json.loads((ROOT / "benchmark/configs/higgs.json").read_text())
    a = data.make_rows(cfg, 100, 2**31 + 12345, 0, "cpu")
    b = data.make_rows(cfg, 100, 2**31 + 12345, 0, "cpu")
    c = data.make_rows(cfg, 100, 2**31 + 12346, 0, "cpu")
    assert np_equal(a, b) and not np_equal(a, c)


def np_equal(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_covtype_rows_keep_the_sources_shape():
    """10 whole-numbered columns within their ranges, one wilderness area
    and one soil type a row, the classes in the source's proportions, and
    for every seed the same rows in the seed's order."""
    import numpy as np

    from benchmark.core import data
    cfg = json.loads((ROOT / "benchmark/configs/covtype.json").read_text())
    sh = cfg["shape"]
    lo = np.array([q[1] for q in sh["quantitative"]])
    hi = np.array([q[2] for q in sh["quantitative"]])
    counts = np.array(sh["class_counts"])
    for seed in (3, 2**31 + 7):
        X, y = data.make_rows(cfg, 5000, seed, 0, "cpu")
        assert X.shape == (5000, cfg["features"])
        q = X[:, :10]
        assert np.array_equal(q, np.round(q))
        assert (q >= lo).all() and (q <= hi).all()
        for cols in (X[:, 10:14], X[:, 14:]):
            assert set(np.unique(cols)) <= {0.0, 1.0}
            assert (cols.sum(1) == 1).all()
        assert np.abs(np.bincount(y, minlength=7)
                      - counts * 5000 / counts.sum()).max() < 1
    # Another seed: the same rows in another order.
    a, b = data.make_rows(cfg, 500, 3, 0, "cpu"), \
        data.make_rows(cfg, 500, 4, 0, "cpu")
    assert not np_equal(a, b)
    key = [np.lexsort(np.c_[x, y].T) for x, y in (a, b)]
    assert np_equal((a[0][key[0]], a[1][key[0]]), (b[0][key[1]], b[1][key[1]]))


def test_an_early_stopped_job_still_has_its_loss_compared(monkeypatch):
    """The model an early stop keeps ends before the history does; the
    check compares the last training loss reported within it."""
    cell = tiny(harness.resolve("covtype.train"))
    cell.config["train"].update(n_trees=80, learning_rate=0.5)
    cell.config["early_stopping_rounds"] = 3
    jobs = []
    check = cell.loop.check

    def keep(st):
        jobs.extend(st.jobs)
        return check(st)

    monkeypatch.setattr(cell.loop, "check", keep)
    res = harness.run_cell(cell, seed=7, seconds=0.0, trace=False,
                           device="cpu", t_start=time.perf_counter())
    job = jobs[0]
    assert job.ensemble.n_trees // 7 < job.history[-1]["round"] < 80
    assert res["correct"] is True
    assert res["checks"]["loss_gap"]["value"] < 1e-6
