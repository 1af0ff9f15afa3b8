"""The readers of the program's spans (layers/train.prologue_ms_per_job,
train.capture_ms_per_job, score.host_ms_per_batch): their arithmetic on
planted totals, None where the program keeps no spans, and tiny traced
CPU runs of the cells that report them (criteo.train4 on two gloo
ranks)."""

import os
import time

import pytest
import torch

from benchmark.core.harness import read_layer
from ddt_tpu_torch.telemetry import annotations

from .conftest import run_tiny

SPAN_METRICS = {"higgs.train": ("train.prologue_ms_per_job",
                                "train.capture_ms_per_job"),
                "covtype.train": ("train.prologue_ms_per_job",
                                  "train.capture_ms_per_job"),
                "higgs.score": ("score.host_ms_per_batch",)}


def _plant(monkeypatch, **spans):
    totals = {"ddt:" + n.replace("_", "."): {"count": c, "total_s": s,
                                              "self_s": s}
              for n, (c, s) in spans.items()}
    monkeypatch.setattr(annotations, "span_totals", lambda: totals)


def test_readers_divide_by_the_programs_root_count(monkeypatch):
    _plant(monkeypatch, train=(4, 10.0), train_rows=(4, 0.6),
           train_setup=(4, 0.2), capture=(1, 0.04), score=(5, 2.0),
           score_prepare=(10, 0.05), score_proba=(5, 0.3))
    assert read_layer("train.prologue_ms_per_job", {}) == \
        pytest.approx(200.0)
    assert read_layer("train.capture_ms_per_job", {}) == pytest.approx(10.0)
    assert read_layer("score.host_ms_per_batch", {}) == pytest.approx(70.0)


def test_capture_reads_zero_when_jobs_replayed_a_kept_graph(monkeypatch):
    _plant(monkeypatch, train=(3, 1.0), train_rows=(3, 0.1),
           train_setup=(3, 0.1))
    assert read_layer("train.capture_ms_per_job", {}) == 0.0


def test_readers_return_nothing_without_roots_or_span_api(monkeypatch):
    _plant(monkeypatch, capture=(1, 0.04), score_proba=(1, 0.3))
    for m in ("train.prologue_ms_per_job", "train.capture_ms_per_job",
              "score.host_ms_per_batch"):
        assert read_layer(m, {}) is None, m
    # A program without the span store leaves the metrics out of the line.
    monkeypatch.delattr(annotations, "span_totals")
    for m in ("train.prologue_ms_per_job", "train.capture_ms_per_job",
              "score.host_ms_per_batch"):
        assert read_layer(m, {}) is None, m


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_traced_run_reports_the_span_metrics(name):
    annotations.reset_spans()
    res = run_tiny(name, trace=True)
    assert res["correct"] is True
    for m in SPAN_METRICS[name]:
        assert m in res["metrics"], m
        assert res["metrics"][m]["unit"] == "ms"
        assert res["metrics"][m]["value"] >= 0.0
    # Every span opened inside the window; none at set-up or in the check.
    roots = "ddt:score" if name == "higgs.score" else "ddt:train"
    assert annotations.span_totals()[roots]["count"] == res["attempted"]


def test_an_untraced_run_keeps_no_spans():
    annotations.reset_spans()
    res = run_tiny("higgs.score")
    assert res["correct"] is True
    assert annotations.span_totals() == {}


def _traced_rank(rank, world, port, q):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    from benchmark.core import harness
    from ddt_tpu_torch.parallel import mesh

    from .conftest import tiny
    mesh.initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                              backend="gloo")
    res = harness.run_cell(tiny(harness.resolve("criteo.train4")), seed=5,
                           seconds=0.0, trace=True, device="cpu", rank=rank,
                           world=world, t_start=time.perf_counter())
    torch.distributed.destroy_process_group()
    agree = annotations.span_totals().get("ddt:agree", {}).get("count", 0)
    q.put((rank, None if res is None else res["metrics"], agree))


def test_partitioned_traced_run_reports_the_span_metrics():
    """Each rank waits in `ddt:agree` once a job; rank 0 reports."""
    import torch.multiprocessing as mp

    from benchmark.core.launch import free_port
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_traced_rank, args=(r, 2, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    (_, metrics, agree0), (_, other, agree1) = got
    assert other is None and agree0 == agree1 >= 1
    for m in SPAN_METRICS["higgs.train"]:
        assert m in metrics, m
