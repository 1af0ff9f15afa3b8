"""The port's cost observatory, profiler windows and run-log readers
against ddt_tpu's on the CPU (mirrors tests/test_observatory.py case by
case where the case has a counterpart).

The port has no compiler cost model: its costed dispatchers carry an
analytic cost (telemetry/costmodel), counted per call signature and, on
the card, per graph replay (tests/test_torch_cuda.py). Everything a log
reader computes (roofline rows, summaries, rendered text, diffs, merged
timelines, Perfetto JSON) is held to the reference's output on the same
input exactly.
"""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from ddt_tpu.telemetry import costmodel as jcost
from ddt_tpu.telemetry import diffing as jdiff
from ddt_tpu.telemetry import merge as jmerge
from ddt_tpu.telemetry import perfetto as jperfetto
from ddt_tpu.telemetry import report as jreport
from ddt_tpu_torch import api
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.ops import histogram, split
from ddt_tpu_torch.telemetry import costmodel, diffing, perfetto, report
from ddt_tpu_torch.telemetry import merge as tele_merge
from ddt_tpu_torch.telemetry.events import RunLog
from ddt_tpu_torch.telemetry.profiler import CaptureWindow, parse_rounds
from ddt_tpu_torch.utils import launches


def _binary(rows, features=7, bins=23, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] > bins // 2).astype(np.float32)
    return Xb, y


def _streaming_cli_log(tmp_path, capsys) -> str:
    log = str(tmp_path / "stream.jsonl")
    rc = main(["train", "--device=cpu", "--dataset=higgs", "--rows=900",
               "--trees=2", "--depth=3", "--bins=23", "--stream-chunks=2",
               "--valid-frac=0.25", f"--run-log={log}",
               f"--out={tmp_path / 'ens.npz'}"])
    assert rc == 0
    capsys.readouterr()
    return log


def test_cost_events_and_roofline_on_real_run(tmp_path, capsys):
    """A streamed CLI run's log carries cost events of the hist and gain
    dispatchers; report's roofline (the port's and the reference's,
    identical) gives hist, gain and predict a verdict."""
    log = _streaming_cli_log(tmp_path, capsys)
    events = report.read_events(log)
    cost = [e for e in events if e["event"] == "cost_analysis"]
    by_op = {e["op"] for e in cost}
    assert {"hist", "gain"} <= by_op
    for e in cost:
        assert e["calls"] >= 1 and e["platform"] == "cpu"
        assert e["flops"] > 0 and e["bytes_accessed"] > 0
        assert e["signature"].startswith("(")
    summary = report.summarize(events)
    assert summary == jreport.summarize(jreport.read_events(log))
    rows = {r["phase"]: r for r in summary["roofline"]}
    for phase in ("hist", "gain", "predict"):
        assert rows[phase]["verdict"] in {"compute", "hbm", "recompile",
                                          "host"}
    assert rows["hist"]["gflops"] is not None
    assert rows["gain"]["gflops"] is not None
    assert rows["predict"]["gflops"] is None      # no costed op there
    assert main(["report", "--log", log]) == 0
    text = capsys.readouterr().out
    assert text.rstrip("\n") == jreport.render(summary)
    assert "roofline (XLA cost model" in text and "compiling)" in text


def test_costed_wrapper_counts_calls_and_signatures():
    """One record per (op, signature), a call count per signature, and
    the wrapped function's results untouched."""
    X = torch.randint(0, 8, (100, 3), dtype=torch.uint8)
    g, h = torch.randn(100), torch.rand(100)
    ni = torch.zeros(100, dtype=torch.int32)
    want = histogram.build_histograms(X, g, h, ni, 1, 8)
    col = costmodel.activate()
    try:
        got = histogram.build_histograms(X, g, h, ni, 1, 8)
        histogram.build_histograms(X, g, h, ni, 1, 8)
        histogram.build_histograms(X[:50], g[:50], h[:50], ni[:50], 1, 8)
        evs = sorted(col.events(), key=lambda e: -e["calls"])
    finally:
        costmodel.deactivate(col)
    assert torch.equal(got, want)
    assert [(e["op"], e["phase"], e["calls"]) for e in evs] == \
        [("hist", "hist", 2), ("hist", "hist", 1)]
    assert evs[0]["signature"] == \
        "([100, 3]:uint8, [100]:float32, [100]:float32, [100]:int32, 1, 8)"
    assert histogram.build_histograms.op == "hist"
    assert histogram.build_histograms.__name__ == "build_histograms"


@pytest.mark.parametrize("R,F,N,B,exact", [(1_000_000, 28, 16, 255, True),
                                           (1000, 7, 4, 63, False)])
def test_hist_cost_is_the_bound_formula(R, F, N, B, exact):
    """The analytic cost counts what chip_smoke's bound counts with every
    row active: node index, Xb and g/h of every row, the table once (16 B
    cells in the exact mode), two adds per (row, feature)."""
    X = torch.zeros((R, F), dtype=torch.uint8)
    g = torch.zeros(R)
    ni = torch.zeros(R, dtype=torch.int32)
    ops, nbytes = histogram.hist_cost(
        X, g, g, ni, N, B, scales=torch.ones(2) if exact else None)
    assert ops == 2 * R * F
    assert nbytes == R * 4 + R * (F + 8) + N * F * B * (16 if exact else 8)


def test_gain_cost_counts_cells():
    hist = torch.zeros((4, 5, 16, 2))
    assert split.gain_cost(hist, 1.0, 1e-3) == (10 * 320, 4 * 5 * 16 * 2 * 4
                                               + 4 * 13)
    assert split.gain_cost(hist, 1.0, 1e-3, missing_bin=True)[0] == 6400


def test_disabled_path_never_captures(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("cost work while telemetry disabled")

    monkeypatch.setattr(costmodel, "_signature", boom)
    monkeypatch.setattr(histogram, "hist_cost", boom)
    assert costmodel._active is None
    X = torch.zeros((10, 2), dtype=torch.uint8)
    out = histogram.build_histograms(X, torch.ones(10), torch.ones(10),
                                     torch.zeros(10, dtype=torch.int32), 1, 4)
    assert float(out[0, 0, 0, 0]) == 10.0


@pytest.fixture
def fake_capture(monkeypatch):
    """A CUDA-graph capture on the CPU: a launch Recording open with the
    stream reported as capturing, so costed calls go into the recording
    (the card's captures: tests/test_torch_cuda.py)."""
    @contextlib.contextmanager
    def capture():
        with launches.recording() as rec:
            monkeypatch.setattr(launches, "capturing", lambda: True)
            try:
                yield rec
            finally:
                monkeypatch.setattr(launches, "capturing", lambda: False)
    return capture


def _hist_args(rows=64):
    X = torch.randint(0, 8, (rows, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    return (X, torch.ones(rows), torch.ones(rows),
            torch.zeros(rows, dtype=torch.int32), 1, 8)


@pytest.mark.parametrize("collector_at_capture", [False, True])
def test_replays_count_into_the_collector_active_at_replay(
        fake_capture, collector_at_capture):
    """A capture keeps its costed calls whether or not a collector is
    active then; each replay adds them to the collector active at replay
    time (a run that replays a round captured by an earlier run without
    a run log still counts its calls), and a replay with none adds
    nothing anywhere. The capture itself counts no call."""
    args = _hist_args()
    early = costmodel.activate() if collector_at_capture else None
    try:
        with fake_capture() as rec:
            histogram.build_histograms(*args)
            histogram.build_histograms(*args)
        assert launches.open_recordings == 0
        rec.replayed()
    finally:
        costmodel.deactivate(early)
    col = costmodel.activate()
    try:
        for _ in range(3):
            rec.replayed()
        evs = col.events()
    finally:
        costmodel.deactivate(col)
    rec.replayed()                       # no collector: nothing counted
    eager = costmodel.activate()
    try:
        histogram.build_histograms(*args)
        (want,) = eager.events()
    finally:
        costmodel.deactivate(eager)
    assert evs == [dict(want, calls=6)]
    if early is not None:
        assert early.events() == [dict(want, calls=2)]


def test_costed_call_in_a_capture_without_a_recording_raises(monkeypatch):
    """A costed call in a capture that no launch Recording watches would
    go uncounted in every replay: it raises, as a launch does."""
    monkeypatch.setattr(launches, "capturing", lambda: True)
    monkeypatch.setattr(launches, "open_recordings", 1)
    with pytest.raises(RuntimeError, match="no launch recording open"):
        histogram.build_histograms(*_hist_args())


def test_deactivate_only_removes_its_own_collector():
    c1 = costmodel.activate()
    c2 = costmodel.activate()
    costmodel.deactivate(c1)
    assert costmodel._active is c2
    costmodel.deactivate(c2)
    assert costmodel._active is None


def _phase(name, ms, calls=1):
    return {"phase": name, "ms_total": ms, "ms_per_call": ms / calls,
            "calls": calls, "share": 1.0}


def _cost(phase, flops, byts, calls=1, platform="cpu"):
    return {"op": phase, "phase": phase, "flops": flops,
            "bytes_accessed": byts, "calls": calls, "platform": platform}


def test_roofline_verdicts():
    peaks = costmodel.PEAK_CEILINGS["cpu"]
    compute = _cost("a", 0.5 * peaks["gflops"] * 1e9 * 0.1, 1e3)
    hbm = _cost("b", 1e3, 0.5 * peaks["gbs"] * 1e9 * 0.1)
    idle = _cost("c", 1e3, 1e3)
    args = ([_phase("a", 100.0), _phase("b", 100.0), _phase("c", 100.0)],
            [compute, hbm, idle])
    kw = dict(counters={"jit_compile_seconds": 0.0}, wallclock_s=10.0)
    rows = costmodel.roofline_table(*args, **kw)
    assert rows == jcost.roofline_table(*args, **kw)
    verdict = {r["phase"]: r["verdict"] for r in rows}
    assert verdict == {"a": "compute", "b": "hbm", "c": "host"}


def test_roofline_recompile_verdict_and_growblock_fold():
    args = ([_phase("grow_block", 400.0), _phase("fetch_tree", 600.0)],
            [_cost("grow_block", 1e3, 1e3)])
    kw = dict(counters={"jit_compile_seconds": 3.0}, wallclock_s=10.0)
    rows = costmodel.roofline_table(*args, **kw)
    assert rows == jcost.roofline_table(*args, **kw)
    assert len(rows) == 1 and rows[0]["ms"] == pytest.approx(1000.0)
    assert rows[0]["verdict"] == "recompile"


def test_roofline_phase_without_cost_is_host():
    args = ([_phase("gain", 50.0), _phase("hist", 100.0)],
            [_cost("hist", 1e9, 1e9)])
    rows = costmodel.roofline_table(*args)
    assert rows == jcost.roofline_table(*args)
    assert {r["phase"]: r["verdict"] for r in rows}["gain"] == "host"


@pytest.mark.parametrize("name,gbs", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 900.0),
    ("NVIDIA H200", 900.0), ("NVIDIA A100-SXM4-80GB", 900.0),
    ("cpu", 30.0), ("tpu", 819.0), (None, 30.0)])
def test_peaks_for_reads_the_card_name(name, gbs):
    """The H100 SXM card has its data sheet's row; any other card the
    generic "gpu" row."""
    assert costmodel.peaks_for(name)["gbs"] == gbs


def test_h100_hist_row_stays_under_the_peak():
    """At the card's ceilings a hist phase of 606 calls of config 1's
    signature at 1.2 ms a tree reads ~5% of the memory peak."""
    ops, nbytes = histogram.hist_cost(
        torch.zeros((1_000_000, 28), dtype=torch.uint8),
        torch.zeros(1_000_000), torch.zeros(1_000_000),
        torch.zeros(1_000_000, dtype=torch.int32), 16, 255,
        scales=torch.ones(2))
    rows = costmodel.roofline_table(
        [_phase("hist", 120.0, calls=600)],
        [_cost("hist", ops, nbytes, calls=600,
               platform="NVIDIA H100 80GB HBM3")])
    assert rows[0]["verdict"] == "hbm"
    assert 0.02 < rows[0]["hbm_util"] < 0.2


def _v1_log(tmp_path, name="v1.jsonl"):
    recs = [
        {"event": "run_manifest", "schema": 1, "t": 100.0, "seq": 0,
         "trainer": "driver", "backend": "tpu", "loss": "logloss",
         "n_trees": 2, "max_depth": 3, "rows": 100, "features": 4},
        {"event": "round", "schema": 1, "t": 101.0, "seq": 1,
         "round": 1, "ms_per_round": 9.0, "train_loss": 0.6},
        {"event": "round", "schema": 1, "t": 102.0, "seq": 2,
         "round": 2, "ms_per_round": 8.0, "train_loss": 0.5},
        {"event": "phase_timings", "schema": 1, "t": 102.5, "seq": 3,
         "phases": [{"phase": "grow", "ms_total": 17.0,
                     "ms_per_call": 8.5, "calls": 2, "share": 1.0}]},
        {"event": "counters", "schema": 1, "t": 102.6, "seq": 4,
         "jit_compiles": 2, "h2d_bytes": 400, "d2h_bytes": 60,
         "collective_bytes_est": 0},
        {"event": "run_end", "schema": 1, "t": 102.7, "seq": 5,
         "completed_rounds": 2, "wallclock_s": 2.7},
    ]
    p = tmp_path / name
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(p)


def _v2_log(tmp_path, host, name=None):
    recs = [
        {"event": "run_manifest", "schema": 2, "t": 100.0 + host,
         "seq": 0, "trainer": "driver", "backend": "tpu",
         "loss": "logloss", "n_trees": 1, "max_depth": 3, "rows": 100,
         "features": 4, "run_id": "cafe01234567", "host": host},
        {"event": "partition_phases", "schema": 2, "t": 101.0 + host,
         "seq": 1, "round": 1, "rounds": 1, "partitions": [
             {"device": 0, "phases": {"grow": 5.0},
              "hist_allreduce_bytes": 64},
             {"device": 1, "phases": {"grow": 7.0},
              "hist_allreduce_bytes": 64}]},
        {"event": "partition_skew", "schema": 2, "t": 101.5 + host,
         "seq": 2, "phases": [
             {"phase": "grow", "ms_max": 7.0, "ms_median": 6.0,
              "skew": 1.167, "max_device": 1}], "n_partitions": 2},
        {"event": "run_end", "schema": 2, "t": 102.0 + host, "seq": 3,
         "completed_rounds": 1, "wallclock_s": 2.0},
    ]
    p = tmp_path / (name or f"v2_h{host}.jsonl")
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(p)


def test_v1_log_still_reads_summarizes_and_traces(tmp_path):
    p = _v1_log(tmp_path)
    events = report.read_events(p)
    summary = report.summarize(events)
    assert summary == jreport.summarize(jreport.read_events(p))
    assert summary["roofline"] is None
    assert report.render(summary) == jreport.render(summary)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    n = perfetto.write_trace(events, str(a))
    assert n == jperfetto.write_trace(events, str(b)) > 0
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_v2_logs_still_merge_and_report(tmp_path):
    p0, p1 = _v2_log(tmp_path, 0), _v2_log(tmp_path, 1)
    merged = tele_merge.merge_paths([p0, p1])
    assert merged == jmerge.merge_paths([p0, p1])
    summary = report.summarize(merged)
    assert summary["hosts"] == [0, 1] and summary["partition_skew"]
    assert report.render(summary) == jreport.render(
        jreport.summarize(merged))


def test_v3_diff_reads_v1_logs_too(tmp_path):
    a = report.summarize(report.read_events(_v1_log(tmp_path, "a.jsonl")))
    b = report.summarize(report.read_events(_v1_log(tmp_path, "b.jsonl")))
    d = diffing.diff_summaries(a, b)
    assert d == jdiff.diff_summaries(a, b)
    assert d["flagged"] == [] and d["cost"] == []


def _perturb_log(src_path, dst_path, gain_factor, h2d_factor):
    with open(src_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        rec = json.loads(line)
        if rec["event"] == "phase_timings":
            rec = copy.deepcopy(rec)
            for p in rec["phases"]:
                if p["phase"] == "gain":
                    p["ms_total"] = round(p["ms_total"] * gain_factor, 3)
                    p["ms_per_call"] = round(
                        p["ms_per_call"] * gain_factor, 4)
        if rec["event"] == "counters":
            rec = dict(rec, h2d_bytes=int(max(1, rec["h2d_bytes"])
                                          * h2d_factor))
        out.append(json.dumps(rec))
    with open(dst_path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")


def test_report_diff_flags_synthetic_gain_regression(tmp_path, capsys):
    log_a = _streaming_cli_log(tmp_path, capsys)
    log_b = str(tmp_path / "regressed.jsonl")
    _perturb_log(log_a, log_b, gain_factor=1.30001, h2d_factor=4.0)
    rc = main(["report", "diff", log_a, log_b, "--json",
               "--abs-floor-ms=0"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d == jdiff.diff_summaries(
        jreport.summarize(jreport.read_events(log_a)),
        jreport.summarize(jreport.read_events(log_b)), abs_floor_ms=0)
    assert any(f.startswith("gain +") for f in d["flagged"]), d["flagged"]
    assert any(f.startswith("h2d_bytes ") for f in d["flagged"])
    hist = next(p for p in d["phases"] if p["phase"] == "hist")
    assert hist["flag"] is None
    assert main(["report", "diff", log_a, log_a, "--check"]) == 0
    assert "no adverse excursions" in capsys.readouterr().out
    assert main(["report", "diff", log_a, log_b, "--check",
                 "--abs-floor-ms=0"]) == 1


def test_report_diff_of_a_reference_log_against_a_port_log(tmp_path,
                                                           capsys):
    """`report diff` reads a log of either package against the other's,
    in both packages' CLIs."""
    from ddt_tpu import api as japi
    from ddt_tpu.cli import main as jmain
    from ddt_tpu.config import TrainConfig as JConfig

    Xb, y = _binary(1200)
    a, b = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    japi.train(Xb, y, JConfig(backend="tpu", n_trees=3, max_depth=3,
                              n_bins=23), binned=True, run_log=a)
    api.train(Xb, y, TrainConfig(device="cpu", n_trees=3, max_depth=3,
                                 n_bins=23), binned=True, run_log=b)
    assert main(["report", "diff", a, b]) == 0
    port_text = capsys.readouterr().out
    assert jmain(["report", "diff", a, b]) == 0
    assert capsys.readouterr().out == port_text
    assert jmain(["report", "--log", b]) == 0
    ref_text = capsys.readouterr().out
    assert main(["report", "--log", b]) == 0
    assert capsys.readouterr().out == ref_text


def test_diff_directionality_and_structure():
    a = {"phases": [_phase("hist", 1000.0), _phase("old", 100.0)],
         "counters": {"jit_compiles": 10,
                      "compiled_ensemble_cache_hits": 50},
         "cost_events": [_cost("hist", 1e9, 2e9)],
         "completed_rounds": 2, "wallclock_s": 2.0}
    b = {"phases": [_phase("hist", 500.0), _phase("new", 100.0)],
         "counters": {"jit_compiles": 11,
                      "compiled_ensemble_cache_hits": 0},
         "cost_events": [_cost("hist", 1e9, 2e9)],
         "completed_rounds": 2, "wallclock_s": 1.5}
    d = diffing.diff_summaries(a, b)
    assert d == jdiff.diff_summaries(a, b)
    by = {p["phase"]: p for p in d["phases"]}
    assert by["hist"]["flag"] is None
    assert (by["old"]["flag"], by["new"]["flag"]) == ("gone", "new")
    assert any("compiled_ensemble_cache_hits" in f for f in d["flagged"])


def test_diff_unknown_and_neutral_counter_directions():
    a = {"phases": [], "counters": {"mystery_counter": 10,
                                    "serve_requests": 10},
         "cost_events": [], "completed_rounds": 1, "wallclock_s": 1.0}
    b = {"phases": [], "counters": {"mystery_counter": 100,
                                    "serve_requests": 100},
         "cost_events": [], "completed_rounds": 1, "wallclock_s": 1.0}
    d = diffing.diff_summaries(a, b)
    by = {c["counter"]: c for c in d["counters"]}
    assert by["mystery_counter"]["direction"] == "?"
    assert by["serve_requests"]["direction"] == "neutral"
    assert d["flagged"] == []
    assert diffing.render_diff(d) == jdiff.render_diff(d)


def test_parse_rounds():
    assert parse_rounds("5:8") == (5, 8)
    assert parse_rounds("4") == (4, 4)
    with pytest.raises(ValueError, match="LO:HI"):
        parse_rounds("a:b")
    with pytest.raises(ValueError, match="empty or starts"):
        parse_rounds("8:5")
    with pytest.raises(ValueError, match="empty or starts"):
        parse_rounds("0:3")


def test_block_cap_aligns_blocks_to_window_edges(tmp_path):
    w = CaptureWindow(str(tmp_path), "5:8")
    assert w.block_cap(0, 10) == 4
    assert w.block_cap(4, 10) == 4
    assert w.block_cap(4, 4) == 4
    assert w.block_cap(8, 10) == 10
    assert w.block_cap(0, 3) == 3


def test_capture_window_manifest_fields_and_close(tmp_path):
    w = CaptureWindow(str(tmp_path / "xp"), "1:2")
    w.bind("deadbeef0123")
    m = w.manifest_fields()
    assert m["xprof_rounds"] == [1, 2]
    assert os.path.basename(m["xprof_dir"]) == "run_deadbeef0123"
    w.close()
    assert not w.active
    w.round_start(0)
    assert not w.active


@pytest.mark.parametrize("loop", ["fused", "granular"])
def test_capture_window_traces_its_rounds(tmp_path, loop):
    """A capture window over rounds 2-3 writes a torch.profiler Chrome
    trace named by the run id, with the ddt: ranges; the manifest
    cross-references it; the trees are those of a run without it."""
    Xb, y = _binary(2000, seed=4)
    cfg = TrainConfig(device="cpu", n_trees=5, max_depth=3, n_bins=23)
    rl = RunLog()
    w = CaptureWindow(str(tmp_path / "xp"), "2:3")
    res = api.train(Xb, y, cfg, binned=True, run_log=rl,
                    profiler_window=w, profile=loop == "granular")
    plain = api.train(Xb, y, cfg, binned=True)
    np.testing.assert_array_equal(res.ensemble.leaf_value,
                                  plain.ensemble.leaf_value)
    man = rl.events("run_manifest")[0]
    assert man["xprof_rounds"] == [2, 3]
    assert man["xprof_dir"] == str(tmp_path / "xp" / f"run_{res.run_id}")
    with open(os.path.join(man["xprof_dir"], "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("ddt:") for n in names)
    assert not w.active


def test_trace_dir_captures_the_whole_fit(tmp_path, capsys):
    d = tmp_path / "tr"
    assert main(["train", "--device=cpu", "--rows=600", "--trees=2",
                 "--depth=2", "--bins=15", f"--trace-dir={d}",
                 f"--out={tmp_path / 'm.npz'}"]) == 0
    with open(d / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ddt:hist" in names and "ddt:gain" in names
