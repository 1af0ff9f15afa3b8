"""The port's run-log readers against ddt_tpu's on the CPU: the
cross-host merge, the report over merged logs, the Perfetto export and
the host-RSS counter (mirrors tests/test_flight_recorder.py's merge,
trace and host-RSS cases; its partition-recorder and benchwatch cases
wait for the straggler slice), and the run log a mesh writes.

Merged timelines, summaries, rendered text and trace JSON are compared
with the reference's on the same logs exactly.
"""

import copy
import json

import numpy as np
import pytest

from ddt_tpu.cli import main as jmain
from ddt_tpu.telemetry import merge as jmerge
from ddt_tpu.telemetry import perfetto as jperfetto
from ddt_tpu.telemetry import report as jreport
from ddt_tpu_torch import api
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.telemetry import merge, perfetto, report
from ddt_tpu_torch.telemetry.events import RunLog

_PH_KNOWN = {"X", "i", "M"}


def _binary(rows, features=7, bins=29, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] > bins // 2).astype(np.float32)
    return Xb, y


def _fabricate_two_hosts(tmp_path, offset_s=5.25):
    """A real port run log and a host-1 twin whose clock runs offset_s
    ahead and whose rounds are slower."""
    Xb, y = _binary(1200, seed=7)
    p0 = str(tmp_path / "host0.jsonl")
    with RunLog(p0) as rl:
        api.train(Xb, y, binned=True, n_trees=3, max_depth=3, n_bins=29,
                  device="cpu", run_log=rl, log_every=1)
    ev0 = report.read_events(p0)
    p1 = str(tmp_path / "host1.jsonl")
    with open(p1, "w", encoding="utf-8") as f:
        for e in ev0:
            e2 = copy.deepcopy(e)
            e2["t"] += offset_s
            e2["host"] = 1
            if e2["event"] == "round":
                e2["ms_per_round"] += 1.0
            f.write(json.dumps(e2) + "\n")
    return p0, p1, ev0


def _validate_trace(trace):
    assert set(trace) == {"traceEvents", "displayTimeUnit"}
    assert trace["displayTimeUnit"] == "ms" and trace["traceEvents"]
    for rec in trace["traceEvents"]:
        assert isinstance(rec["name"], str) and rec["name"]
        assert rec["ph"] in _PH_KNOWN
        assert isinstance(rec["ts"], (int, float)) and rec["ts"] >= 0
        assert isinstance(rec["pid"], int) and isinstance(rec["tid"], int)
        if rec["ph"] == "X":
            assert isinstance(rec["dur"], (int, float)) and rec["dur"] >= 0


def test_two_host_merge_offset_and_deterministic_order(tmp_path):
    p0, p1, ev0 = _fabricate_two_hosts(tmp_path)
    merged = merge.merge_paths([p0, p1])
    assert merged == jmerge.merge_paths([p0, p1])
    assert len(merged) == 2 * len(ev0)
    mans = [e for e in merged if e["event"] == "run_manifest"]
    assert abs(mans[0]["t"] - mans[1]["t"]) < 1e-6
    key = [(e["event"], e["host"], round(e["t"], 6), e["seq"])
           for e in merged]
    assert key == [(e["event"], e["host"], round(e["t"], 6), e["seq"])
                   for e in merge.merge_paths([p1, p0])]
    assert [e["t"] for e in merged] == sorted(e["t"] for e in merged)
    rounds = [(e["round"], e["host"]) for e in merged
              if e["event"] == "round"]
    assert rounds == [(r, h) for r in (1, 2, 3) for h in (0, 1)]


def test_merge_refuses_mismatched_run_ids(tmp_path):
    p0, p1, _ = _fabricate_two_hosts(tmp_path)
    other = str(tmp_path / "other.jsonl")
    with open(other, "w", encoding="utf-8") as f:
        for e in report.read_events(p1):
            e2 = dict(e)
            if e2["event"] == "run_manifest":
                e2["run_id"] = "feedfeedfeed"
            f.write(json.dumps(e2) + "\n")
    with pytest.raises(ValueError, match="different runs"):
        merge.merge_paths([p0, other])


def test_merged_report_single_segment_and_one_curve(tmp_path, capsys):
    p0, p1, _ = _fabricate_two_hosts(tmp_path)
    assert main(["report", "--log", p0, "--log", p1, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_runs_in_log"] == 1
    assert summary["hosts"] == [0, 1]
    assert summary["n_round_records"] == 3
    assert main(["report", "--log", p0, "--log", p1]) == 0
    text = capsys.readouterr().out
    assert "hosts: 2 merged" in text
    assert jmain(["report", "--log", p0, "--log", p1]) == 0
    assert capsys.readouterr().out == text


def _partition_host_log(path, host, t0, grow_ms):
    recs = [
        {"event": "run_manifest", "trainer": "driver", "backend": "cuda",
         "loss": "logloss", "n_trees": 3, "max_depth": 3, "rows": 64,
         "features": 4, "run_id": "aaaabbbbcccc", "host": host},
        {"event": "partition_phases", "round": 1, "rounds": 3,
         "partitions": [{"device": host * 2 + d,
                         "phases": {"grow_block": grow_ms[d]},
                         "hist_allreduce_bytes": 128} for d in (0, 1)]},
        {"event": "partition_skew", "n_partitions": 2,
         "phases": [{"phase": "grow_block", "ms_max": max(grow_ms),
                     "ms_median": sum(grow_ms) / 2, "skew": 1.0,
                     "max_device": host * 2}]},
        {"event": "run_end", "completed_rounds": 3, "wallclock_s": 1.0},
    ]
    with open(path, "w", encoding="utf-8") as f:
        for i, r in enumerate(recs):
            f.write(json.dumps({"schema": 2, "t": t0 + i * 0.1, "seq": i,
                                **r}) + "\n")


def test_merged_straggler_table_covers_every_host(tmp_path):
    p0, p1 = str(tmp_path / "h0.jsonl"), str(tmp_path / "h1.jsonl")
    _partition_host_log(p0, 0, 100.0, [50.0, 90.0])
    _partition_host_log(p1, 1, 104.5, [10.0, 20.0])
    merged = merge.merge_paths([p0, p1])
    summary = report.summarize(merged)
    assert summary == jreport.summarize(jmerge.merge_paths([p0, p1]))
    assert summary["n_partitions"] == 4
    assert summary["partition_rounds_observed"] == 3
    row = summary["partition_skew"][0]
    assert (row["ms_max"], row["max_host"], row["max_device"]) == \
        (90.0, 0, 1)
    assert row["ms_median"] == pytest.approx(35.0)
    text = report.render(summary)
    assert "@h0/dev1" in text and text == jreport.render(summary)


def test_single_log_from_nonzero_host_keeps_partition_rounds(tmp_path):
    p = str(tmp_path / "h2.jsonl")
    _partition_host_log(p, 2, 10.0, [5.0, 7.0])
    summary = report.summarize(report.read_events(p))
    assert summary == jreport.summarize(jreport.read_events(p))
    assert summary["hosts"] == [2]
    assert summary["partition_rounds_observed"] == 3
    assert summary["n_partitions"] == 2


def test_merge_hostless_v1_logs_stays_deterministic(tmp_path):
    def v1_log(path, t0):
        recs = [
            {"event": "run_manifest", "trainer": "driver",
             "backend": "cpu", "loss": "logloss", "n_trees": 1,
             "max_depth": 3, "rows": 8, "features": 2},
            {"event": "round", "round": 1, "ms_per_round": 2.0,
             "train_loss": None},
            {"event": "run_end", "completed_rounds": 1,
             "wallclock_s": 0.1},
        ]
        with open(path, "w", encoding="utf-8") as f:
            for i, r in enumerate(recs):
                f.write(json.dumps({"schema": 1, "t": t0 + i * 0.1,
                                    "seq": i, **r}) + "\n")

    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    v1_log(pa, 50.0)
    v1_log(pb, 57.0)
    merged = merge.merge_paths([pa, pb])
    assert merged == jmerge.merge_paths([pa, pb])
    key = [(e["event"], e["host"], round(e["t"], 6), e["seq"])
           for e in merged]
    assert key == [(e["event"], e["host"], round(e["t"], 6), e["seq"])
                   for e in merge.merge_paths([pb, pa])]
    assert key[0][1] == 0


def test_same_host_restart_still_two_segments(tmp_path):
    Xb, y = _binary(800, seed=11)
    path = str(tmp_path / "restart.jsonl")
    for _ in range(2):
        with RunLog(path) as rl:
            api.train(Xb, y, binned=True, n_trees=2, max_depth=3,
                      n_bins=29, device="cpu", run_log=rl)
    summary = report.summarize(report.read_events(path))
    assert summary["n_runs_in_log"] == 2
    assert summary["n_round_records"] == 2


@pytest.mark.parametrize("loop", ["fused", "profiled"])
def test_trace_export_of_a_port_run(tmp_path, loop):
    Xb, y = _binary(2048, seed=13)
    path = str(tmp_path / "run.jsonl")
    with RunLog(path) as rl:
        api.train(Xb, y, binned=True, n_trees=3, max_depth=3, n_bins=29,
                  device="cpu", run_log=rl, profile=loop == "profiled")
    events = report.read_events(path)
    trace = perfetto.to_trace_events(events)
    assert trace == jperfetto.to_trace_events(events)
    _validate_trace(trace)
    recs = trace["traceEvents"]
    assert [r["name"] for r in recs if r["ph"] == "X" and r["tid"] == 0
            and r["name"].startswith("round ")] == \
        ["round 1", "round 2", "round 3"]


def test_trace_cli_merged_two_hosts_parses(tmp_path, capsys):
    p0, p1, _ = _fabricate_two_hosts(tmp_path)
    out = str(tmp_path / "trace.json")
    assert main(["trace", "--log", p0, "--log", p1, "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == out and line["trace_events"] > 0
    with open(out, encoding="utf-8") as f:
        trace = json.load(f)
    _validate_trace(trace)
    assert {r["pid"] for r in trace["traceEvents"]} == {0, 1}
    ref = str(tmp_path / "ref.json")
    assert jmain(["trace", "--log", p0, "--log", p1, "--out", ref]) == 0
    with open(ref, encoding="utf-8") as f:
        assert json.load(f) == trace


def test_trace_cli_fails_loudly_on_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": "nonsense", "schema": 1, "t": 0, "seq": 0}\n')
    with pytest.raises(SystemExit, match="trace:"):
        main(["trace", "--log", str(bad), "--out",
              str(tmp_path / "t.json")])


def test_host_rss_counter_recorded_and_rendered(tmp_path):
    from ddt_tpu_torch.telemetry import counters as tele_counters

    assert tele_counters.host_peak_rss_bytes() > 1 << 20
    Xb, y = _binary(700, seed=17)
    path = str(tmp_path / "rss.jsonl")
    with RunLog(path) as rl:
        api.train(Xb, y, binned=True, n_trees=2, max_depth=3, n_bins=29,
                  device="cpu", run_log=rl)
    events = report.read_events(path)
    c = [e for e in events if e["event"] == "counters"][-1]
    assert c["host_peak_rss_bytes"] > 1 << 20
    text = report.render(report.summarize(events))
    assert "host_rss_peak=" in text
    assert text == jreport.render(jreport.summarize(events))


def test_reference_run_log_renders_through_the_port(tmp_path):
    """A log written by the reference's trainer reads, summarizes and
    renders through the port's report as through its own."""
    from ddt_tpu import api as japi
    from ddt_tpu.config import TrainConfig as JConfig

    Xb, y = _binary(900, seed=19)
    path = str(tmp_path / "ref.jsonl")
    japi.train(Xb, y, JConfig(backend="tpu", n_trees=3, max_depth=3,
                              n_bins=29), binned=True, run_log=path,
               eval_set=(Xb[:200], y[:200]))
    events = report.read_events(path)
    assert events == jreport.read_events(path)
    summary = report.summarize(events)
    assert report.render(summary) == jreport.render(
        jreport.summarize(events))


@pytest.fixture(scope="module")
def pool():
    p = spawn.Pool(2, backend="gloo", device="cpu", timeout_s=120.0)
    yield p
    p.close()


@pytest.mark.parametrize("layout", [dict(n_partitions=2),
                                    dict(host_partitions=2)],
                         ids=["rows", "hosts"])
def test_a_mesh_run_log_is_written_by_each_hosts_first_rank(
        pool, tmp_path, layout):
    """Row partitions: the host's rank 0 writes the log; its manifest
    carries the layout. Two hosts: each host's first rank writes its own
    log (here one a host, each with its host index)."""
    Xb, y = _binary(1600, seed=23)
    kw = dict(n_trees=3, max_depth=3, n_bins=29, **layout)
    paths = [str(tmp_path / f"r{r}.jsonl") for r in range(2)]
    pool.run(tasks.train_logged, Xb, y, kw, paths)
    written = [p for p in paths if (tmp_path / p).exists()]
    hosts = 2 if "host_partitions" in layout else 1
    assert len(written) == hosts
    for h, p in enumerate(written):
        man = report.read_events(p)[0]
        assert man["host"] == h and man["distributed"] is True
        assert man["mesh_layout"] == [2, 1]
        assert man["split_comms"] == "reduce_scatter"
    if hosts == 2:
        merged = merge.merge_paths(written)
        assert report.summarize(merged)["hosts"] == [0, 1]
