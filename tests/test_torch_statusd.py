"""The port's training operations plane against ddt_tpu's on the CPU
(mirrors tests/test_statusd.py case by case): the live read-only status
daemon, its exposition, the train_heartbeat event, the disabled path,
and `report progress` over a log whose run died mid-round.

JSON bodies and exposition lines are compared with the reference's
daemon over the same TrainStatus inputs exactly, up to the values that
measure the process (uptime, checkpoint age, memory watermarks).
"""

import inspect
import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from ddt_tpu.telemetry import report as jreport
from ddt_tpu.telemetry.statusd import TrainStatus as JStatus
from ddt_tpu_torch import api
from ddt_tpu_torch.cli import main as cli_main
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry import report
from ddt_tpu_torch.telemetry.events import (EVENT_FIELDS, SCHEMA_VERSION,
                                            RunLog, emit_train_heartbeat,
                                            validate_event)
from ddt_tpu_torch.telemetry.exposition import (EXPOSITION_CONTENT_TYPE,
                                                parse_exposition)
from ddt_tpu_torch.telemetry.statusd import TrainStatus, start_statusd

MEASURED = {"uptime_s", "checkpoint_age_s", "host_peak_rss_bytes",
            "device_peak_bytes", "counters"}


def _binary(rows, features=7, bins=29, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] > bins // 2).astype(np.float32)
    return Xb, y


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5)


def _drive(st):
    st.begin_run(run_id="deadbeef", total_rounds=10, rows=1000)
    st.round_end(0, 20.0, {"round": 1, "ms_per_round": 20.0})
    st.round_end(1, 10.0, {"round": 2, "ms_per_round": 10.0})
    st.checkpoint_saved(2)
    return st


def test_statusd_live_socket_sweep():
    st = _drive(TrainStatus())
    d = start_statusd(st, port=0)
    try:
        assert d.port > 0
        h = json.load(_get(d.port, "/healthz"))
        ref = _drive(JStatus()).healthz()
        assert {k: v for k, v in h.items() if k not in MEASURED} == \
            {k: v for k, v in ref.items() if k not in MEASURED}
        assert set(h) == set(ref) and set(h["counters"]) == \
            set(ref["counters"])
        assert (h["round"], h["total_rounds"], h["rows"]) == (2, 10, 1000)
        assert h["ms_per_round"] == pytest.approx(15.0)
        assert h["eta_s"] == pytest.approx(8 * 0.015, rel=1e-3)
        assert h["device_peak_bytes"] is None     # no card used
        resp = _get(d.port, "/metrics")
        assert resp.headers["Content-Type"] == EXPOSITION_CONTENT_TYPE
        series = parse_exposition(resp.read().decode("utf-8"))
        for k in ("ddt_train_rounds_total", "ddt_hist_allreduce_bytes_total",
                  "ddt_train_checkpoint_age_seconds",
                  "ddt_host_peak_rss_bytes", "ddt_jit_compiles_total"):
            assert k in series, k
        assert series["ddt_train_round"][()] == 2.0
        assert series["ddt_train_total_rounds"][()] == 10.0
        assert series["ddt_train_rows_per_s"][()] > 0
        rr = json.load(_get(d.port, "/debug/rounds"))
        assert rr == {"rounds": _drive(JStatus()).rounds_ring(), "n": 2}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(d.port, "/nope")
        assert ei.value.code == 404
        assert "/healthz" in json.loads(ei.value.read())["routes"]
    finally:
        d.close()


def test_statusd_scrape_is_strictly_read_only():
    st = TrainStatus()
    st.begin_run(run_id="r", total_rounds=4, rows=100)
    st.round_end(0, 5.0, {"round": 1, "ms_per_round": 5.0})
    d = start_statusd(st, port=0)
    try:
        before = tele_counters.snapshot()
        a = _get(d.port, "/metrics").read()
        b = _get(d.port, "/metrics").read()

        def stable(body):
            return [ln for ln in body.decode().splitlines()
                    if not ln.startswith("ddt_host_peak_rss_bytes")]

        assert stable(a) == stable(b)
        assert tele_counters.snapshot() == before
        assert len(st._round_ms) == 1 and len(st._ring) == 1
        json.load(_get(d.port, "/healthz"))
        json.load(_get(d.port, "/debug/rounds"))
        assert tele_counters.snapshot() == before
    finally:
        d.close()


def test_statusd_counters_monotone_across_scrapes():
    st = TrainStatus()
    st.begin_run(run_id="r", total_rounds=100, rows=10)
    d = start_statusd(st, port=0)
    try:
        seen_counter, seen_gauge = [], []
        for i in range(3):
            st.round_end(i, 1.0)
            tele_counters.record_train_round()
            series = parse_exposition(
                _get(d.port, "/metrics").read().decode())
            seen_counter.append(series["ddt_train_rounds_total"][()])
            seen_gauge.append(series["ddt_train_round"][()])
        assert seen_counter == sorted(seen_counter)
        assert seen_counter[-1] >= seen_counter[0] + 2
        assert seen_gauge == [1.0, 2.0, 3.0]
    finally:
        d.close()


def test_metrics_text_lines_are_the_references():
    """The daemon's exposition has the reference's series, in its order,
    for the same counters and progress."""
    from ddt_tpu.telemetry import counters as jc

    mine = _drive(TrainStatus()).metrics_text().splitlines()
    theirs = _drive(JStatus()).metrics_text().splitlines()

    def names(lines):
        return [ln.split(" ")[0] for ln in lines if not ln.startswith("#")]

    assert names(mine) == names(theirs)
    assert list(tele_counters._c) == list(jc._c)


def test_exposition_factored_not_forked():
    from ddt_tpu_torch.serve import metrics as serve_metrics
    from ddt_tpu_torch.telemetry import exposition, statusd

    assert serve_metrics.render_counters is exposition.render_counters
    assert statusd.render_counters is exposition.render_counters
    assert statusd.EXPOSITION_CONTENT_TYPE is \
        exposition.EXPOSITION_CONTENT_TYPE


def test_new_counters_registered_everywhere():
    from ddt_tpu_torch.telemetry.diffing import COUNTER_DIRECTIONS
    from ddt_tpu_torch.telemetry.events import EVENT_EXTRAS

    snap = tele_counters.snapshot()
    for name in ("train_rounds", "train_heartbeats", "jit_compiles",
                 "grad_stream_bytes_est"):
        assert name in snap
        assert name in COUNTER_DIRECTIONS
    for name in ("train_rounds", "train_heartbeats", "device_peak_bytes",
                 "host_peak_rss_bytes"):
        assert name in EVENT_EXTRAS["counters"]


def test_train_heartbeat_schema_additive(tmp_path):
    assert SCHEMA_VERSION == 5
    assert EVENT_FIELDS["train_heartbeat"] == {"round"}
    path = str(tmp_path / "run.jsonl")
    with RunLog(path) as rl:
        emit_train_heartbeat(rl, rnd=5, total_rounds=12,
                             checkpoint_round=6, ms_per_round=37.5,
                             rows_per_s=12000.0)
    (ev,) = report.read_events(path)
    (ref,) = jreport.read_events(path)
    assert ev == ref
    validate_event(ev)
    assert (ev["round"], ev["checkpoint_round"], ev["ms_per_round"]) == \
        (6, 6, 37.5)


def test_driver_emits_heartbeats_at_checkpoint_cadence(tmp_path):
    Xb, y = _binary(1201)
    path = str(tmp_path / "run.jsonl")
    with RunLog(path) as rl:
        api.train(Xb, y, binned=True, n_trees=4, max_depth=3, n_bins=29,
                  device="cpu", run_log=rl,
                  checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    hb = [e for e in report.read_events(path)
          if e["event"] == "train_heartbeat"]
    rounds = [e["round"] for e in hb]
    assert rounds == [2, 4]
    assert [e.get("checkpoint_round") for e in hb] == [2, None]
    assert all(e.get("total_rounds") == 4 for e in hb)


@pytest.mark.parametrize("stream", [False, True], ids=["driver", "stream"])
def test_statusd_tracks_a_real_training_run(tmp_path, stream):
    Xb, y = _binary(1200)
    st = TrainStatus()
    if stream:
        from ddt_tpu_torch.config import TrainConfig
        from ddt_tpu_torch.streaming import fit_streaming

        def chunk_fn(c):
            return Xb[c * 400:(c + 1) * 400], y[c * 400:(c + 1) * 400]

        fit_streaming(chunk_fn, 3, TrainConfig(
            device="cpu", n_trees=4, max_depth=3, n_bins=29), status=st,
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    else:
        api.train(Xb, y, binned=True, n_trees=4, max_depth=3, n_bins=29,
                  device="cpu", status=st,
                  checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    h = st.healthz()
    assert h["round"] == 4 and h["total_rounds"] == 4
    assert h["phase"] == "done" and h["run_id"]
    assert h["last_checkpoint_round"] == (4 if stream else 2)
    assert [r["round"] for r in st.rounds_ring()] == [1, 2, 3, 4]


def test_no_status_port_means_no_statusd_import_or_state(tmp_path):
    assert inspect.signature(api.train).parameters["status"].default \
        is None
    assert inspect.signature(Driver.__init__).parameters["status"] \
        .default is None
    saved = sys.modules.pop("ddt_tpu_torch.telemetry.statusd", None)
    try:
        assert cli_main(["train", "--device=cpu", "--dataset=higgs",
                         "--rows=601", "--trees=2", "--depth=3",
                         f"--out={tmp_path / 'm.npz'}"]) == 0
        assert "ddt_tpu_torch.telemetry.statusd" not in sys.modules
    finally:
        if saved is not None:
            sys.modules["ddt_tpu_torch.telemetry.statusd"] = saved


def test_cli_train_status_port_serves_during_the_run(tmp_path, capsys):
    """--status-port prints the bound port first, and the daemon is
    closed when train returns."""
    assert cli_main(["train", "--device=cpu", "--rows=800", "--trees=3",
                     "--depth=2", "--bins=15", "--status-port=0",
                     f"--out={tmp_path / 'm.npz'}"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    port = json.loads(lines[0])["statusd"]["port"]
    assert json.loads(lines[-1])["trees"] == 3
    with pytest.raises(OSError):
        _get(port, "/healthz")


def _dead_run_log(path, drift=False):
    with RunLog(str(path)) as rl:
        rl.emit("run_manifest", trainer="driver", backend="cuda",
                loss="logloss", n_trees=10, max_depth=3, rows=999,
                features=7)
        for r in range(5):
            rl.emit("round", round=r + 1, ms_per_round=100.0,
                    train_loss=0.6)
            if (r + 1) % 2 == 0:
                emit_train_heartbeat(rl, rnd=r, total_rounds=10,
                                     checkpoint_round=r + 1,
                                     ms_per_round=100.0,
                                     rows_per_s=9990.0)
        if drift:
            rl.emit("drift", psi_max=0.5, alerts=1)
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"event": "round", "schema": 5, "t": 1.0, "seq')


def test_report_progress_over_mid_round_death(tmp_path, capsys):
    path = tmp_path / "dead.jsonl"
    _dead_run_log(path)
    summary = report.summarize(report.read_events(str(path)))
    assert summary == jreport.summarize(jreport.read_events(str(path)))
    pg = summary["progress"]
    assert (pg["heartbeats"], pg["last_round"], pg["total_rounds"],
            pg["last_checkpoint_round"], pg["completed"]) == \
        (2, 5, 10, 4, False)
    text = report.render_progress(summary)
    assert text == jreport.render_progress(summary)
    assert "DIED MID-RUN" in text and "round 5/10" in text
    assert cli_main(["report", f"--log={path}", "progress"]) == 0
    assert "DIED MID-RUN" in capsys.readouterr().out


def test_report_progress_fails_loudly_without_heartbeats(tmp_path):
    path = tmp_path / "old.jsonl"
    with RunLog(str(path)) as rl:
        rl.emit("run_manifest", trainer="driver", backend="cuda",
                loss="logloss", n_trees=2, max_depth=3, rows=10,
                features=4)
        rl.emit("round", round=1, ms_per_round=1.0, train_loss=0.5)
        rl.emit("run_end", completed_rounds=1, wallclock_s=0.1)
    summary = report.summarize(report.read_events(str(path)))
    assert summary["progress"] is None
    with pytest.raises(ValueError, match="no training heartbeat"):
        report.render_progress(summary)
    with pytest.raises(SystemExit, match="report: .*heartbeat"):
        cli_main(["report", f"--log={path}", "progress"])


def test_trace_renders_heartbeats_and_never_drops_kinds(tmp_path):
    from ddt_tpu.telemetry import perfetto as jperfetto
    from ddt_tpu_torch.telemetry import perfetto

    path = tmp_path / "dead.jsonl"
    _dead_run_log(path, drift=True)
    events = report.read_events(str(path))
    trace = perfetto.to_trace_events(events)
    assert trace == jperfetto.to_trace_events(events)
    recs = trace["traceEvents"]
    hb = [r for r in recs if r["name"] == "train_heartbeat"]
    assert hb and all(r["tid"] == 0 and r["ph"] == "i" for r in hb)
    dr = [r for r in recs if r["name"] == "drift"]
    assert dr and dr[0]["tid"] == perfetto._MISC_TID
