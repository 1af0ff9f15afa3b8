"""Training telemetry of the port against ddt_tpu on the CPU: the round
records (`history`), run logs, phase timings, counters, the disabled
path, and the streamed trainer's events (mirrors tests/test_telemetry.py
case by case where the case has a counterpart).

Run logs are compared field for field with the reference's on the same
seeded inputs, except the fields that measure this process (times,
`t`, counters of bytes the reference's XLA programs move); round losses
and eval scores to rtol 1e-5. The port's `jit_compiles` is held only to
its own events (nvcc builds and graph captures), never to the
reference's count.
"""

import builtins
import json
import logging

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.telemetry import report as jreport
from ddt_tpu.telemetry.events import validate_event as jvalidate
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.streaming import fit_streaming
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry import report
from ddt_tpu_torch.telemetry.events import EVENT_FIELDS, RunLog
from ddt_tpu_torch.utils.profiling import PhaseTimer

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


class Granular(CUDADevice):
    grow_rounds = None


def _binary(rows, features=7, bins=29, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] > bins // 2).astype(np.float32)
    flip = rng.random(rows) < 0.1
    y[flip] = 1 - y[flip]
    return Xb, y


def _by_type(events):
    out = {}
    for e in events:
        out.setdefault(e["event"], []).append(e)
    return out


# --------------------------------------------------------------------- #
# Queue 3 fault 5: the history's shape
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("level", [logging.INFO, logging.WARNING],
                         ids=["info", "warning"])
@pytest.mark.parametrize("log_every", [1, 3, 10])
@pytest.mark.parametrize("with_eval", [False, True],
                         ids=["no_eval", "eval"])
@pytest.mark.parametrize("loop", ["fused", "granular"])
def test_history_records_equal_reference(loop, with_eval, log_every, level,
                                         caplog):
    """Both packages give the same keys, the same rounds in `history` and
    train_loss on the same rounds, on both loops, at any logging level;
    losses and eval scores to rtol 1e-5, ms_per_round > 0."""
    caplog.set_level(level)
    for name in ("ddt_tpu_torch", "ddt_tpu"):
        logging.getLogger(name).setLevel(level)
    Xb, y = _binary(1500, seed=11)
    kw = dict(n_trees=12, max_depth=3, n_bins=29)
    fit = {}
    if with_eval:
        Xv, yv = _binary(400, seed=12)
        fit = dict(eval_set=(Xv, yv), eval_metric="logloss")
    ref = japi.train(Xb, y, JConfig(backend="tpu", **kw), binned=True,
                     log_every=log_every, profile=loop == "granular", **fit)
    cfg = TrainConfig(device="cpu", **kw)
    be = Granular(cfg) if loop == "granular" else get_backend(cfg)
    port = api.train(Xb, y, cfg, binned=True, backend=be,
                     log_every=log_every, **fit)
    assert [sorted(r) for r in port.history] == \
        [sorted(r) for r in ref.history]
    assert [r["round"] for r in port.history] == \
        [r["round"] for r in ref.history]
    assert [r["train_loss"] is None for r in port.history] == \
        [r["train_loss"] is None for r in ref.history]
    for a, b in zip(port.history, ref.history):
        assert a["ms_per_round"] > 0
        for k in a:
            if k not in ("round", "ms_per_round") and a[k] is not None:
                assert a[k] == pytest.approx(b[k], rel=1e-5), k


def test_history_is_loop_and_level_independent(caplog):
    """Fused and granular histories are identical in keys, rounds and
    values but the times, and independent of the logging level."""
    Xb, y = _binary(1200, seed=13)
    cfg = TrainConfig(device="cpu", n_trees=7, max_depth=3, n_bins=29)
    got = []
    for level in (logging.INFO, logging.WARNING):
        caplog.set_level(level)
        logging.getLogger("ddt_tpu_torch").setLevel(level)
        for be in (get_backend(cfg), Granular(cfg)):
            res = api.train(Xb, y, cfg, binned=True, backend=be,
                            log_every=3)
            got.append([{k: v for k, v in r.items() if k != "ms_per_round"}
                        for r in res.history])
    assert all(g == got[0] for g in got)
    assert [r["round"] for r in got[0]] == [3, 6, 7]


# --------------------------------------------------------------------- #
# run logs
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("loop", ["fused", "granular"])
def test_driver_e2e_run_log_counters_and_eval_curve(tmp_path, loop):
    """A train with an eval set writes a log that validates in both
    packages' readers, with per-round eval metrics, phase timings, the
    port's own compile events and the fetched bytes."""
    Xb, y = _binary(2113)
    Xv, yv = _binary(431, seed=1)
    path = str(tmp_path / "run.jsonl")
    cfg = TrainConfig(device="cpu", n_trees=4, max_depth=3, n_bins=29)
    be = Granular(cfg) if loop == "granular" else get_backend(cfg)
    with RunLog(path) as rl:
        res = api.train(Xb, y, cfg, binned=True, backend=be,
                        eval_set=(Xv, yv), eval_metric="logloss",
                        run_log=rl)
    events = report.read_events(path)
    assert events == jreport.read_events(path)
    for e in events:
        jvalidate(e)
    by_type = _by_type(events)
    assert {"run_manifest", "round", "phase_timings", "counters",
            "run_end", "cost_analysis"} <= set(by_type)
    man = by_type["run_manifest"][0]
    assert (man["trainer"], man["backend"]) == ("driver", "cuda")
    assert (man["rows"], man["features"]) == (2113, 7)
    assert man["run_id"] == res.run_id
    assert man["host"] == 0 and man["distributed"] is False
    rounds = by_type["round"]
    assert [r["round"] for r in rounds] == [1, 2, 3, 4]
    assert all("valid_logloss" in r for r in rounds)
    assert all(r["ms_per_round"] > 0 for r in rounds)
    c = by_type["counters"][-1]
    assert c["jit_compiles"] == 0          # nothing built or captured
    assert c["train_rounds"] == 4
    assert c["grad_stream_bytes_est"] == 4 * tele_counters.grad_stream_bytes(
        2113, 3, "f32")
    assert c["device_peak_bytes"] is None and c["host_peak_rss_bytes"] > 0
    if loop == "fused":
        assert c["d2h_bytes"] > 0
    phases = {p["phase"] for p in by_type["phase_timings"][-1]["phases"]}
    assert phases == ({"grow_block", "fetch_tree"} if loop == "fused" else
                      {"grad", "grow", "apply_delta", "fetch_tree", "eval"})
    hist = [e for e in by_type["cost_analysis"] if e["op"] == "hist"]
    assert hist and all(e["platform"] == "cpu" for e in hist)
    assert by_type["run_end"][-1]["completed_rounds"] == 4


def test_run_log_equals_references_up_to_measurements(tmp_path):
    """The same seeded train through both packages: the same sequence of
    event types, the same manifest, round, early-stop and heartbeat
    payloads, up to the fields that measure the process."""
    Xb, y = _binary(1600, seed=21)
    rng = np.random.default_rng(22)
    Xv = rng.integers(0, 29, size=(300, 7), dtype=np.uint8)
    yv = rng.integers(0, 2, size=300).astype(np.float32)
    kw = dict(n_trees=30, max_depth=3, n_bins=29)
    fit = dict(eval_set=(Xv, yv), early_stopping_rounds=3,
               checkpoint_every=2)
    a, b = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    ref = japi.train(Xb, y, JConfig(backend="tpu", **kw), binned=True,
                     run_log=a, **fit)
    port = api.train(Xb, y, TrainConfig(device="cpu", **kw), binned=True,
                     run_log=b, **fit)
    assert port.best_round == ref.best_round
    ea, eb = jreport.read_events(a), report.read_events(b)
    skip = {"cost_analysis", "phase_timings"}
    assert [e["event"] for e in ea if e["event"] not in skip] == \
        [e["event"] for e in eb if e["event"] not in skip]
    measured = {"t", "seq", "ms_per_round", "rows_per_s", "run_id",
                "backend", "wallclock_s"}
    ta, tb = _by_type(ea), _by_type(eb)
    for kind in ("round", "early_stop", "train_heartbeat"):
        assert len(ta[kind]) == len(tb[kind]) > 0
        for x, z in zip(ta[kind], tb[kind]):
            assert set(x) == set(z)
            for k in x:
                if k in measured:
                    continue
                if isinstance(x[k], float):
                    assert z[k] == pytest.approx(x[k], rel=1e-5), (kind, k)
                else:
                    assert z[k] == x[k], (kind, k)
    ma, mb = ta["run_manifest"][0], tb["run_manifest"][0]
    assert {k: v for k, v in ma.items() if k not in measured} == \
        {k: v for k, v in mb.items() if k not in measured}


def test_validate_event_rejects_malformed():
    from ddt_tpu_torch.telemetry.events import validate_event

    good = {"event": "round", "schema": 5, "t": 0.0, "seq": 0, "round": 1,
            "ms_per_round": 1.0}
    validate_event(good)
    for bad, match in (({**good, "event": "nope"}, "unknown"),
                       ({k: v for k, v in good.items() if k != "round"},
                        "missing required"),
                       ({k: v for k, v in good.items() if k != "seq"},
                        "envelope"),
                       ({**good, "schema": 99}, "newer"),
                       ({**good, "schema": "5"}, "integer")):
        with pytest.raises(ValueError, match=match):
            validate_event(bad)


def test_runlog_rejects_bad_emit_at_the_producer(tmp_path):
    rl = RunLog(str(tmp_path / "x.jsonl"))
    with pytest.raises(ValueError, match="missing required"):
        rl.emit("round", round=1)
    with pytest.raises(ValueError, match="unknown"):
        rl.emit("not_an_event")
    rl.close()
    assert not (tmp_path / "x.jsonl").exists()


def test_disabled_path_no_syncs_no_file_io(monkeypatch):
    """No run log, no profile, no window, no status: the fused loop makes
    no synchronize, .item() or open, constructs no RunLog, installs no
    cost collector and no profiler, and imports no status daemon."""
    import sys

    import ddt_tpu_torch.telemetry.events as ev_mod
    from ddt_tpu_torch.telemetry import costmodel

    def boom(*a, **k):
        raise AssertionError("telemetry touched while disabled")

    calls = {"sync": 0, "item": 0, "open": 0}
    real_item, real_open = torch.Tensor.item, builtins.open

    def item(self):
        calls["item"] += 1
        return real_item(self)

    def opened(*a, **k):
        calls["open"] += 1
        return real_open(*a, **k)

    def sync(*a, **k):
        calls["sync"] += 1

    Xb, y = _binary(977)
    cfg = TrainConfig(device="cpu", n_trees=3, max_depth=3, n_bins=29)
    be = get_backend(cfg)
    monkeypatch.setattr(ev_mod.RunLog, "__init__", boom)
    monkeypatch.setattr(ev_mod.RunLog, "emit", boom)
    monkeypatch.setattr(costmodel, "activate", boom)
    monkeypatch.setattr(torch.profiler, "profile", boom)
    monkeypatch.setattr(PhaseTimer, "__init__", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.Tensor, "item", item)
    monkeypatch.setattr(builtins, "open", opened)
    sys.modules.pop("ddt_tpu_torch.telemetry.statusd", None)
    res = api.train(Xb, y, cfg, binned=True, backend=be)
    monkeypatch.undo()
    assert res.ensemble.n_trees == 3 and res.run_id is None
    assert calls == {"sync": 0, "item": 0, "open": 0}
    assert "ddt_tpu_torch.telemetry.statusd" not in sys.modules


def test_costed_calls_cost_one_global_read_when_disabled(monkeypatch):
    """With no collector active, a costed dispatcher never computes a
    signature or a cost."""
    from ddt_tpu_torch.telemetry import costmodel

    def boom(*a, **k):
        raise AssertionError("cost work while disabled")

    monkeypatch.setattr(costmodel, "_signature", boom)
    Xb, y = _binary(500)
    api.train(Xb, y, TrainConfig(device="cpu", n_trees=2, max_depth=2,
                                 n_bins=29), binned=True)


def test_early_stop_event_and_driver_history_unchanged():
    Xb, y = _binary(1201, seed=2)
    rng = np.random.default_rng(3)
    Xv = rng.integers(0, 29, size=(301, 7), dtype=np.uint8)
    yv = rng.integers(0, 2, size=301).astype(np.float32)
    rl = RunLog()
    res = api.train(Xb, y, binned=True, n_trees=40, max_depth=3,
                    n_bins=29, device="cpu", eval_set=(Xv, yv),
                    early_stopping_rounds=2, run_log=rl)
    stops = rl.events("early_stop")
    assert len(stops) == 1
    es = stops[0]
    assert es["metric"] == "logloss"
    assert es["best_round"] == res.best_round + 1
    assert es["best_score"] == pytest.approx(res.best_score)
    assert res.ensemble.n_trees == res.best_round + 1
    assert len(rl.events("round")) == len(res.history)


def test_checkpoint_resume_emits_fault_event(tmp_path):
    Xb, y = _binary(1301, seed=4)
    ck = str(tmp_path / "ck")
    api.train(Xb, y, binned=True, n_trees=2, max_depth=3, n_bins=29,
              device="cpu", checkpoint_dir=ck)
    rl = RunLog()
    res = api.train(Xb, y, binned=True, n_trees=4, max_depth=3, n_bins=29,
                    device="cpu", checkpoint_dir=ck, run_log=rl)
    faults = rl.events("fault")
    assert faults and faults[0]["kind"] == "checkpoint_resume"
    assert faults[0]["round"] == 2
    assert res.ensemble.n_trees == 4
    assert rl.events("run_end")[-1]["completed_rounds"] == 4


def test_owned_run_log_closed_when_fit_raises(tmp_path, monkeypatch):
    import ddt_tpu_torch.telemetry.events as ev_mod
    from ddt_tpu_torch.telemetry import costmodel

    closed = []
    real_close = ev_mod.RunLog.close

    def recording_close(self):
        closed.append(self.path)
        real_close(self)

    monkeypatch.setattr(ev_mod.RunLog, "close", recording_close)
    Xb, y = _binary(601, seed=7)
    Xv = np.zeros((50, 7), np.uint8)
    yv = np.zeros(50, np.float32)          # one class: auc is NaN
    log_path = str(tmp_path / "fail.jsonl")
    with pytest.raises(ValueError):
        api.train(Xb, y, binned=True, n_trees=5, max_depth=3, n_bins=29,
                  device="cpu", eval_set=(Xv, yv), eval_metric="auc",
                  early_stopping_rounds=2, run_log=log_path)
    assert log_path in closed
    assert costmodel._active is None
    events = report.read_events(log_path)
    assert events[0]["event"] == "run_manifest"


def test_profile_runs_granular_with_nested_op_phases(tmp_path):
    """profile=True runs the granular loop; the ops' hist and gain phases
    nest in grow, and the phases sum to the rounds' time; trees equal an
    unprofiled run's bitwise."""
    Xb, y = _binary(3000, seed=9)
    cfg = TrainConfig(device="cpu", n_trees=5, max_depth=4, n_bins=29)
    rl = RunLog()
    res = api.train(Xb, y, cfg, binned=True, profile=True, run_log=rl)
    plain = api.train(Xb, y, cfg, binned=True)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(res.ensemble, k),
                                      getattr(plain.ensemble, k))
    phases = {p["phase"]: p for p in rl.events("phase_timings")[-1]["phases"]}
    assert {"grad", "grow", "hist", "gain", "apply_delta",
            "fetch_tree"} <= set(phases)
    assert phases["hist"]["calls"] == 5 * 4          # a call a level
    assert phases["gain"]["calls"] == 5 * 4
    assert sum(p["share"] for p in phases.values()) == pytest.approx(
        1.0, abs=0.01)
    total = sum(p["ms_total"] for p in phases.values())
    wall = sum(r["ms_per_round"] for r in rl.events("round"))
    assert total <= wall * 1.01 + 1.0


def test_phase_timer_nests_exclusively():
    t = PhaseTimer()
    with t.phase("outer"):
        with t.phase("inner"):
            pass
        with t.phase("inner"):
            pass
    got = {r["phase"]: r for r in t.as_json()}
    assert got["inner"]["calls"] == 2 and got["outer"]["calls"] == 1
    assert all(v >= 0 for v in t.totals.values())


@pytest.mark.parametrize("every", [1, 2, 5])
def test_driver_heartbeats_at_checkpoint_cadence(tmp_path, every):
    Xb, y = _binary(800, seed=3)
    kw = dict(n_trees=6, max_depth=2, n_bins=29)
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    japi.train(Xb, y, JConfig(backend="tpu", **kw), binned=True,
               run_log=a, checkpoint_every=every,
               checkpoint_dir=str(tmp_path / "ja"))
    api.train(Xb, y, TrainConfig(device="cpu", **kw), binned=True,
              run_log=b, checkpoint_every=every,
              checkpoint_dir=str(tmp_path / "pa"))

    def beats(p):
        return [(e["round"], e.get("checkpoint_round"))
                for e in report.read_events(p)
                if e["event"] == "train_heartbeat"]

    assert beats(b) == beats(a) and beats(b)


def test_streaming_run_log_and_phase_timer(tmp_path):
    Xb, y = _binary(900, seed=5)
    bounds = [0, 300, 600, 900]

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    Xv, yv = _binary(200, seed=6)

    def valid_fn(c):
        return Xv, yv

    cfg = TrainConfig(n_trees=3, max_depth=3, n_bins=29, device="cpu")
    path = str(tmp_path / "stream.jsonl")
    history = []
    ens = fit_streaming(chunk_fn, 3, cfg, valid_chunk_fn=valid_fn,
                        n_valid_chunks=1, history=history, run_log=path)
    assert ens.n_trees == 3
    events = report.read_events(path)
    for e in events:
        jvalidate(e)
    by_type = _by_type(events)
    man = by_type["run_manifest"][0]
    assert man["trainer"] == "streaming_device"
    assert man["n_chunks"] == 3
    rounds = by_type["round"]
    assert [r["round"] for r in rounds] == [1, 2, 3]
    assert all("valid_logloss" in r for r in rounds)
    phases = {p["phase"] for p in by_type["phase_timings"][-1]["phases"]}
    assert {"hist", "gain", "leaf", "eval"} <= phases
    assert by_type["run_end"][-1]["completed_rounds"] == 3
    assert [h["round"] for h in history] == [1, 2, 3]


def test_streaming_telemetry_changes_no_tree(tmp_path):
    """A streamed run with a run log and profile grows the trees of a
    streamed run without them, bitwise."""
    Xb, y = _binary(1200, seed=8)

    def chunk_fn(c):
        return Xb[c * 400:(c + 1) * 400], y[c * 400:(c + 1) * 400]

    cfg = TrainConfig(n_trees=3, max_depth=3, n_bins=29, device="cpu")
    ens = fit_streaming(chunk_fn, 3, cfg, run_log=RunLog(), profile=True)
    plain = fit_streaming(chunk_fn, 3, cfg)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ens, k), getattr(plain, k))


def test_every_event_type_round_trips_through_both_readers(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with RunLog(path) as rl:
        for ev, req in EVENT_FIELDS.items():
            rl.emit(ev, **{k: (0 if k != "phases" and k != "partitions"
                               and k != "traces" else []) for k in req})
    back = report.read_events(path)
    assert [r["event"] for r in back] == list(EVENT_FIELDS)
    assert back == jreport.read_events(path)


def test_counter_snapshots_delta_and_estimate():
    from ddt_tpu.telemetry import counters as jc

    c0 = tele_counters.snapshot()
    tele_counters.record_h2d(100)
    tele_counters.record_d2h(40)
    tele_counters.record_collective(7)
    d = tele_counters.delta(c0)
    assert (d["h2d_bytes"], d["d2h_bytes"], d["collective_bytes_est"]) \
        == (100, 40, 7)
    assert tele_counters.hist_allreduce_bytes(2, 3, 4) \
        == (1 + 2) * 3 * 4 * 8 + 4 * 8
    for kw in (dict(), dict(partitions=4, mode="reduce_scatter"),
               dict(subtraction=True, grad_dtype="int8"),
               dict(feature_partitions=2, comms_dtype="bf16")):
        assert tele_counters.hist_allreduce_bytes_by_level(6, 28, 255, **kw) \
            == jc.hist_allreduce_bytes_by_level(6, 28, 255, **kw)
        assert tele_counters.hist_allreduce_bytes(6, 28, 255, **kw) \
            == jc.hist_allreduce_bytes(6, 28, 255, **kw)
    for dt in ("f32", "int16", "int8"):
        assert tele_counters.grad_stream_bytes(1000, 6, dt) \
            == jc.grad_stream_bytes(1000, 6, dt)
    assert tele_counters.host_peak_rss_bytes() == jc.host_peak_rss_bytes() \
        or tele_counters.host_peak_rss_bytes() > 0


def test_graph_captures_count_as_compiles(monkeypatch):
    monkeypatch.setattr(tele_counters, "_captures", tele_counters._captures)
    monkeypatch.setattr(tele_counters, "_capture_seconds",
                        tele_counters._capture_seconds)
    c0 = tele_counters.snapshot()
    tele_counters.graph_captured(0.5)
    d = tele_counters.delta(c0)
    assert d["jit_compiles"] == 1 and d["jit_compile_seconds"] == 0.5


def test_run_log_json_lines_are_one_object_each(tmp_path):
    path = tmp_path / "r.jsonl"
    Xb, y = _binary(600)
    api.train(Xb, y, binned=True, n_trees=2, max_depth=2, n_bins=29,
              device="cpu", run_log=str(path))
    for line in path.read_text().splitlines():
        assert isinstance(json.loads(line), dict)
