"""The port's telemetry modules (ddt_tpu_torch/telemetry/) against the
reference's: the counters' key set and record functions, the exposition
writer and parser, the run-log schema tables, `validate_event`,
`derive_run_id`, and a RunLog's file read back by the reference's reader.
"""

import inspect
import json
import sys
import threading

import numpy as np
import pytest

from ddt_tpu.telemetry import counters as jcounters
from ddt_tpu.telemetry import events as jevents
from ddt_tpu.telemetry import exposition as jexpo
from ddt_tpu.telemetry import report as tele_report
from ddt_tpu_torch import _build
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.telemetry import counters, events, exposition


def test_counter_keys_and_record_functions_are_the_references():
    assert list(counters._c) == list(jcounters._c)
    mine = {n for n, _ in inspect.getmembers(counters, inspect.isfunction)
            if n.startswith("record_")}
    theirs = {n for n, _ in inspect.getmembers(jcounters,
                                               inspect.isfunction)
              if n.startswith("record_")}
    assert mine == theirs
    assert set(counters.snapshot()) == set(jcounters.snapshot())


@pytest.mark.parametrize("name", sorted(
    n for n in dir(counters) if n.startswith("record_")))
def test_each_record_function_moves_its_counter(name):
    key = {"record_h2d": "h2d_bytes", "record_d2h": "d2h_bytes",
           "record_collective": "collective_bytes_est",
           "record_compiled_ensemble_hit": "compiled_ensemble_cache_hits",
           "record_fault_retry": "fault_retries",
           "record_hist_oom_degrade": "hist_oom_degrades",
           "record_serve_batch": "serve_batches",
           "record_serve_hot_swap": "serve_hot_swaps",
           "record_fleet_eviction": "fleet_evictions",
           "record_fleet_reload": "fleet_reloads",
           "record_slo_breach": "slo_breaches",
           "record_drift_alert": "drift_alerts",
           "record_grad_stream": "grad_stream_bytes_est",
           "record_grad_quant_round": "grad_quant_rounds",
           "record_train_round": "train_rounds",
           "record_train_heartbeat": "train_heartbeats",
           }.get(name, name[len("record_"):])
    fn = getattr(counters, name)
    c0 = counters.snapshot()
    if inspect.signature(fn).parameters:
        fn(3)
        want = 3
    else:
        fn()
        want = 1
    d = counters.delta(c0)
    assert d[key] == want
    assert all(v == 0 for k, v in d.items() if k != key)


def test_build_counters_read_the_builds(monkeypatch):
    monkeypatch.setattr(_build, "builds", _build.builds + 2)
    monkeypatch.setattr(_build, "build_seconds", 1.23456789)
    snap = counters.snapshot()
    assert snap["jit_compiles"] == _build.builds
    d = counters.delta({**snap, "jit_compiles": snap["jit_compiles"] - 2,
                        "jit_compile_seconds": 0.0})
    assert d["jit_compiles"] == 2 and d["jit_compile_seconds"] == 1.2346


def test_h2d_bytes_has_one_home():
    """The streamed chunk uploads count into telemetry's h2d_bytes; the
    backend keeps no counter of its own."""
    assert not hasattr(cuda_backend, "h2d_bytes")
    be = get_backend(TrainConfig(device="cpu", n_bins=16))
    c0 = counters.snapshot()
    be.upload_chunk(np.zeros((10, 4), np.uint8))
    assert counters.delta(c0)["h2d_bytes"] == 40


@pytest.mark.parametrize("value", [
    0, 7, -3, 2.5, 3.0, 1e20, 1e-7, True, False, 0.1])
def test_num_formats_like_the_reference(value):
    assert exposition._num(value) == jexpo._num(value)


@pytest.mark.parametrize("label", [
    "plain", 'quo"te', "back\\slash", "new\nline", "ünï"])
def test_esc_like_the_reference(label):
    assert exposition._esc(label) == jexpo._esc(label)


def test_render_counters_and_parse_like_the_reference():
    c = {"a": 1, "b": 2.5, "flag": True, "name": "x", "big": 1e16}
    assert exposition.render_counters(c) == jexpo.render_counters(c)
    text = "\n".join(exposition.render_counters(counters.snapshot()) + [
        'ddt_x{model="a",le="+Inf"} 3', "", "# comment"])
    assert exposition.parse_exposition(text) == jexpo.parse_exposition(text)
    assert exposition.EXPOSITION_CONTENT_TYPE == \
        jexpo.EXPOSITION_CONTENT_TYPE


def test_schema_tables_are_the_references():
    assert events.SCHEMA_VERSION == jevents.SCHEMA_VERSION == 5
    assert events.EVENT_FIELDS == jevents.EVENT_FIELDS
    assert events.EVENT_EXTRAS == jevents.EVENT_EXTRAS
    assert events.FAULT_KINDS == jevents.FAULT_KINDS
    assert events.ENVELOPE_FIELDS == jevents.ENVELOPE_FIELDS


RECORDS = [
    {"event": "fault", "schema": 5, "t": 0.0, "seq": 0, "kind": "x"},
    {"event": "fault", "schema": 5, "t": 0.0, "seq": 0},
    {"event": "serve_latency", "schema": 4, "t": 0.0, "seq": 1,
     "requests": 1, "p50_ms": 1.0, "p99_ms": 1.0},
    {"event": "serve_latency", "schema": 6, "t": 0.0, "seq": 1,
     "requests": 1, "p50_ms": 1.0, "p99_ms": 1.0},
    {"event": "nope", "schema": 5, "t": 0.0, "seq": 0},
    {"event": "drift", "schema": True, "t": 0.0, "seq": 0, "psi_max": 1},
    {"event": "drift", "schema": "5", "t": 0.0, "seq": 0, "psi_max": 1},
    {"event": "drift", "t": 0.0, "seq": 0, "psi_max": 1},
    {"event": "artifact", "schema": 5, "t": 0.0, "seq": 0,
     "action": "push"},
    ["not", "a", "dict"],
]


@pytest.mark.parametrize("rec", RECORDS, ids=range(len(RECORDS)))
def test_validate_event_agrees_with_the_reference(rec):
    try:
        jevents.validate_event(rec)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            events.validate_event(rec)
        # The same text, the package named being the reader's own.
        assert str(mine.value).replace("ddt_tpu_torch", "ddt_tpu") \
            == str(e)
        return
    events.validate_event(rec)


@pytest.mark.parametrize("fields", [
    {}, {"a": 1}, {"loss": "logloss", "n_trees": 100, "seed": 0},
    {"x": [1, 2], "y": {"z": None}}, {"path": object}])
def test_derive_run_id_is_the_references(fields):
    assert events.derive_run_id(**fields) == jevents.derive_run_id(**fields)


def test_run_log_file_reads_in_the_reference(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with events.RunLog(path) as rl:
        rl.emit("artifact", action="push", digest="ab" * 8, name="m",
                version=1)
        rl.emit("serve_latency", requests=3, p50_ms=1.0, p99_ms=2.0,
                model_name="m")
        rl.emit("fault", kind="hot_swap", old="a", new="b")
        with pytest.raises(ValueError, match="missing required"):
            rl.emit("drift")
    assert rl.events("fault")[0]["kind"] == "hot_swap"
    got = tele_report.read_events(path)
    assert [e["seq"] for e in got] == [0, 1, 2]
    assert [e["event"] for e in got] == ["artifact", "serve_latency",
                                         "fault"]
    assert events.RunLog.coerce(None) is None
    assert events.RunLog.coerce(rl) is rl
    assert isinstance(events.RunLog.coerce(path), events.RunLog)


def test_run_log_seq_is_strict_under_threads(tmp_path):
    """A RunLog shared by handler threads: every seq once, in file order
    (a lost update would repeat one)."""
    path = str(tmp_path / "threads.jsonl")
    rl = events.RunLog(path)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def emit(i):
            for j in range(200):
                rl.emit("fault", kind="hot_swap", old=str(i), new=str(j))

        threads = [threading.Thread(target=emit, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
        rl.close()
    with open(path, encoding="utf-8") as f:
        seqs = [json.loads(line)["seq"] for line in f]
    assert seqs == list(range(16 * 200))
