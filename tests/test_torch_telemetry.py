"""The port's telemetry modules (ddt_tpu_torch/telemetry/) against the
reference's: the counters' key set and record functions, the exposition
writer and parser, the run-log schema tables, `validate_event`,
`derive_run_id`, and a RunLog's file read back by the reference's reader.
Then the port's own spans (telemetry/annotations): live only while a
torch profiler records, kept in memory on the profiler's clock.
"""

import inspect
import json
import sys
import threading

import numpy as np
import pytest
import torch

from ddt_tpu.telemetry import counters as jcounters
from ddt_tpu.telemetry import events as jevents
from ddt_tpu.telemetry import exposition as jexpo
from ddt_tpu.telemetry import report as tele_report
from ddt_tpu_torch import _build
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.telemetry import annotations, counters, events, exposition


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


# --------------------------------------------------------------------- #
# spans (telemetry/annotations)
# --------------------------------------------------------------------- #

#: The spans a CPU api.train (float rows, an eval set) and api.predict
#: reach: all of the layer boundaries but a mesh's `agree` and the card's
#: `capture`, and the ops' stages.
CPU_SPANS = {"ddt:train", "ddt:edges", "ddt:train.rows", "ddt:upload",
             "ddt:bin", "ddt:train.setup", "ddt:grow_block",
             "ddt:fetch_tree", "ddt:hist", "ddt:gain", "ddt:score",
             "ddt:score.prepare", "ddt:predict", "ddt:score.download",
             "ddt:score.proba"}


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _train_and_score():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1500, 5)).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float32)
    cfg = TrainConfig(device="cpu", n_trees=3, max_depth=3, n_bins=15)
    res = api.train(X, y, cfg, eval_set=(X[:300], y[:300]),
                    early_stopping_rounds=5)
    return api.predict(res.ensemble, X, mapper=res.mapper, cfg=cfg)


def test_spans_are_bare_without_a_profiler():
    annotations.reset_spans()
    assert annotations.traced_scope("train") is annotations._NULL
    assert annotations.phase_ctx(None)("grow_block") is annotations._NULL
    _train_and_score()
    assert annotations.span_totals() == {}
    assert annotations.span_records() == []


def test_profiled_train_and_predict_keep_every_span():
    annotations.reset_spans()
    _, probs = _profiled(_train_and_score)
    assert probs.shape == (1500,)
    totals = annotations.span_totals()
    assert set(totals) == CPU_SPANS
    assert all(n.startswith(annotations.PREFIX) for n in totals)
    assert totals["ddt:train"]["count"] == totals["ddt:score"]["count"] == 1
    recs = annotations.span_records()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.name for r in roots) == ["ddt:score", "ddt:train"]
    kids = {r.id: [] for r in recs}
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            kids[p.id].append(r)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    parent = {r.name: by_id[r.parent].name for r in recs
              if r.parent is not None}
    assert parent["ddt:edges"] == parent["ddt:train.rows"] \
        == parent["ddt:train.setup"] == parent["ddt:grow_block"] \
        == parent["ddt:fetch_tree"] == "ddt:train"
    assert parent["ddt:hist"] == parent["ddt:gain"] == "ddt:grow_block"
    assert parent["ddt:score.proba"] == parent["ddt:score.download"] \
        == parent["ddt:predict"] == "ddt:score"
    assert {by_id[r.parent].name for r in recs if r.name == "ddt:bin"} \
        == {"ddt:train.rows", "ddt:score"}
    # Per name: the records' durations, and each duration less its
    # children's; over one root the self times add up to the root.
    for name, t in totals.items():
        mine = [r for r in recs if r.name == name]
        assert t["count"] == len(mine)
        dur = sum(r.end_ns - r.start_ns for r in mine)
        own = sum(r.end_ns - r.start_ns
                  - sum(k.end_ns - k.start_ns for k in kids[r.id])
                  for r in mine)
        assert t["total_s"] == pytest.approx(dur * 1e-9, abs=1e-12)
        assert t["self_s"] == pytest.approx(own * 1e-9, abs=1e-12)
        assert 0 <= t["self_s"] <= t["total_s"]

    def tree_self(r):
        return (r.end_ns - r.start_ns
                - sum(k.end_ns - k.start_ns for k in kids[r.id])
                + sum(tree_self(k) for k in kids[r.id]))
    for r in roots:
        assert tree_self(r) == r.end_ns - r.start_ns


def test_span_records_lie_on_the_profilers_clock():
    annotations.reset_spans()
    prof, _ = _profiled(_train_and_score)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(annotations.PREFIX) \
                and not str(ev.device_type()).endswith("CUDA"):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    recs = annotations.span_records()
    assert recs
    for r in recs:
        s, e = min(events[r.name],
                   key=lambda se: abs(se[0] - r.start_ns))
        assert abs(s - r.start_ns) < 1_000_000, r
        assert abs(e - r.end_ns) < 1_000_000, r


def test_threads_do_not_parent_each_others_spans():
    """Spans opened on many threads at once (more than cores, a short
    switch interval): each parent is on its child's thread, and no count
    is lost."""
    annotations.reset_spans()
    n_threads, n_iter = 16, 50
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    # Every thread alive from the first span to the last, so no thread's
    # ident is reused by another.
    gate = threading.Barrier(n_threads, timeout=60)

    def work():
        gate.wait()
        for _ in range(n_iter):
            with annotations.traced_scope("score"):
                with annotations.traced_scope("score.prepare"):
                    pass
        gate.wait()

    try:
        def run():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
        _profiled(run)
    finally:
        sys.setswitchinterval(prev)
    recs = annotations.span_records()
    by_id = {r.id: r for r in recs}
    assert len(recs) == 2 * n_threads * n_iter
    assert len({r.thread for r in recs}) == n_threads
    for r in recs:
        if r.name == "ddt:score":
            assert r.parent is None
        else:
            assert by_id[r.parent].thread == r.thread
            assert by_id[r.parent].name == "ddt:score"
    totals = annotations.span_totals()
    assert totals["ddt:score"]["count"] == n_threads * n_iter
    assert totals["ddt:score.prepare"]["count"] == n_threads * n_iter


def test_span_ring_stays_bounded(monkeypatch):
    monkeypatch.setattr(annotations, "_store", annotations.SpanStore(ring=8))

    def spans():
        for _ in range(20):
            with annotations.traced_scope("bin"):
                pass
    _profiled(spans)
    recs = annotations.span_records()
    assert len(recs) == 8
    assert [r.id for r in recs] == list(range(13, 21))
    assert annotations.span_totals()["ddt:bin"]["count"] == 20
    annotations.reset_spans()
    assert annotations.span_records() == [] \
        and annotations.span_totals() == {}


class _Row:
    """A key_averages() row as the profile readers see it."""

    def __init__(self, key, device, us, user=False):
        self.key = key
        self.device_type = device
        self.self_device_time_total = us
        self.count = 2
        self.is_user_annotation = user


def test_profile_readers_count_no_span_as_device_work():
    """A `ddt:` range the profiler draws on the device's timeline is no
    kernel: `device_rows` (breakdown.profiled's and tasks._profile_share's
    rows) keeps kernels and copies only, whether the row is flagged a user
    annotation or carries the prefix alone; every span of a real profile
    reads as a range."""
    from ddt_tpu_torch.parallel import tasks
    from ddt_tpu_torch.telemetry import profiler

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = [_Row("ddt:score", cuda, 9e5, user=True),
            _Row("ddt:predict", cuda, 8e5),
            _Row("user_range", cuda, 7e5, user=True),
            _Row("Activity Buffer Request", cuda, 5.0),
            _Row("lut_rows_kernel", cuda, 300.0),
            _Row("Memcpy HtoD (Pageable -> Device)", cuda, 200.0),
            _Row("aten::add", cpu, 50.0)]
    assert profiler.device_rows(rows) == [
        ("lut_rows_kernel", 300.0, 2),
        ("Memcpy HtoD (Pageable -> Device)", 200.0, 2)]
    annotations.reset_spans()
    prof, _ = _profiled(_train_and_score)
    spans = [e for e in prof.events()
             if e.name.startswith(annotations.PREFIX)]
    assert {e.name for e in spans} == CPU_SPANS
    assert all(profiler.is_range(e) for e in spans)
    assert all(profiler.is_range(e) for e in prof.key_averages()
               if e.key.startswith(annotations.PREFIX))
    assert not any(profiler.is_range(e) for e in prof.events()
                   if e.name.startswith("aten::"))
    # With spans live, a profile of the CPU path reads no device work.
    share = tasks._profile_share(_train_and_score)
    assert share["device_busy_s"] == 0 and share["top"] == []
