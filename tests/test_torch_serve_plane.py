"""The port's serving plane on the CPU: the engine's telemetry, request
traces, the binned=raw wire, `/metrics`, the HTTP front end
(ddt_tpu_torch/serve/http.py), swaps by registry reference, the
registry's artifact events and `python -m ddt_tpu_torch.cli serve`.
Mirrors tests/test_serve.py's telemetry, trace, wire and metrics cases
and tests/test_registry.py's swap-by-reference and run-log cases.

Across packages: the same HTTP requests go to a port server and to a
reference server (ddt_tpu.serve.http on its "cpu" backend) over the same
model file; the status codes and error bodies must be equal and the
scores agree within f32 summation tolerance. The port's `/metrics` text
parses with the reference's parser into the reference's series names and
label sets, and the port's run logs read, summarize and merge through
the reference's report and merge.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.serve import http as jhttp
from ddt_tpu.serve.engine import ServeEngine as JEngine
from ddt_tpu.telemetry import exposition as jexpo
from ddt_tpu.telemetry import merge as tele_merge
from ddt_tpu.telemetry import perfetto
from ddt_tpu.telemetry import report as tele_report
from ddt_tpu.telemetry.events import validate_event as jvalidate
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.registry import RegistryError
from ddt_tpu_torch.registry.loader import load_servable, push_servable
from ddt_tpu_torch.serve.batcher import ShuttingDown, trace_breakdown
from ddt_tpu_torch.serve.engine import ServeEngine
from ddt_tpu_torch.serve.http import (_read_body, _swap, decode_raw_rows,
                                      serve_forever)
from ddt_tpu_torch.serve.metrics import parse_exposition, render_metrics
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog, validate_event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TrainConfig(device="cpu", n_bins=31)
MAX_BATCH = 8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two small port models (learning rates 0.1 and 0.05), their files,
    a registry holding the first at f32 and int4, and offline scores."""
    X, y = synthetic_binary(3000, seed=5)
    kw = dict(n_trees=6, max_depth=3, n_bins=31, device="cpu")
    res_a = api.train(X, y, **kw)
    res_b = api.train(X, y, learning_rate=0.05, **kw)
    td = tmp_path_factory.mktemp("torch_serve_plane")
    paths = {"a": str(td / "a.npz"), "b": str(td / "b.npz")}
    res_a.save(paths["a"])
    res_b.save(paths["b"])
    root = str(td / "reg")
    pushed = push_servable(root, _bundle(res_a), name="higgs",
                           max_batch=MAX_BATCH)
    pushed4 = push_servable(root, _bundle(res_a), name="higgs4",
                            max_batch=MAX_BATCH, quantize="int4")
    ref = {n: api.predict(_bundle(r), X, cfg=CFG)
           for n, r in (("a", res_a), ("b", res_b))}
    return dict(X=X, res_a=res_a, res_b=res_b, paths=paths, root=root,
                pushed=pushed, pushed4=pushed4, ref=ref)


def _bundle(res):
    return api.ModelBundle(ensemble=res.ensemble, mapper=res.mapper)


def _engine(trained, **kw):
    kw.setdefault("max_wait_ms", 25.0)
    kw.setdefault("max_batch", 64)
    return ServeEngine(_bundle(trained["res_a"]), CFG, **kw)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------------------- #
# swaps, latency windows, the express lane
# --------------------------------------------------------------------- #
def test_swap_emits_counter_and_fault_event(trained):
    rl = RunLog()
    eng = _engine(trained, run_log=rl)
    try:
        c0 = tele_counters.snapshot()
        eng.swap(_bundle(trained["res_b"]))
        assert tele_counters.delta(c0)["serve_hot_swaps"] == 1
        ev = [e for e in rl.events("fault") if e["kind"] == "hot_swap"]
        assert len(ev) == 1
        jvalidate(dict(ev[0]))
    finally:
        eng.close()


def test_serve_latency_event_emits_validates_and_renders(trained, tmp_path):
    """A port log read by the reference's report: the serving section."""
    path = str(tmp_path / "serve.jsonl")
    eng = _engine(trained, run_log=path)
    c0 = tele_counters.snapshot()
    try:
        for i in range(10):
            eng.predict(trained["X"][i:i + 1], timeout=60.0)
        payload = eng.emit_latency()
        assert payload["requests"] == 10
        assert payload["p50_ms"] <= payload["p99_ms"] <= payload["p999_ms"]
        assert payload["predict_impl"] == "f32"
    finally:
        eng.close()
    d = tele_counters.delta(c0)
    assert d["serve_requests"] == 10 and d["serve_batches"] >= 1
    events = tele_report.read_events(path)
    sl = [e for e in events if e["event"] == "serve_latency"]
    assert len(sl) == 1
    summary = tele_report.summarize(events)
    s = summary["serving"]
    assert s["requests"] == 10 and s["windows"] == 1
    assert s["coalesce_max"] >= 1 and s["predict_impl"] == "f32"
    rendered = tele_report.render(summary)
    assert "serving: 10 requests" in rendered and "p99=" in rendered


def test_empty_window_emits_nothing(trained):
    rl = RunLog()
    eng = _engine(trained, run_log=rl)
    try:
        assert eng.emit_latency() is None
        assert rl.events("serve_latency") == []
    finally:
        eng.close()


def test_express_lane_opt_out_and_shutdown(trained):
    eng = _engine(trained, max_wait_ms=2.0, express_lane=False)
    out = eng.predict(trained["X"][:1], timeout=30.0)
    _same(out, trained["ref"]["a"][:1])
    assert eng.stats.window_summary(reset=False)["express"] == 0
    assert eng.health()["express_lane"] is False
    eng.close()
    eng2 = _engine(trained)
    eng2.close()
    with pytest.raises(ShuttingDown):
        eng2.predict_async(np.zeros((1, eng2.n_features), np.uint8))


def test_single_model_healthz_unchanged_pre_slo(trained):
    eng = _engine(trained)
    try:
        h = eng.health()
        assert not any(k.startswith("slo") for k in h)
        assert "backlog_rows" not in h and "resident_models" not in h
        assert h["aot"] is False and h["model_name"] is None
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# the binned=raw wire
# --------------------------------------------------------------------- #
def test_decode_raw_rows_contract():
    body = bytearray(range(12))
    rows = decode_raw_rows(body, 4, 12)
    assert rows.shape == (3, 4) and rows.dtype == np.uint8
    assert rows.flags.writeable            # torch.from_numpy takes it
    np.testing.assert_array_equal(rows.reshape(-1),
                                  np.frombuffer(bytes(body), np.uint8))
    for args in ((body, 4, None), (body, 4, 13), (body, 5, 12),
                 (bytearray(), 4, 0)):
        with pytest.raises(ValueError) as mine:
            decode_raw_rows(*args)
        with pytest.raises(ValueError) as theirs:
            jhttp.decode_raw_rows(bytes(args[0]), *args[1:])
        assert str(mine.value) == str(theirs.value)


def test_read_body_is_one_writable_buffer():
    import io

    buf = _read_body(io.BufferedReader(io.BytesIO(bytes(range(100)))), 28)
    assert isinstance(buf, bytearray) and bytes(buf) == bytes(range(28))
    short = _read_body(io.BufferedReader(io.BytesIO(b"abc")), 10)
    assert bytes(short) == b"abc"
    t = torch.from_numpy(decode_raw_rows(bytearray(8), 4, 8))
    assert t.shape == (2, 4)


def _serve(eng):
    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(eng,),
                          kwargs=dict(port=0, ready_event=ready),
                          daemon=True)
    th.start()
    assert ready.wait(60)
    return th


def _request(port, path, data=None, headers=None, method="GET"):
    """(status, headers, body bytes) of one request, errors included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post_json(port, path, payload, headers=None):
    return _request(port, path, json.dumps(payload).encode(),
                    {"Content-Type": "application/json", **(headers or {})},
                    "POST")


def _shutdown(port, th):
    _post_json(port, "/shutdown", {})
    th.join(30)
    assert not th.is_alive()


def test_binned_raw_wire_parity_with_float_body(trained):
    eng = _engine(trained, max_wait_ms=2.0)
    th = _serve(eng)
    port = eng.http_port
    try:
        X = trained["X"]
        Xb = trained["res_a"].mapper.transform(X[:5])
        code, _, raw = _request(port, "/predict?binned=raw", Xb.tobytes(),
                                {"Content-Type":
                                 "application/octet-stream"}, "POST")
        assert code == 200
        code, _, js = _post_json(port, "/predict",
                                 {"rows": X[:5].tolist()})
        raw, js = json.loads(raw), json.loads(js)
        assert raw["model"] == js["model"]
        _same(raw["scores"], js["scores"])
        _same(np.float32(raw["scores"]), trained["ref"]["a"][:5])
        code, _, body = _request(port, "/predict?binned=raw",
                                 Xb.tobytes()[:-1],
                                 {"Content-Type":
                                  "application/octet-stream"}, "POST")
        assert code == 400 and b"whole number" in body
        code, _, body = _request(port, "/healthz")
        assert json.loads(body)["predict_impl"] == "f32"
    finally:
        _shutdown(port, th)


# --------------------------------------------------------------------- #
# request traces
# --------------------------------------------------------------------- #
def test_trace_breakdown_on_express_and_coalesced_lanes(trained):
    eng = _engine(trained, max_wait_ms=2.0)
    try:
        X = trained["X"]
        p_express = eng.predict_async(X[:1])
        p_express.result(timeout=30.0)
        bd = trace_breakdown(p_express)
        assert set(bd) == {"handler_ms", "queue_ms", "gate_ms",
                           "device_ms", "wake_ms", "total_ms"}
        assert bd["handler_ms"] == 0.0 and bd["device_ms"] > 0.0
        assert bd["total_ms"] >= bd["device_ms"]
        p_batch = eng.predict_async(X[:3])
        p_batch.result(timeout=30.0)
        assert trace_breakdown(p_batch)["total_ms"] > 0.0
        ring = eng.debug_traces()
        assert set(ring) == {"default"}
        ids = [t["trace_id"] for t in ring["default"]]
        assert p_express.trace_id in ids and p_batch.trace_id in ids
        rec = next(t for t in ring["default"]
                   if t["trace_id"] == p_express.trace_id)
        assert rec["express"] is True and rec["rows"] == 1
        assert rec["device_ms"] == bd["device_ms"]
    finally:
        eng.close()


def test_trace_id_propagation_and_opt_out(trained):
    eng = _engine(trained, max_wait_ms=2.0)
    try:
        p = eng.predict_async(trained["X"][:1], trace_id="client-abc-1")
        p.result(timeout=30.0)
        assert p.trace_id == "client-abc-1"
        assert trace_breakdown(p) is not None
    finally:
        eng.close()
    eng2 = _engine(trained, max_wait_ms=2.0, request_traces=False)
    try:
        p = eng2.predict_async(trained["X"][:1], trace_id="client-abc-2")
        _same(p.result(timeout=30.0), trained["ref"]["a"][:1])
        assert p.trace_id == "client-abc-2" and trace_breakdown(p) is None
        q = eng2.predict_async(trained["X"][:3])
        q.result(timeout=30.0)
        assert q.trace_id is None
        assert eng2.debug_traces() == {"default": []}
    finally:
        eng2.close()


def test_serve_trace_flush_emits_validating_event(trained):
    rl = RunLog()
    eng = _engine(trained, max_wait_ms=2.0, run_log=rl)
    try:
        assert eng.flush_traces() == 0
        for i in range(3):
            eng.predict(trained["X"][i:i + 1], timeout=30.0)
        assert eng.flush_traces(reason="on_demand") == 3
        evs = rl.events("serve_trace")
        assert len(evs) == 1
        jvalidate(dict(evs[0]))
        assert evs[0]["count"] == 3 and evs[0]["reason"] == "on_demand"
        assert all(t["total_ms"] >= 0 for t in evs[0]["traces"])
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# /metrics
# --------------------------------------------------------------------- #
def test_metrics_exposition_renders_and_parses(trained):
    eng = _engine(trained, max_wait_ms=2.0)
    try:
        for i in range(5):
            eng.predict(trained["X"][i:i + 1], timeout=30.0)
        text = render_metrics(tele_counters.snapshot(),
                              eng.metrics_snapshot())
        series = parse_exposition(text)
        assert series == jexpo.parse_exposition(text)
        for key, v in tele_counters.snapshot().items():
            assert series[f"ddt_{key}_total"][()] == float(v), key

        def lab(**kw):
            return frozenset(kw.items())

        count = series["ddt_serve_latency_ms_count"][lab(model="default")]
        assert count == 5.0
        buckets = series["ddt_serve_latency_ms_bucket"]
        assert buckets[lab(model="default", le="+Inf")] == count
        vals = [v for _, v in sorted(
            (float(dict(k)["le"]), v) for k, v in buckets.items()
            if dict(k)["le"] != "+Inf")]
        assert vals == sorted(vals)
        assert series["ddt_serve_backlog_rows"][lab(model="default")] == 0
        assert series["ddt_serve_resident_models"][()] == 1.0
        assert "ddt_serve_slo_objective_ms" not in series
    finally:
        eng.close()


def test_metrics_series_and_labels_equal_the_reference(trained):
    """The same traffic through a port engine and a reference engine:
    both /metrics bodies parse (with the reference's parser) into the
    same series names and label sets."""
    X = trained["X"]
    eng = _engine(trained, max_wait_ms=2.0)
    jb = japi.load_model(trained["paths"]["a"])
    jeng = JEngine(jb, JConfig(backend="cpu", n_bins=31), max_wait_ms=2.0,
                   max_batch=64)
    try:
        for e in (eng, jeng):
            for i in range(4):
                e.predict(X[i:i + 1 + i], timeout=30.0)
        from ddt_tpu.serve.metrics import render_metrics as jrender
        from ddt_tpu.telemetry import counters as jcounters

        mine = jexpo.parse_exposition(render_metrics(
            tele_counters.snapshot(), eng.metrics_snapshot()))
        theirs = jexpo.parse_exposition(jrender(
            jcounters.snapshot(), jeng.metrics_snapshot()))
        assert set(mine) == set(theirs)
        assert {k: set(v) for k, v in mine.items()} == \
            {k: set(v) for k, v in theirs.items()}
    finally:
        eng.close()
        jeng.close()


def test_metrics_scrape_is_read_only_vs_stats_emit(trained):
    eng = _engine(trained, max_wait_ms=2.0)
    th = _serve(eng)
    port = eng.http_port

    def get(path):
        code, _, body = _request(port, path)
        assert code == 200
        return body.decode()

    try:
        X = trained["X"]
        code, hdr, _ = _post_json(port, "/predict", {"rows": X[:1].tolist()},
                                  {"X-DDT-Trace-Id": "pin-roundtrip-7"})
        assert code == 200 and hdr["X-DDT-Trace-Id"] == "pin-roundtrip-7"
        segs = dict(kv.split("=") for kv in hdr["X-DDT-Timing"].split(","))
        assert set(segs) == {"handler", "queue", "gate", "device", "wake",
                             "total"}
        for i in range(1, 6):
            assert _post_json(port, "/predict",
                              {"rows": X[i:i + 1].tolist()})[0] == 200
        scrape_a = get("/metrics")
        assert json.loads(get("/stats"))["requests"] == 6
        assert scrape_a == get("/metrics")
        emitted = json.loads(get("/stats?emit=1"))
        assert emitted["requests"] == 6
        jvalidate({"event": "serve_latency", "schema": 5, "t": 0.0,
                   "seq": 0, **emitted})
        assert json.loads(get("/stats"))["requests"] == 0
        series = parse_exposition(get("/metrics"))
        assert series["ddt_serve_latency_ms_count"][
            frozenset({("model", "default")})] == 6.0
        dbg = json.loads(get("/debug/requests"))
        assert "pin-roundtrip-7" in [t["trace_id"]
                                     for t in dbg["models"]["default"]]
    finally:
        _shutdown(port, th)


# --------------------------------------------------------------------- #
# the same requests to a port server and a reference server
# --------------------------------------------------------------------- #
def _cases(trained):
    X = trained["X"]
    Xb = trained["res_a"].mapper.transform(X[:3])
    octet = {"Content-Type": "application/octet-stream"}
    return {
        "json_floats": ("/predict", json.dumps(
            {"rows": X[:3].tolist()}).encode(), {}, "POST"),
        "json_binned": ("/predict", json.dumps(
            {"rows": Xb.tolist(), "binned": True}).encode(), {}, "POST"),
        "raw": ("/predict?binned=raw", Xb.tobytes(), octet, "POST"),
        "raw_ragged": ("/predict?binned=raw", Xb.tobytes()[:-2], octet,
                       "POST"),
        "raw_empty": ("/predict?binned=raw", b"", octet, "POST"),
        "binned_out_of_range": ("/predict", json.dumps(
            {"rows": [[300] * Xb.shape[1]], "binned": True}).encode(), {},
            "POST"),
        "binned_floats": ("/predict", json.dumps(
            {"rows": [[0.5] * Xb.shape[1]], "binned": True}).encode(), {},
            "POST"),
        "wrong_width": ("/predict", json.dumps(
            {"rows": [[0.0, 1.0, 2.0]]}).encode(), {}, "POST"),
        "no_rows_key": ("/predict", json.dumps({"x": 1}).encode(), {},
                        "POST"),
        "bad_json": ("/predict", b"{not json", {}, "POST"),
        "three_dims": ("/predict", json.dumps(
            {"rows": [[[0.0]]]}).encode(), {}, "POST"),
        "routed_path": ("/models/x/predict", json.dumps(
            {"rows": X[:1].tolist()}).encode(), {}, "POST"),
        "routed_header": ("/predict", json.dumps(
            {"rows": X[:1].tolist()}).encode(), {"X-DDT-Model": "x"},
            "POST"),
        "swap_missing_file": ("/swap", json.dumps(
            {"model": "/nonexistent/model.npz"}).encode(), {}, "POST"),
        "swap_no_model_key": ("/swap", b"{}", {}, "POST"),
        "no_route_post": ("/nope", b"{}", {}, "POST"),
        "no_route_get": ("/nope", None, {}, "GET"),
        "models_on_single": ("/models", None, {}, "GET"),
        "debug_drift_on_single": ("/debug/drift", None, {}, "GET"),
    }


CASES = ["json_floats", "json_binned", "raw", "raw_ragged", "raw_empty",
         "binned_out_of_range", "binned_floats", "wrong_width",
         "no_rows_key", "bad_json", "three_dims", "routed_path",
         "routed_header", "swap_missing_file", "swap_no_model_key",
         "no_route_post", "no_route_get", "models_on_single",
         "debug_drift_on_single"]


@pytest.fixture(scope="module")
def both_servers(trained):
    """A port server and a reference server over the same model file."""
    eng = ServeEngine(api.load_model(trained["paths"]["a"]), CFG,
                      max_wait_ms=2.0, max_batch=64)
    jeng = JEngine(japi.load_model(trained["paths"]["a"]),
                   JConfig(backend="cpu", n_bins=31), max_wait_ms=2.0,
                   max_batch=64)
    th = _serve(eng)
    jready = threading.Event()
    jth = threading.Thread(target=jhttp.serve_forever, args=(jeng,),
                           kwargs=dict(port=0, ready_event=jready),
                           daemon=True)
    jth.start()
    assert jready.wait(60)
    yield eng.http_port, jeng.http_port
    _shutdown(eng.http_port, th)
    _shutdown(jeng.http_port, jth)


@pytest.mark.parametrize("case", CASES)
def test_http_status_and_body_equal_the_reference(trained, both_servers,
                                                  case):
    port, jport = both_servers
    path, data, headers, method = _cases(trained)[case]
    code, _, body = _request(port, path, data, headers, method)
    jcode, _, jbody = _request(jport, path, data, headers, method)
    assert code == jcode, (body, jbody)
    mine, theirs = json.loads(body), json.loads(jbody)
    if code == 200:
        assert set(mine) == set(theirs)
        np.testing.assert_allclose(mine["scores"], theirs["scores"],
                                   rtol=1e-5, atol=1e-6)
    else:
        assert mine == theirs


# --------------------------------------------------------------------- #
# the registry: swap by reference, artifact events
# --------------------------------------------------------------------- #
def test_swap_by_registry_reference(trained):
    rl = RunLog()
    eng = ServeEngine(_bundle(trained["res_b"]), CFG, max_wait_ms=5.0,
                      max_batch=MAX_BATCH, run_log=rl)
    try:
        with pytest.raises(ValueError, match="without --registry"):
            _swap(eng, "higgs@1")
        eng.registry_root = trained["root"]
        out = _swap(eng, "higgs@1")
        assert out["artifact_digest"] == trained["pushed"]["digest"]
        assert out["mode"] == "rebuild"
        assert eng.model_token == trained["res_a"].ensemble.cache_token()
        ev = [e for e in rl.events("fault") if e["kind"] == "hot_swap"][-1]
        assert ev["new_artifact"] == trained["pushed"]["digest"]
        assert ev["old_artifact"] is None
        jvalidate(dict(ev))
        loads = [e for e in rl.events("artifact") if e["action"] == "load"]
        assert loads and loads[-1]["digest"] == trained["pushed"]["digest"]
        _same(eng.predict(trained["X"][:3]), trained["ref"]["a"][:3])
        with pytest.raises(RegistryError):
            _swap(eng, "higgs@99")
        # A file path still swaps without the registry.
        assert _swap(eng, trained["paths"]["b"])["new"] == \
            trained["res_b"].ensemble.cache_token()
    finally:
        eng.close()


def test_artifact_events_flow_into_report(trained, tmp_path):
    root = str(tmp_path / "reg")
    log_path = str(tmp_path / "run.jsonl")
    with RunLog(log_path) as rl:
        rl.emit("run_manifest", trainer="driver", backend="cuda",
                loss="logloss", n_trees=6, max_depth=3, rows=100,
                features=8, run_id="feedface0001")
        out = push_servable(root, _bundle(trained["res_a"]), name="m",
                            max_batch=8, run_id="feedface0001", run_log=rl)
        load_servable(root, "m@1", quantize=False, device="cpu",
                      run_log=rl)
        rl.emit("run_end", completed_rounds=6, wallclock_s=0.1)
    summary = tele_report.summarize(tele_report.read_events(log_path))
    r = summary["registry"]
    assert r["pushes"] == 1 and r["loads"] == 1
    assert r["digests"] == [out["digest"]]
    push_ev = next(e for e in r["events"] if e["action"] == "push")
    assert push_ev["name"] == "m" and push_ev["version"] == 1
    assert push_ev["same_run"] is True
    load_ev = next(e for e in r["events"] if e["action"] == "load")
    assert load_ev["mode"] == "rebuild"
    text = tele_report.render(summary)
    assert "registry: 1 push(es), 1 load(s)" in text
    assert out["digest"] in text and "(this run)" in text


def test_load_servable_run_log_path_is_opened_and_closed(trained,
                                                          tmp_path):
    path = str(tmp_path / "load.jsonl")
    rep = load_servable(trained["root"], "higgs4", device="cpu",
                        run_log=path)
    assert rep.mode == "tables-fallback"
    evs = tele_report.read_events(path)
    assert [(e["event"], e["action"], e["mode"]) for e in evs] == [
        ("artifact", "load", "tables-fallback")]


def test_v4_records_validate(tmp_path):
    """Records of the older schemas validate in the port's reader too,
    and a newer schema is refused, as in the reference."""
    for rec in (
            {"event": "serve_latency", "schema": 4, "t": 2.0, "seq": 1,
             "requests": 5, "p50_ms": 1.0, "p99_ms": 2.0},
            {"event": "run_end", "schema": 3, "t": 3.0, "seq": 2,
             "completed_rounds": 2, "wallclock_s": 0.5}):
        validate_event(rec)
        jvalidate(rec)
    with pytest.raises(ValueError, match="newer"):
        validate_event({"event": "run_end", "schema": 6, "t": 0.0,
                        "seq": 0, "completed_rounds": 0,
                        "wallclock_s": 0.0})


def test_v5_serve_log_roundtrips_merge_and_trace(trained, tmp_path):
    """Port serving logs with a manifest merge through the reference's
    merge (two hosts) and export through its Perfetto writer."""
    paths = []
    for host in (0, 1):
        path = str(tmp_path / f"serve{host}.jsonl")
        rl = RunLog(path)
        rl.emit("run_manifest", trainer="serve", backend="cuda",
                loss="logloss", n_trees=6, max_depth=3, rows=0,
                features=28, run_id="cafe00000001", host=host)
        eng = _engine(trained, run_log=rl)
        try:
            for i in range(4):
                eng.predict(trained["X"][i:i + 1], timeout=60.0)
            eng.emit_latency()
        finally:
            eng.close()
        paths.append(path)
    events = tele_merge.merge_paths(paths)
    assert sorted({e["host"] for e in events}) == [0, 1]
    assert tele_report.summarize(events)["serving"]["requests"] == 8
    out = str(tmp_path / "trace.json")
    assert perfetto.write_trace(events, out) > 0
    with open(out, encoding="utf-8") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "serve_latency" in names


# --------------------------------------------------------------------- #
# python -m ddt_tpu_torch.cli serve
# --------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cli(args, timeout=120.0):
    """Start `cli serve` on a free port, wait for /healthz; returns
    (process, port, its first stdout line)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "serve", *args,
         "--port", str(port)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if _request(port, "/healthz")[0] == 200:
                return proc, port, json.loads(line)
        except OSError:
            pass
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    out, err = proc.communicate(timeout=30)
    raise AssertionError(f"cli serve did not come up: {line}{out}{err}")


def _stop_cli(proc, port):
    try:
        _post_json(port, "/shutdown", {})
    finally:
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0


def test_cli_serve_single_model_by_registry_reference(trained, tmp_path):
    log = str(tmp_path / "cli.jsonl")
    proc, port, info = _run_cli(
        ["--registry", trained["root"], "--model", "higgs4@1",
         "--quantized", "int4", "--device", "cpu", "--run-log", log])
    try:
        assert info["mode"] == "tables-fallback"
        assert info["artifact_digest"] == trained["pushed4"]["digest"]
        assert info["device"] == "cpu" and info["max_batch"] == MAX_BATCH
        X = trained["X"]
        code, _, body = _post_json(port, "/predict", {"rows": X[:5].tolist()})
        assert code == 200
        want = api.predict(_bundle(trained["res_a"]), X[:5],
                           cfg=CFG.replace(predict_impl="lut4"))
        _same(np.float32(json.loads(body)["scores"]), want)
        h = json.loads(_request(port, "/healthz")[2])
        assert h["predict_impl"] == "lut4"
        assert _request(port, "/stats?emit=1")[0] == 200
    finally:
        _stop_cli(proc, port)
    kinds = [e["event"] for e in tele_report.read_events(log)]
    assert kinds[0] == "artifact" and "serve_latency" in kinds


def test_cli_serve_fleet_on_the_cpu(trained):
    proc, port, info = _run_cli(
        ["--registry", trained["root"],
         "--models", "higgs@1,higgs4@1:tier=int4", "--max-resident", "1",
         "--device", "cpu"])
    try:
        assert info["fleet"] is True and info["max_resident"] == 1
        X = trained["X"]
        for name, impl in (("higgs", "auto"), ("higgs4", "lut4"),
                           ("higgs", "auto")):
            code, _, body = _post_json(port, f"/models/{name}/predict",
                                       {"rows": X[:4].tolist()})
            assert code == 200
            want = api.predict(_bundle(trained["res_a"]), X[:4],
                               cfg=CFG.replace(predict_impl=impl))
            _same(np.float32(json.loads(body)["scores"]), want)
        h = json.loads(_request(port, "/healthz")[2])
        assert h["evictions"] >= 2 and h["reloads"] >= 1
    finally:
        _stop_cli(proc, port)


def test_cli_serve_device_defaults_to_cuda(trained):
    """`--device` defaults to cuda; without a card that refuses to start
    (on a card the server comes up on it: tests/test_torch_cuda.py)."""
    from ddt_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["serve", "--model", "m.npz"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "ddt_tpu_torch.cli", "serve", "--model",
             trained["paths"]["a"]], capture_output=True, text=True,
            cwd=ROOT, timeout=120)
        assert r.returncode == 1
        assert "--device cpu" in r.stderr, r.stderr


@pytest.mark.parametrize("args, msg", [
    ([], "--model is required"),
    (["--model", "m.npz", "--models", "a@1"], "conflicts"),
    (["--models", "a@1", "--raw"], "per entry"),
    (["--models", "a@1", "--max-batch", "64"], "per entry"),
])
def test_cli_serve_refusals(args, msg, capsys):
    from ddt_tpu_torch.cli import main

    with pytest.raises(SystemExit, match=msg):
        main(["serve", *args])


def test_cli_serve_fleet_boot_errors_exit_cleanly(tmp_path):
    from ddt_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="serve fleet"):
        main(["serve", "--models", "ghost@1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="serve --registry"):
        main(["serve", "--registry", str(tmp_path / "reg"), "--model",
              "ghost@1", "--device", "cpu"])
