"""The port's drift observatory and shadow scoring
(ddt_tpu_torch/serve/drift.py) on the CPU, mirroring tests/test_drift.py.

Across packages: the same binned batches go into the port's and the
reference's DriftTracker, as host arrays and (for the port) as tensors
counted by torch.bincount; the window counts must be bitwise equal and
PSI / JS equal to the last bit (the same numpy float64 arithmetic). The
port's drift logs are read back with the reference's report. Models are
trained and saved by the port (device="cpu").
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ddt_tpu.data.quantizer import feature_bincounts as j_bincounts
from ddt_tpu.serve import drift as jdrift
from ddt_tpu.telemetry import report as tele_report
from ddt_tpu.telemetry.events import validate_event as jvalidate
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import feature_bincounts
from ddt_tpu_torch.serve import drift as serve_drift
from ddt_tpu_torch.serve.control import (FleetConfigError, FleetSpec,
                                         build_fleet)
from ddt_tpu_torch.serve.drift import DriftTracker, divergence
from ddt_tpu_torch.serve.metrics import parse_exposition, render_metrics
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog, validate_event

CFG = TrainConfig(device="cpu", n_bins=31)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A champion and a challenger over the same bin space, and a
    reference-less copy of the champion (the artifact format from before
    training captured the bin histogram)."""
    X, y = synthetic_binary(3000, seed=11)
    kw = dict(n_trees=5, max_depth=3, n_bins=31, device="cpu")
    champ = api.train(X, y, **kw)
    chall = api.train(X, y, learning_rate=0.05, **kw)
    td = tmp_path_factory.mktemp("torch_drift_models")
    paths = {"champ": str(td / "champ.npz"), "chall": str(td / "chall.npz"),
             "legacy": str(td / "legacy.npz")}
    champ.save(paths["champ"])
    chall.save(paths["chall"])
    saved_ref = champ.mapper.ref_counts
    champ.mapper.ref_counts = None
    champ.save(paths["legacy"])
    champ.mapper.ref_counts = saved_ref
    return dict(X=X, y=y, champ=champ, chall=chall, paths=paths)


def _fleet(specs, **kw):
    kw.setdefault("device", "cpu")
    return build_fleet(specs, **kw)


# --------------------------------------------------------------------- #
# divergence math, against the reference
# --------------------------------------------------------------------- #
def test_divergence_identical_histograms_score_zero():
    rng = np.random.default_rng(0)
    ref = rng.integers(1, 100, size=(4, 8)).astype(np.int64)
    psi, js = divergence(ref, ref * 3)
    assert psi.shape == js.shape == (4,)
    np.testing.assert_allclose(psi, 0.0, atol=1e-9)
    np.testing.assert_allclose(js, 0.0, atol=1e-9)


def test_divergence_disjoint_histograms_saturate():
    ref = np.zeros((1, 8), np.int64)
    win = np.zeros((1, 8), np.int64)
    ref[0, :4] = 100
    win[0, 4:] = 100
    psi, js = divergence(ref, win)
    assert psi[0] > 1.0
    assert 0.99 < js[0] <= 1.0 + 1e-9
    psi2, js2 = divergence(win, ref)
    np.testing.assert_allclose(js, js2, atol=1e-12)
    np.testing.assert_allclose(psi, psi2, atol=1e-12)


def test_divergence_matches_feature_bincounts_shapes():
    rng = np.random.default_rng(1)
    Xb = rng.integers(0, 16, size=(500, 6)).astype(np.uint8)
    counts = feature_bincounts(Xb, 16)
    assert counts.shape == (6, 16) and counts.sum() == 500 * 6
    psi, _ = divergence(counts, counts)
    np.testing.assert_allclose(psi, 0.0, atol=1e-9)


def test_divergence_is_bitwise_the_reference():
    rng = np.random.default_rng(12)
    ref = rng.integers(0, 500, size=(28, 255)).astype(np.int64)
    win = rng.integers(0, 50, size=(28, 255)).astype(np.int64)
    for a, b in zip(divergence(ref, win), jdrift.divergence(ref, win)):
        np.testing.assert_array_equal(a, b)


def _batches(rng, lo, hi, rows, n_f):
    return rng.integers(lo, hi, size=(rows, n_f)).astype(np.uint8)


def test_trackers_count_and_score_bitwise_the_reference():
    """The same batches into both packages' trackers: every window's
    counts, PSI and JS bitwise equal, the same alert; the port's tracker
    fed tensors (counted by torch.bincount) equals it fed arrays."""
    rng = np.random.default_rng(13)
    ref = j_bincounts(_batches(rng, 0, 200, 8000, 28), 255)
    np.testing.assert_array_equal(
        feature_bincounts(torch.from_numpy(
            _batches(np.random.default_rng(13), 0, 200, 8000, 28)),
            255).numpy(), ref)
    mine_np = DriftTracker(ref, window_s=10.0, min_rows=64)
    mine_t = DriftTracker(ref, window_s=10.0, min_rows=64)
    theirs = jdrift.DriftTracker(ref, window_s=10.0, min_rows=64)
    t = 0.0
    for lo, hi, rows in ((0, 200, 50), (0, 200, 100), (40, 255, 256),
                         (100, 255, 33), (0, 255, 1), (0, 200, 300)):
        Xb = _batches(rng, lo, hi, rows, 28)
        a = mine_np.observe(t, Xb)
        b = mine_t.observe(t, torch.from_numpy(Xb.copy()))
        c = theirs.observe(t, Xb)
        assert a == b == c
        for trk in (mine_np, mine_t):
            np.testing.assert_array_equal(trk._win, theirs._win)
            assert trk.state(t) == theirs.state(t)
            assert trk.per_feature(t) == theirs.per_feature(t)
        t += 0.7
    assert mine_np.take_pending() == theirs.take_pending()


def test_tracker_below_min_rows_reports_none():
    rng = np.random.default_rng(2)
    ref = feature_bincounts(_batches(rng, 0, 8, 2000, 3), 16)
    trk = DriftTracker(ref, min_rows=256)
    assert trk.observe(0.0, _batches(rng, 0, 8, 100, 3)) is None
    st = trk.state(0.0)
    assert st["window_rows"] == 100
    assert st["psi_max"] is None and st["js_max"] is None
    assert trk.per_feature(0.0) is None
    assert not trk.has_pending()


def test_tracker_latched_alert_fires_once_and_rearms():
    rng = np.random.default_rng(3)
    ref = feature_bincounts(_batches(rng, 0, 8, 4000, 3), 16)
    trk = DriftTracker(ref, window_s=10.0, min_rows=64)
    assert trk.observe(0.0, _batches(rng, 0, 8, 300, 3)) is None
    st = trk.state(0.0)
    assert st["psi_max"] is not None and not st["alerting"]
    alert = trk.observe(1.0, _batches(rng, 8, 16, 600, 3))
    assert alert is not None and alert["psi_max"] >= trk.threshold
    assert alert["alerts"] == 1 and "feature" in alert
    for _ in range(5):
        assert trk.observe(1.5, _batches(rng, 8, 16, 200, 3)) is None
    assert trk.state(1.5)["alerting"] is True
    assert trk.state(1.5)["alerts"] == 1
    assert trk.has_pending()
    pend = trk.take_pending()
    assert len(pend) == 1 and pend[0] == alert
    assert not trk.has_pending() and trk.take_pending() == []
    st = trk.state(100.0)
    assert st["window_rows"] == 0 and st["psi_max"] is None
    assert st["alerting"] is False
    alert2 = trk.observe(101.0, _batches(rng, 8, 16, 300, 3))
    assert alert2 is not None and alert2["alerts"] == 2


def test_tracker_ring_rotation_drops_only_expired_slices():
    rng = np.random.default_rng(4)
    ref = feature_bincounts(_batches(rng, 0, 8, 4000, 2), 16)
    trk = DriftTracker(ref, window_s=16.0, min_rows=1)
    trk.observe(0.0, _batches(rng, 0, 8, 100, 2))
    trk.observe(8.0, _batches(rng, 0, 8, 50, 2))
    assert trk.state(8.0)["window_rows"] == 150
    assert trk.state(17.0)["window_rows"] == 50
    assert trk.state(40.0)["window_rows"] == 0


def test_tracker_per_feature_attribution_sorts_worst_first():
    rng = np.random.default_rng(5)
    ref = feature_bincounts(_batches(rng, 0, 8, 4000, 3), 16)
    trk = DriftTracker(ref, min_rows=1)
    Xb = _batches(rng, 0, 8, 500, 3)
    Xb[:, 2] = rng.integers(10, 16, size=500)
    trk.observe(0.0, Xb)
    pf = trk.per_feature(0.0)
    assert [r["feature"] for r in pf][0] == 2
    assert pf[0]["psi"] >= pf[-1]["psi"]
    assert trk.state(0.0)["feature"] == 2


def test_tracker_rejects_malformed_reference():
    with pytest.raises(ValueError, match="n_features"):
        DriftTracker(np.zeros(8, np.int64))


# --------------------------------------------------------------------- #
# reference capture + artifact round trip
# --------------------------------------------------------------------- #
def test_train_captures_reference_and_npz_round_trips(trained):
    mapper = trained["champ"].mapper
    ref = mapper.ref_counts
    assert ref is not None and ref.dtype == np.int64
    assert ref.shape == (mapper.n_features, mapper.n_bins)
    assert ref.sum() == 3000 * mapper.n_features
    np.testing.assert_array_equal(
        api.load_model(trained["paths"]["champ"]).mapper.ref_counts, ref)
    np.testing.assert_array_equal(
        ref, j_bincounts(mapper.transform(trained["X"]), mapper.n_bins))


def test_pre_drift_artifact_loads_with_drift_off(trained):
    assert api.load_model(trained["paths"]["legacy"]).mapper.ref_counts \
        is None
    eng = _fleet([FleetSpec(name="old", ref=trained["paths"]["legacy"])])
    try:
        eng.predict(trained["X"][:4], model="old", timeout=60.0)
        assert "drift_psi_max" not in eng.health()["models"]["old"]
        assert eng.metrics_snapshot()["models"]["old"]["drift"] is None
        dbg = eng.debug_drift()["models"]["old"]
        assert dbg["reference"] is False and "state" not in dbg
    finally:
        eng.close()


def test_drift_required_on_referenceless_artifact_is_config_error(
        trained):
    with pytest.raises(FleetConfigError, match="reference"):
        _fleet([FleetSpec(name="old", ref=trained["paths"]["legacy"],
                          drift=True)])


def test_drift_false_disables_despite_reference(trained):
    eng = _fleet([FleetSpec(name="m", ref=trained["paths"]["champ"],
                            drift=False)])
    try:
        eng.predict(trained["X"][:4], model="m", timeout=60.0)
        assert "drift_psi_max" not in eng.health()["models"]["m"]
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# the fleet end to end
# --------------------------------------------------------------------- #
def test_fleet_drift_surfaces_end_to_end(trained, tmp_path):
    """Shifted traffic on one model lights every surface (event, healthz,
    /metrics, /debug/drift, the reference's report drift) while an
    unshifted control stays quiet; the window counts equal numpy's
    bincount of the rows the model scored, bitwise."""
    path = str(tmp_path / "drift.jsonl")
    eng = _fleet([FleetSpec(name="hot", ref=trained["paths"]["champ"]),
                  FleetSpec(name="cool", ref=trained["paths"]["chall"])],
                 max_wait_ms=5.0, run_log=path)
    X = trained["X"]
    c0 = tele_counters.snapshot()
    shifted = X + 5.0 * np.abs(X).max(axis=0)
    try:
        for i in range(0, 600, 100):
            eng.predict(X[i:i + 100], model="cool", timeout=60.0)
        for i in range(0, 600, 100):
            eng.predict(shifted[i:i + 100], model="hot", timeout=60.0)
        # The observer folds a batch in after its waiters are answered:
        # wait (bounded) for the last one.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and any(
                eng._slots[n].drift._win_rows < 600 for n in ("hot", "cool")):
            time.sleep(0.005)
        h = eng.health()["models"]
        assert h["hot"]["drift_alerting"] is True
        assert h["hot"]["drift_alerts"] == 1
        assert h["hot"]["drift_psi_max"] >= serve_drift.PSI_ALERT
        assert h["hot"]["drift_window_rows"] == 600
        assert h["cool"]["drift_alerting"] is False
        assert h["cool"]["drift_alerts"] == 0
        for name, rows, res in (("hot", shifted[:600], trained["champ"]),
                                ("cool", X[:600], trained["chall"])):
            np.testing.assert_array_equal(
                eng._slots[name].drift._win,
                j_bincounts(res.mapper.transform(rows), 31))
        parsed = parse_exposition(render_metrics(tele_counters.snapshot(),
                                                 eng.metrics_snapshot()))

        def series(name, model):
            return parsed[name][frozenset({("model", model)})]

        assert series("ddt_drift_alerting", "hot") == 1.0
        assert series("ddt_drift_alerting", "cool") == 0.0
        assert series("ddt_drift_model_alerts_total", "hot") == 1.0
        assert series("ddt_drift_psi_max", "hot") >= serve_drift.PSI_ALERT
        assert series("ddt_drift_js_max", "hot") <= 1.0
        for name in ("hot", "cool"):
            assert series("ddt_drift_psi_threshold", name) \
                == serve_drift.PSI_ALERT
        dbg = eng.debug_drift()["models"]["hot"]
        assert dbg["reference"] is True and dbg["state"]["alerting"]
        assert dbg["per_feature"][0]["psi"] >= dbg["per_feature"][-1]["psi"]
        emitted = eng.emit_latency(reset=True)
        assert emitted["hot"]["drift_alerting"] is True
        assert emitted["cool"]["drift_alerting"] is False
        for s in emitted.values():
            validate_event({"event": "serve_latency", "schema": 5,
                            "t": 0.0, "seq": 0, **s})
    finally:
        eng.close()
    assert tele_counters.delta(c0)["drift_alerts"] == 1
    events = tele_report.read_events(path)
    drifts = [e for e in events if e["event"] == "drift"]
    assert len(drifts) == 1 and drifts[0]["model_name"] == "hot"
    assert drifts[0]["psi_max"] >= serve_drift.PSI_ALERT
    summary = tele_report.summarize(events)
    dr = summary["drift"]
    assert dr["models"]["hot"]["alerts"] == 1
    assert dr["models"]["hot"]["alerting"] is True
    assert dr["models"]["cool"]["alerts"] == 0
    rendered = tele_report.render_drift(summary)
    assert "hot" in rendered and "ALERTING" in rendered
    assert "drift:" in tele_report.render(summary)


# --------------------------------------------------------------------- #
# shadow mode
# --------------------------------------------------------------------- #
def _shadow_fleet(trained, **kw):
    return _fleet(
        [FleetSpec(name="champ", ref=trained["paths"]["champ"]),
         FleetSpec(name="chall", ref=trained["paths"]["chall"],
                   shadow_of="champ")], max_wait_ms=5.0, **kw)


def test_shadow_champion_responses_bit_identical_to_shadow_off(trained):
    X = trained["X"]
    eng_off = _fleet([FleetSpec(name="champ",
                                ref=trained["paths"]["champ"])],
                     max_wait_ms=5.0)
    try:
        base = [eng_off.predict(X[i:i + 64], model="champ", timeout=60.0)
                for i in range(0, 512, 64)]
    finally:
        eng_off.close()
    eng_on = _shadow_fleet(trained)
    try:
        shadowed = [eng_on.predict(X[i:i + 64], model="champ",
                                   timeout=60.0)
                    for i in range(0, 512, 64)]
    finally:
        eng_on.close()
    for a, b in zip(base, shadowed):
        np.testing.assert_array_equal(a, b)


def _wait_shadow(eng, done):
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        s = eng.health()["models"]["champ"]["shadow"]
        if done(s):
            return s
        time.sleep(0.01)
    return s


def test_shadow_scores_champion_traffic_off_response_path(trained):
    eng = _shadow_fleet(trained)
    X = trained["X"]
    try:
        eng.n_features_for("chall")
        for i in range(0, 512, 64):
            eng.predict(X[i:i + 64], model="champ", timeout=60.0)
        s = _wait_shadow(eng, lambda s: s["rows"] >= 64
                         and s["mean_abs_diff"] is not None)
        assert s["model"] == "chall" and s["champion"] == "champ"
        assert s["rows"] >= 64 and s["mean_abs_diff"] > 0
        assert s["ms_p50"] is not None and s["errors"] == 0
        assert eng.health()["models"]["chall"]["shadow_of"] == "champ"
        parsed = parse_exposition(render_metrics(
            tele_counters.snapshot(), eng.metrics_snapshot()))
        labels = frozenset({("model", "champ"), ("shadow", "chall")})
        assert parsed["ddt_shadow_scored_rows_total"][labels] >= 64
        assert parsed["ddt_shadow_mean_abs_diff"][labels] > 0
        w = eng.emit_latency(reset=True)["champ"]
        assert w["shadow_model"] == "chall" and w["shadow_rows"] >= 64
        jvalidate({"event": "serve_latency", "schema": 5, "t": 0.0,
                   "seq": 0, **w})
    finally:
        eng.close()


def test_shadow_skips_not_loads_an_evicted_challenger(trained):
    eng = _shadow_fleet(trained, preload=False)
    X = trained["X"]
    try:
        eng.n_features_for("champ")
        for i in range(0, 256, 64):
            eng.predict(X[i:i + 64], model="champ", timeout=60.0)
        s = _wait_shadow(eng, lambda s: s["skipped"] >= 1)
        assert s["skipped"] >= 1 and s["rows"] == 0
        assert s["mean_abs_diff"] is None
        assert eng.health()["models"]["chall"]["resident"] is False
    finally:
        eng.close()


def test_shadow_drop_on_full_never_blocks():
    class _Slot:
        model = None

    sc = serve_drift.ShadowScorer("c", "m", _Slot(), time.monotonic)
    try:
        with sc._cv:                            # freeze the drain
            for _ in range(sc.QUEUE_CAP + 3):
                sc.enqueue(np.zeros((1, 2), np.uint8), [0.0])
            assert sc._dropped == 3
            assert len(sc._q) == sc.QUEUE_CAP
    finally:
        sc.close()
    assert sc.summary()["dropped"] == 3


def test_shadow_topology_validation(trained):
    p = trained["paths"]
    with pytest.raises(FleetConfigError, match="shadow_of"):
        _fleet([FleetSpec(name="a", ref=p["champ"], shadow_of="ghost")])
    with pytest.raises(FleetConfigError, match="chain|shadow"):
        _fleet([FleetSpec(name="a", ref=p["champ"]),
                FleetSpec(name="b", ref=p["chall"], shadow_of="a"),
                FleetSpec(name="c", ref=p["chall"], shadow_of="b")])
    with pytest.raises(FleetConfigError, match="challenger"):
        _fleet([FleetSpec(name="a", ref=p["champ"]),
                FleetSpec(name="b", ref=p["chall"], shadow_of="a"),
                FleetSpec(name="c", ref=p["chall"], shadow_of="a")])


def test_remove_shadowed_champion_refused_until_shadow_goes(trained):
    eng = _shadow_fleet(trained)
    try:
        with pytest.raises(ValueError, match="shadow"):
            eng.remove_model("champ")
        eng.remove_model("chall")
        assert "shadow" not in eng.health()["models"]["champ"]
        eng.remove_model("champ")
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# HTTP
# --------------------------------------------------------------------- #
def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get_raw(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


@pytest.fixture()
def served_drift_fleet(trained):
    from ddt_tpu_torch.serve.http import serve_forever

    eng = _shadow_fleet(trained)
    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(eng,),
                          kwargs=dict(port=0, ready_event=ready),
                          daemon=True)
    th.start()
    assert ready.wait(60)
    yield eng, eng.http_port
    try:
        _post(eng.http_port, "/shutdown", {})
    except OSError:
        pass
    th.join(30)
    assert not th.is_alive()


def _status(port, payload):
    try:
        _post(port, "/models", payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError(f"accepted: {payload}")


def test_http_drift_misconfig_is_structured_400_never_500(
        served_drift_fleet, trained):
    eng, port = served_drift_fleet
    code, body = _status(port, {"action": "add", "name": "old",
                                "ref": trained["paths"]["legacy"],
                                "drift": True})
    assert code == 400 and "reference" in body["error"]
    code, body = _status(port, {"action": "add", "name": "c2",
                                "ref": trained["paths"]["chall"],
                                "shadow_of": "champ"})
    assert code == 400 and "error" in body
    code, _ = _status(port, {"action": "add", "name": "c3",
                             "ref": trained["paths"]["chall"],
                             "shadow_of": "ghost"})
    assert code == 400
    assert set(json.loads(_get_raw(port, "/healthz"))["models"]) \
        == {"champ", "chall"}


def test_http_metrics_read_only_with_drift_enabled(served_drift_fleet,
                                                   trained):
    eng, port = served_drift_fleet
    X = trained["X"]
    shifted = X + 5.0 * np.abs(X).max(axis=0)
    for i in range(0, 600, 100):
        _post(port, "/models/champ/predict",
              {"rows": shifted[i:i + 100].tolist()})
    # The fleet folds a batch into the drift window after its futures
    # settle, so the last fold may trail the responses: wait (with a
    # deadline) until the window holds all 6 batches before reading.
    deadline = time.monotonic() + 30.0
    while json.loads(_get_raw(port, "/debug/drift"))["models"]["champ"][
            "state"]["window_rows"] < 600:
        assert time.monotonic() < deadline, "the drift window never took " \
            "the 6 batches"
        time.sleep(0.01)
    a = _get_raw(port, "/metrics")
    dbg = json.loads(_get_raw(port, "/debug/drift"))
    assert dbg["fleet"] is True
    assert dbg["models"]["champ"]["state"]["alerting"] is True
    b = _get_raw(port, "/metrics")

    def drift_series(text):
        return {k: v for k, v in parse_exposition(text).items()
                if k.startswith("ddt_drift_")}

    da, db = drift_series(a), drift_series(b)
    assert da == db
    assert frozenset({("model", "champ")}) in da["ddt_drift_alerting"]
    emitted = json.loads(_get_raw(port, "/models/champ/stats?emit=1"))
    assert emitted["requests"] == 6


# --------------------------------------------------------------------- #
# the reference's report over port-written logs
# --------------------------------------------------------------------- #
def test_report_drift_degrades_gracefully_on_pre_drift_logs(tmp_path):
    path = str(tmp_path / "old.jsonl")
    with RunLog(path) as rl:
        rl.emit("run_manifest", trainer="driver", backend="cpu",
                loss="logloss", n_trees=2, max_depth=3, rows=10,
                features=4)
        rl.emit("serve_latency", requests=10, p50_ms=1.0, p99_ms=2.0,
                p999_ms=3.0, max_ms=3.0, batches=2, coalesce_mean=5.0,
                coalesce_max=8, queue_depth_max=1, window_s=1.0,
                model_name="old")
        rl.emit("run_end", completed_rounds=0, wallclock_s=0.1)
    summary = tele_report.summarize(tele_report.read_events(path))
    assert summary.get("drift") is None
    with pytest.raises(ValueError, match="drift"):
        tele_report.render_drift(summary)
    rendered = tele_report.render(summary)
    assert "drift:" not in rendered and "run:" in rendered


def test_report_drift_rollup_joins_events_and_windows(tmp_path):
    path = str(tmp_path / "drift.jsonl")
    with RunLog(path) as rl:
        rl.emit("run_manifest", trainer="driver", backend="cpu",
                loss="logloss", n_trees=2, max_depth=3, rows=10,
                features=4)
        rl.emit("serve_latency", requests=600, p50_ms=1.0, p99_ms=2.0,
                p999_ms=3.0, max_ms=3.0, batches=6, coalesce_mean=100.0,
                coalesce_max=100, queue_depth_max=1, window_s=1.0,
                model_name="hot", drift_psi_max=0.9, drift_js_max=0.5,
                drift_alerting=True, shadow_model="ch", shadow_rows=512,
                shadow_mean_abs_diff=0.012, shadow_ms_p50=0.4)
        rl.emit("drift", model_name="hot", psi_max=0.9, js_max=0.5,
                psi_mean=0.4, feature=3, window_rows=600, window_s=300.0,
                threshold=0.25, alerts=1)
        rl.emit("run_end", completed_rounds=0, wallclock_s=0.1)
    summary = tele_report.summarize(tele_report.read_events(path))
    rec = summary["drift"]["models"]["hot"]
    assert rec["alerts"] == 1 and rec["worst_feature"] == 3
    assert rec["worst_psi_max"] == 0.9 and rec["threshold"] == 0.25
    assert rec["shadow"]["model"] == "ch"
    assert rec["shadow"]["mean_abs_diff"] == 0.012
    rendered = tele_report.render_drift(summary)
    assert "hot" in rendered and "ch" in rendered
    json.dumps(summary["drift"])
