"""The port's fleet tier (ddt_tpu_torch/serve/fleet.py, control.py) on the
CPU, mirroring tests/test_fleet.py: multi-model tenancy, weighted deficit
round robin, LRU eviction with reload on request, the control plane, SLO
burn tracking, and the HTTP fleet surface.

Models are trained and saved by the port (device="cpu"); the fleet
scores with the plain versions. Every response must equal the port's
offline api.predict of the model that served it, bitwise (a row's score
does not depend on its batch). The reference's config parser gets the
same strings as the port's and must give equal specs and the same
errors; the port's run logs are read back with the reference's report.
Fairness and eviction use the autostart=False seam and explicit request
order, never sleeps, and every blocking wait has a timeout.

The first two tests hold the port's own fault repaired here: a served
model owns its scoring operands, so six same-tier models on one backend
build none after warm-up, and an evicted model's tables are freed.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from ddt_tpu.serve import control as jcontrol
from ddt_tpu.telemetry import report as tele_report
from ddt_tpu.telemetry.events import validate_event as jvalidate
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.serve.batcher import ShuttingDown
from ddt_tpu_torch.serve.control import (FleetConfigError, FleetSpec,
                                         build_fleet, coerce_spec,
                                         load_fleet_config, make_loader,
                                         parse_models_arg, resolve_specs,
                                         validate_specs)
from ddt_tpu_torch.serve.engine import ServeEngine
from ddt_tpu_torch.serve.fleet import (FleetEngine, ModelUnavailableError,
                                       SloBurnTracker, UnknownModelError)
from ddt_tpu_torch.serve.metrics import parse_exposition, render_metrics
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog, validate_event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TrainConfig(device="cpu", n_bins=31)
#: learning rate of each model (a different rate moves every leaf).
RATES = {"a": 0.1, "b": 0.05, "c": 0.2, "d": 0.15, "e": 0.08, "f": 0.3}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Six small models saved by the port, and each one's offline
    scores."""
    X, y = synthetic_binary(3000, seed=5)
    td = tmp_path_factory.mktemp("torch_fleet_models")
    results, paths, ref = {}, {}, {}
    for name, lr in RATES.items():
        res = api.train(X, y, n_trees=5, max_depth=3, n_bins=31,
                        device="cpu", learning_rate=lr)
        p = str(td / f"{name}.npz")
        res.save(p)
        results[name], paths[name] = res, p
        ref[name] = api.predict(api.ModelBundle(res.ensemble, res.mapper),
                                X, cfg=CFG)
    return dict(X=X, results=results, paths=paths, ref=ref)


def _specs(trained, names=("a", "b"), **overrides):
    return [FleetSpec(name=n, ref=trained["paths"][n],
                      **overrides.get(n, {})) for n in names]


def _fleet(trained, names=("a", "b"), *, overrides=None, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("max_wait_ms", 25.0)
    return build_fleet(_specs(trained, names, **(overrides or {})), **kw)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


class _CountBuilds:
    """Counts CUDADevice._scoring_operands calls (the operand builds) and
    keeps a weak reference to every tensor each one built, by token."""

    def __init__(self, monkeypatch):
        self.n = 0
        self.built: dict[str, list] = {}
        orig = cuda_backend.CUDADevice._scoring_operands

        def counted(be, ce, n_features):
            self.n += 1
            ops, tier = orig(be, ce, n_features)
            self.built.setdefault(ce.token, []).extend(
                weakref.ref(t) for t in _tensors(ops))
            return ops, tier

        monkeypatch.setattr(cuda_backend.CUDADevice, "_scoring_operands",
                            counted)


# --------------------------------------------------------------------- #
# a served model owns its operands (the port fault repaired here)
# --------------------------------------------------------------------- #
def test_six_resident_same_tier_models_build_no_operands(trained,
                                                         monkeypatch):
    """Six same-tier models share one backend and are all resident: after
    warm-up, traffic over all six builds no scoring operands. Scoring
    through the backend's 4-entry cache rebuilt (quantized, packed,
    uploaded) a model's tables on every miss, on the dispatcher."""
    builds = _CountBuilds(monkeypatch)
    names = tuple(RATES)
    eng = _fleet(trained, names, overrides={
        n: {"tier": "int8"} for n in names})
    try:
        backends = {id(eng._slots[n].model.backend) for n in names}
        assert len(backends) == 1, "one shared backend"
        assert len(names) > cuda_backend.CUDADevice.PREDICT_CACHE_MAX
        assert builds.n == len(names)           # one build each, warm-up
        X = trained["X"]
        want = {n: api.predict(
            api.ModelBundle(trained["results"][n].ensemble,
                            trained["results"][n].mapper), X[:8],
            cfg=CFG.replace(predict_impl="lut")) for n in names}
        n0 = builds.n
        ops0 = cuda_backend.operand_builds
        for _ in range(3):
            for n in names:
                _same(eng.predict(X[:8], model=n, timeout=60.0), want[n])
                _same(eng.predict(X[:1], model=n, timeout=60.0),
                      want[n][:1])
        assert builds.n == n0, f"{builds.n - n0} operand builds in traffic"
        assert cuda_backend.operand_builds - ops0 == 0
        assert all(eng._slots[n].model.predict_impl == "lut"
                   for n in names)
    finally:
        eng.close()


def test_evicted_model_frees_its_operands(trained, monkeypatch):
    """After an eviction and a gc, every tensor built to score the evicted
    model is gone: no backend cache holds them, so max_resident bounds
    the tables on the device."""
    builds = _CountBuilds(monkeypatch)
    eng = _fleet(trained, ("a", "b", "c"), max_resident=2,
                 overrides={n: {"tier": "int4"} for n in "abc"})
    try:
        X = trained["X"]
        eng.predict(X[:2], model="a", timeout=60.0)
        eng.predict(X[:2], model="b", timeout=60.0)
        refs = builds.built[eng._slots["b"].model.token]
        assert refs and all(r() is not None for r in refs)
        eng.predict(X[:1], model="a", timeout=60.0)   # b is the coldest
        eng.predict(X[:3], model="c", timeout=60.0)   # evicts b
        h = eng.health()
        assert h["models"]["b"]["resident"] is False
        assert h["models"]["b"]["evictions"] == 1
        gc.collect()
        assert all(r() is None for r in refs), "evicted operands live on"
        # and it reloads on request, bitwise its artifact
        _same(eng.predict(X[:5], model="b", timeout=60.0),
              api.predict(api.ModelBundle(
                  trained["results"]["b"].ensemble,
                  trained["results"]["b"].mapper), X[:5],
                  cfg=CFG.replace(predict_impl="lut4")))
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# config parsing, against the reference's parser
# --------------------------------------------------------------------- #
def _spec_tuple(s):
    return tuple(dataclasses.asdict(s).items())


MODELS_ARGS = [
    "a@prod,b@canary:weight=3,c@v2:tier=int4:max_batch=64:name=tiny",
    "a@prod:slo_p99_ms=5.0,b@canary",
    "m@1:raw=true", "m@1:raw=false", "m@1:raw=0",
    "a@1,b@2:shadow_of=a:drift=false",
    "a@prod,,b@x", "a@prod:weight", "a@prod:bogus=1",
    "a@prod:tier=int2", "a@prod:weight=0", "a@prod:weight=nope",
    "a@prod:max_batch=0", "m@1:raw=bogus", "a@prod:slo_p99_ms=fast",
    "a@prod:slo_p99_ms=-1", "a@1:shadow_of=a", "a@1:drift=maybe",
]


@pytest.mark.parametrize("arg", MODELS_ARGS)
def test_parse_models_arg_equals_the_reference(arg):
    """The same --models string gives equal specs, or the same error
    text, in both packages."""
    try:
        want = [_spec_tuple(s) for s in jcontrol.parse_models_arg(arg)]
    except jcontrol.FleetConfigError as e:
        with pytest.raises(FleetConfigError) as ei:
            parse_models_arg(arg)
        assert str(ei.value) == str(e)
        return
    assert [_spec_tuple(s) for s in parse_models_arg(arg)] == want


def test_parse_models_arg_full_grammar():
    specs = parse_models_arg(
        "a@prod,b@canary:weight=3,c@v2:tier=int4:max_batch=64:name=tiny")
    assert [(s.name, s.ref, s.weight, s.tier, s.max_batch)
            for s in specs] == [
        ("a", "a@prod", 1.0, None, 256),
        ("b", "b@canary", 3.0, None, 256),
        ("tiny", "c@v2", 1.0, "int4", 64),
    ]


@pytest.mark.parametrize("bad, msg", [
    ("a@prod,,b@x", "empty"),
    ("a@prod:weight", "key=value"),
    ("a@prod:bogus=1", "unknown fleet entry key"),
    ("a@prod:tier=int2", "unknown quantization tier"),
    ("a@prod:weight=0", "weight must be > 0"),
    ("a@prod:weight=nope", "could not convert"),
    ("a@prod:max_batch=0", "max_batch must be >= 1"),
])
def test_parse_models_arg_loud_errors(bad, msg):
    with pytest.raises(FleetConfigError, match=msg):
        parse_models_arg(bad)


def test_fleet_config_file_round_trip(tmp_path):
    p = tmp_path / "fleet.json"
    p.write_text(json.dumps({"models": [
        {"name": "a", "ref": "a@prod", "weight": 2},
        {"model": "b@canary", "tier": "int8"},
    ]}))
    specs = validate_specs(load_fleet_config(str(p)))
    assert [(s.name, s.weight, s.tier) for s in specs] == [
        ("a", 2.0, None), ("b", 1.0, "int8")]
    assert [_spec_tuple(s) for s in specs] == [
        _spec_tuple(s) for s in jcontrol.load_fleet_config(str(p))]
    p2 = tmp_path / "bare.json"
    p2.write_text(json.dumps([{"ref": "a@prod"}]))
    assert load_fleet_config(str(p2))[0].name == "a"


@pytest.mark.parametrize("doc, msg", [
    ({"modelz": []}, "unknown top-level key"),
    ({"models": []}, "non-empty list"),
    ({"models": ["x"]}, "must be an object"),
    ({"models": [{"name": "a"}]}, "needs a 'ref'"),
], ids=["topkey", "empty", "scalar-entry", "no-ref"])
def test_fleet_config_file_loud_errors(tmp_path, doc, msg):
    p = tmp_path / "fleet.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(FleetConfigError, match=msg) as ei:
        load_fleet_config(str(p))
    with pytest.raises(jcontrol.FleetConfigError) as ej:
        jcontrol.load_fleet_config(str(p))
    assert str(ei.value) == str(ej.value)


def test_duplicate_names_and_unknown_refs_refused(trained, tmp_path):
    with pytest.raises(FleetConfigError, match="duplicate model name"):
        validate_specs([FleetSpec(name="a", ref="a@1"),
                        FleetSpec(name="a", ref="a@2")])
    with pytest.raises(FleetConfigError, match="not a file"):
        resolve_specs([FleetSpec(name="x", ref="ghost@prod")], None)
    with pytest.raises(FleetConfigError, match="x"):
        resolve_specs([FleetSpec(name="x", ref="ghost@prod")],
                      str(tmp_path / "reg"))
    assert resolve_specs(
        [FleetSpec(name="a", ref=trained["paths"]["a"])], None) == {
        "a": "file"}


def test_default_name_from_path_and_ref(trained):
    assert coerce_spec({"ref": trained["paths"]["a"]}, "t").name == "a"
    assert coerce_spec({"ref": "modelx@prod"}, "t").name == "modelx"


def test_raw_flag_string_spellings_parse_strictly():
    assert parse_models_arg("m@1:raw=true")[0].raw is True
    assert parse_models_arg("m@1:raw=false")[0].raw is False
    assert parse_models_arg("m@1:raw=0")[0].raw is False
    assert coerce_spec({"ref": "m@1", "raw": True}, "t").raw is True
    with pytest.raises(FleetConfigError, match="must be a boolean"):
        parse_models_arg("m@1:raw=bogus")


# --------------------------------------------------------------------- #
# routing, per-model answers
# --------------------------------------------------------------------- #
def test_routes_by_name_and_bit_matches_each_model(trained):
    eng = _fleet(trained, ("a", "b", "c"))
    try:
        X, ref = trained["X"], trained["ref"]
        for name in ("a", "b", "c"):
            _same(eng.predict(X[:9], model=name, timeout=60.0),
                  ref[name][:9])
        with pytest.raises(UnknownModelError) as ei:
            eng.predict(X[:1])
        assert ei.value.known == ["a", "b", "c"]
        with pytest.raises(UnknownModelError):
            eng.predict(X[:1], model="nope")
    finally:
        eng.close()


def test_fleet_scores_match_the_reference_within_f32(trained):
    """The reference's api.predict of each port-saved model (cross-load):
    the port's fleet answers agree within f32 summation tolerance."""
    from ddt_tpu import api as japi
    from ddt_tpu.config import TrainConfig as JConfig

    eng = _fleet(trained, ("a", "b"))
    try:
        X = trained["X"]
        for name in ("a", "b"):
            jb = japi.load_model(trained["paths"][name])
            want = np.asarray(japi.predict(
                jb.ensemble, X[:64], mapper=jb.mapper,
                cfg=JConfig(backend="cpu", n_bins=31)))
            np.testing.assert_allclose(
                eng.predict(X[:64], model=name, timeout=60.0), want,
                rtol=1e-5, atol=1e-6)
    finally:
        eng.close()


def test_single_model_fleet_routes_implicitly(trained):
    eng = _fleet(trained, ("a",))
    try:
        assert eng.default_model == "a"
        _same(eng.predict(trained["X"][:4], timeout=60.0),
              trained["ref"]["a"][:4])
        assert eng.n_features_for() == trained["X"].shape[1]
    finally:
        eng.close()


def test_remove_racing_submit_is_a_loud_404_not_a_hang(trained):
    eng = _fleet(trained, ("a", "b"))
    try:
        orig = eng._ensure_resident
        fired = {"done": False}

        def racy(slot):
            orig(slot)
            if slot.name == "b" and not fired["done"]:
                fired["done"] = True
                eng.remove_model("b")

        eng._ensure_resident = racy
        with pytest.raises(UnknownModelError):
            eng.predict(trained["X"][:2], model="b", timeout=10.0)
        _same(eng.predict(trained["X"][:2], model="a", timeout=60.0),
              trained["ref"]["a"][:2])
    finally:
        eng.close()


def _storm(eng, trained, n, names, rows, timeout):
    X = trained["X"]
    errs, got = [], [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        name = names[i % len(names)]
        barrier.wait(timeout)
        try:
            got[i] = (name, eng.predict(X[i:i + rows], model=name,
                                        timeout=timeout))
        except Exception as e:  # ddtlint: disable=broad-except — collected and asserted empty
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs[:5]
    for i, (name, scores) in enumerate(got):
        _same(scores, trained["ref"][name][i:i + rows])


def test_concurrent_multi_model_storm_bit_matches(trained):
    eng = _fleet(trained, ("a", "b", "c"))
    try:
        _storm(eng, trained, 30, ["a", "b", "c"], 2, 60.0)
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# LRU eviction + reload
# --------------------------------------------------------------------- #
def test_lru_eviction_demotes_coldest_and_reloads_on_request(trained):
    eng = _fleet(trained, ("a", "b", "c"), max_resident=2)
    try:
        X, ref = trained["X"], trained["ref"]
        h = eng.health()
        assert [h["models"][n]["resident"] for n in ("a", "b", "c")] \
            == [True, True, False]
        eng.predict(X[:1], model="a", timeout=60.0)
        _same(eng.predict(X[:3], model="c", timeout=60.0), ref["c"][:3])
        h = eng.health()
        assert h["models"]["b"]["resident"] is False
        assert h["models"]["a"]["resident"] is True
        assert h["models"]["b"]["evictions"] == 1
        _same(eng.predict(X[:5], model="b", timeout=60.0), ref["b"][:5])
        assert eng.health()["models"]["b"]["reloads"] == 1
    finally:
        eng.close()


def test_eviction_reload_under_concurrent_traffic(trained):
    log = RunLog()
    c0 = tele_counters.snapshot()
    eng = _fleet(trained, ("a", "b", "c"), max_resident=2, run_log=log)
    try:
        X, ref = trained["X"], trained["ref"]
        _storm(eng, trained, 36, ["a", "b", "c"], 1, 120.0)
        # The dispatcher settles the over-budget fleet once the queues
        # drain; bounded wait.
        deadline = time.monotonic() + 30.0
        while eng.health()["resident"] > 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        h = eng.health()
        assert h["resident"] <= 2, h
        assert h["evictions"] >= 1, h
        for name in ("a", "b", "c"):
            _same(eng.predict(X[:2], model=name, timeout=120.0),
                  ref[name][:2])
        assert eng.health()["reloads"] >= 1
        d = tele_counters.delta(c0)
        assert d["fleet_evictions"] >= 1 and d["fleet_reloads"] >= 1
        kinds = [e.get("kind") for e in log.events("fault")]
        assert "fleet_eviction" in kinds and "fleet_reload" in kinds
        ev = next(e for e in log.events("fault")
                  if e.get("kind") == "fleet_eviction")
        assert ev["model_name"] in ("a", "b", "c")
        jvalidate(dict(ev))
    finally:
        eng.close()


def test_zero_builds_during_steady_state(trained, monkeypatch):
    """Every model resident and warm: a storm across the fleet runs no
    nvcc build (jit_compiles) and builds no scoring operands."""
    builds = _CountBuilds(monkeypatch)
    eng = _fleet(trained, ("a", "b"))
    try:
        X = trained["X"]
        for name in ("a", "b"):
            eng.predict(X[:1], model=name, timeout=60.0)
            eng.predict(X[:8], model=name, timeout=60.0)
        c0 = tele_counters.snapshot()
        n0 = builds.n
        for i in range(10):
            eng.predict(X[i:i + 1], model="a", timeout=60.0)
            eng.predict(X[i:i + 8], model="b", timeout=60.0)
        assert tele_counters.delta(c0)["jit_compiles"] == 0
        assert builds.n == n0
    finally:
        eng.close()


def _flaky_loader(message):
    loader = make_loader(None, "cpu")
    broken = {"on": False}

    def flaky(spec):
        if broken["on"]:
            raise OSError(message)
        return loader(spec)

    return flaky, broken


def test_reload_failure_is_a_structured_unavailable(trained):
    flaky, broken = _flaky_loader("artifact store unreachable")
    eng = FleetEngine(_specs(trained, ("a", "b")), flaky,
                      max_wait_ms=25.0, max_resident=1)
    try:
        X = trained["X"]
        eng.predict(X[:1], model="a", timeout=60.0)
        broken["on"] = True
        with pytest.raises(ModelUnavailableError, match="unreachable"):
            eng.predict(X[:1], model="b", timeout=60.0)
        assert eng.health()["models"]["b"]["load_error"]
        broken["on"] = False
        _same(eng.predict(X[:2], model="b", timeout=60.0),
              trained["ref"]["b"][:2])
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# weighted deficit round robin
# --------------------------------------------------------------------- #
def _drain_order(trained, weights, per_model):
    specs = [FleetSpec(name=n, ref=trained["paths"][n], weight=w,
                       max_batch=8) for n, w in weights.items()]
    order = []
    eng = FleetEngine(specs, make_loader(None, "cpu"), max_wait_ms=1.0,
                      express_lane=False,
                      on_dispatch=lambda name, rows:
                      order.append((name, rows)),
                      autostart=False)
    try:
        X = trained["X"]
        reqs = [eng.predict_async(X[:8], model=n)
                for _ in range(per_model) for n in weights]
        eng.start()
        for r in reqs:
            r.result(120.0)
    finally:
        eng.close()
    seen = dict.fromkeys(weights, 0)
    for name, rows in order:
        seen[name] += rows
        if seen[name] >= per_model * 8:
            break
    return seen, order


def test_weighted_dispatch_fairness_under_saturation(trained):
    seen, order = _drain_order(trained, {"a": 1.0, "b": 3.0}, 48)
    ratio = seen["b"] / max(1, seen["a"])
    assert 2.0 <= ratio <= 4.5, (seen, order[:20])


def test_equal_weights_drain_evenly(trained):
    seen, order = _drain_order(trained, {"a": 1.0, "b": 1.0}, 32)
    ratio = seen["b"] / max(1, seen["a"])
    assert 0.5 <= ratio <= 2.0, (seen, order[:20])


def test_express_lane_carries_idle_singles_per_model(trained):
    eng = _fleet(trained, ("a", "b"))
    try:
        X, ref = trained["X"], trained["ref"]
        for i in range(5):
            _same(eng.predict(X[i:i + 1], model="a", timeout=60.0),
                  ref["a"][i:i + 1])
        assert eng.window_summaries()["a"]["express"] >= 4
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# control plane
# --------------------------------------------------------------------- #
def test_add_remove_model_without_restart(trained):
    eng = _fleet(trained, ("a",))
    try:
        X, ref = trained["X"], trained["ref"]
        out = eng.add_model(FleetSpec(name="b", ref=trained["paths"]["b"]))
        assert out["resident"] is True
        _same(eng.predict(X[:3], model="b", timeout=60.0), ref["b"][:3])
        with pytest.raises(ValueError, match="already in the fleet"):
            eng.add_model(FleetSpec(name="b", ref=trained["paths"]["a"]))
        eng.remove_model("b")
        with pytest.raises(UnknownModelError):
            eng.predict(X[:1], model="b")
        with pytest.raises(UnknownModelError):
            eng.remove_model("b")
        _same(eng.predict(X[:2], model="a", timeout=60.0), ref["a"][:2])
    finally:
        eng.close()


def test_add_model_failed_load_rolls_back(trained):
    flaky, broken = _flaky_loader("artifact store unreachable")
    eng = FleetEngine(_specs(trained, ("a",)), flaky, max_wait_ms=25.0)
    try:
        eng.predict(trained["X"][:1], model="a", timeout=60.0)
        broken["on"] = True
        with pytest.raises(ModelUnavailableError):
            eng.add_model(FleetSpec(name="b", ref=trained["paths"]["b"]))
        assert "b" not in eng.health()["models"]
        with pytest.raises(UnknownModelError):
            eng.predict(trained["X"][:1], model="b")
        broken["on"] = False
        out = eng.add_model(FleetSpec(name="b", ref=trained["paths"]["b"]))
        assert out["resident"] is True
        _same(eng.predict(trained["X"][:2], model="b", timeout=60.0),
              trained["ref"]["b"][:2])
    finally:
        eng.close()


def test_fleet_report_tolerates_fault_only_models(trained):
    """The reference's report reads the port's fleet log, plus a
    fault-only member, without crashing."""
    log = RunLog()
    eng = _fleet(trained, ("a", "b"), run_log=log)
    eng.predict(trained["X"][:2], model="a", timeout=60.0)
    eng.close()
    events = [dict(e) for e in log.ring]
    events.append({"event": "fault", "schema": 5, "t": 0.0, "seq": 999,
                   "kind": "fleet_eviction", "model_name": "ghost",
                   "evictions": 1, "reloads": 0})
    for e in events:
        jvalidate(e)
    summary = tele_report.summarize(events)
    assert "ghost" in summary["fleet"]["models"]
    assert "ghost" in tele_report.render_fleet(summary)
    assert "fleet:" in tele_report.render(summary)


def test_retag_hot_swaps_one_model_old_or_new_never_a_mix(trained):
    log = RunLog()
    eng = _fleet(trained, ("a", "b"), run_log=log)
    try:
        X, ref = trained["X"], trained["ref"]
        n = 20
        errs, got = [], [None] * n
        barrier = threading.Barrier(n + 1)

        def worker(i):
            barrier.wait(60)
            try:
                got[i] = eng.predict(X[i:i + 1], model="a",
                                     timeout=60.0)[0]
            except Exception as e:  # ddtlint: disable=broad-except — collected and asserted empty
                errs.append((i, repr(e)))

        def swapper():
            barrier.wait(60)
            eng.retag("a", FleetSpec(name="a", ref=trained["paths"]["c"]))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)] + [threading.Thread(target=swapper)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:5]
        for i, s in enumerate(got):
            assert s == ref["a"][i] or s == ref["c"][i], (i, s)
        _same(eng.predict(X[:4], model="a", timeout=60.0), ref["c"][:4])
        swaps = [e for e in log.events("fault")
                 if e.get("kind") == "hot_swap"]
        assert swaps and swaps[-1]["model_name"] == "a"
        jvalidate(dict(swaps[-1]))
        _same(eng.predict(X[:2], model="b", timeout=60.0), ref["b"][:2])
    finally:
        eng.close()


def test_cli_fleet_rejects_single_model_flags():
    r = subprocess.run(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "serve",
         "--models", "a@prod", "--quantized", "int4"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 1
    assert "per entry" in r.stderr, r.stderr


def test_close_refuses_new_work(trained):
    eng = _fleet(trained, ("a",))
    eng.close()
    with pytest.raises(ShuttingDown):
        eng.predict(trained["X"][:1], model="a")


# --------------------------------------------------------------------- #
# telemetry: per-model serve_latency, the reference's fleet report
# --------------------------------------------------------------------- #
def test_per_model_serve_latency_events_and_fleet_report(trained,
                                                         tmp_path):
    path = str(tmp_path / "fleet.jsonl")
    eng = _fleet(trained, ("a", "b", "c"), max_resident=2, run_log=path)
    X = trained["X"]
    for name in ("a", "b", "c"):
        eng.predict(X[:4], model=name, timeout=60.0)
    emitted = eng.emit_latency(reset=True)
    assert set(emitted) == {"a", "b", "c"}
    for name, s in emitted.items():
        assert s["model_name"] == name and s["requests"] >= 1
        validate_event({"event": "serve_latency", "schema": 5, "t": 0.0,
                        "seq": 0, **s})
    eng.close()
    events = tele_report.read_events(path)
    assert {e["model_name"] for e in events
            if e["event"] == "serve_latency"} == {"a", "b", "c"}
    fl = tele_report.summarize(events)["fleet"]
    assert set(fl["models"]) == {"a", "b", "c"}
    assert fl["evictions"] >= 1
    for m in fl["models"].values():
        assert m["requests"] >= 1 and m["p99_ms"] is not None
    summary = tele_report.summarize(events)
    assert "fleet:" in tele_report.render_fleet(summary)
    assert "fleet:" in tele_report.render(summary)


def test_single_model_logs_have_no_fleet_section(trained, tmp_path):
    path = str(tmp_path / "single.jsonl")
    res = trained["results"]["a"]
    eng = ServeEngine(api.ModelBundle(res.ensemble, res.mapper), CFG,
                      max_wait_ms=25.0, max_batch=32, run_log=path)
    eng.predict(trained["X"][:4], timeout=60.0)
    eng.close()
    summary = tele_report.summarize(tele_report.read_events(path))
    assert summary["fleet"] is None
    with pytest.raises(ValueError, match="no fleet"):
        tele_report.render_fleet(summary)


def test_single_engine_model_name_dimension(trained):
    log = RunLog()
    res_a, res_b = trained["results"]["a"], trained["results"]["b"]
    eng = ServeEngine(api.ModelBundle(res_a.ensemble, res_a.mapper), CFG,
                      max_wait_ms=25.0, max_batch=32, run_log=log,
                      model_name="prod")
    try:
        eng.predict(trained["X"][:2], timeout=60.0)
        assert eng.health()["model_name"] == "prod"
        assert eng.emit_latency(reset=True)["model_name"] == "prod"
        eng.swap(api.ModelBundle(res_b.ensemble, res_b.mapper))
        hs = [e for e in log.events("fault")
              if e.get("kind") == "hot_swap"]
        assert hs and hs[-1]["model_name"] == "prod"
    finally:
        eng.close()


# --------------------------------------------------------------------- #
# HTTP front end
# --------------------------------------------------------------------- #
def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _http_error(fn, *args):
    try:
        fn(*args)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("request was accepted")


def _serve(eng):
    from ddt_tpu_torch.serve.http import serve_forever

    ready = threading.Event()
    th = threading.Thread(target=serve_forever, args=(eng,),
                          kwargs=dict(port=0, ready_event=ready),
                          daemon=True)
    th.start()
    assert ready.wait(60)
    return th


def _stop(port, th):
    try:
        _post(port, "/shutdown", {})
    except OSError:
        pass
    th.join(30)
    assert not th.is_alive()


@pytest.fixture()
def served_fleet(trained):
    eng = _fleet(trained, ("a", "b"))
    th = _serve(eng)
    yield eng, eng.http_port
    _stop(eng.http_port, th)


def test_http_fleet_routing_and_control_plane(served_fleet, trained):
    eng, port = served_fleet
    X, ref = trained["X"], trained["ref"]
    Xb = trained["results"]["a"].mapper.transform(X)
    r = _post(port, "/models/a/predict", {"rows": X[:3].tolist()})
    _same(np.float32(r["scores"]), ref["a"][:3])
    r = _post(port, "/predict", {"rows": X[:3].tolist()},
              headers={"X-DDT-Model": "b"})
    _same(np.float32(r["scores"]), ref["b"][:3])
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/models/a/predict?binned=raw",
        data=Xb[:2].tobytes(),
        headers={"Content-Type": "application/octet-stream"},
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        _same(np.float32(json.loads(resp.read())["scores"]), ref["a"][:2])
    code, body = _http_error(_post, port, "/models/ghost/predict",
                             {"rows": X[:1].tolist()})
    assert code == 404
    assert body["model"] == "ghost" and body["models"] == ["a", "b"]
    code, body = _http_error(_post, port, "/predict",
                             {"rows": X[:1].tolist()})
    assert code == 404 and body["models"] == ["a", "b"]
    models = _get(port, "/models")["models"]
    assert set(models) == {"a", "b"} and models["a"]["resident"] is True
    st = _get(port, "/models/a/stats")
    assert st["model_name"] == "a" and st["requests"] >= 1
    _get(port, "/models/a/stats?emit=1")
    assert _get(port, "/models/b/stats")["requests"] >= 1
    code, body = _http_error(_get, port, "/models/ghost/stats")
    assert code == 404 and body["model"] == "ghost"
    out = _post(port, "/models", {"action": "add", "name": "c",
                                  "ref": trained["paths"]["c"]})
    assert out["resident"] is True
    r = _post(port, "/models/c/predict", {"rows": X[:2].tolist()})
    _same(np.float32(r["scores"]), ref["c"][:2])
    out = _post(port, "/models", {"action": "retag", "name": "c",
                                  "ref": trained["paths"]["b"]})
    assert out["old"] != out["new"]
    r = _post(port, "/models/c/predict", {"rows": X[:2].tolist()})
    _same(np.float32(r["scores"]), ref["b"][:2])
    _post(port, "/models", {"action": "remove", "name": "c"})
    code, _ = _http_error(_post, port, "/models/c/predict",
                          {"rows": X[:1].tolist()})
    assert code == 404
    code, _ = _http_error(_post, port, "/swap",
                          {"model": trained["paths"]["a"]})
    assert code == 400
    h = _get(port, "/healthz")
    assert h["fleet"] is True and set(h["models"]) == {"a", "b"}


def test_http_single_model_rejects_fleet_routing(trained):
    res = trained["results"]["a"]
    eng = ServeEngine(api.ModelBundle(res.ensemble, res.mapper), CFG,
                      max_wait_ms=25.0, max_batch=32)
    th = _serve(eng)
    port = eng.http_port
    try:
        for path, headers in (("/models/x/predict", {}),
                              ("/predict", {"X-DDT-Model": "x"})):
            code, body = _http_error(
                _post, port, path, {"rows": trained["X"][:1].tolist()},
                headers)
            assert code == 404 and body["model"] == "x"
    finally:
        _stop(port, th)


def test_http_reload_failure_is_503(trained):
    flaky, broken = _flaky_loader("store down")
    eng = FleetEngine(_specs(trained, ("a", "b")), flaky,
                      max_wait_ms=25.0, max_resident=1)
    th = _serve(eng)
    port = eng.http_port
    try:
        X = trained["X"]
        _post(port, "/models/a/predict", {"rows": X[:1].tolist()})
        broken["on"] = True
        code, body = _http_error(_post, port, "/models/b/predict",
                                 {"rows": X[:1].tolist()})
        assert code == 503
        assert body["model"] == "b" and "store down" in body["reason"]
        broken["on"] = False
        r = _post(port, "/models/b/predict", {"rows": X[:2].tolist()})
        _same(np.float32(r["scores"]), trained["ref"]["b"][:2])
    finally:
        _stop(port, th)


def test_thread_model_clean_on_the_port_serve_tier():
    """The repo's serve-tier thread and lock analysis (tools/ddtlint
    threadmodel) over the port's serve package: no findings, the fleet
    loop carries the dispatcher role and the shared dispatch body both
    roles."""
    import ast

    from tools.ddtlint import threadmodel

    trees, sources = {}, {}
    for rel in ("ddt_tpu_torch/serve/__init__.py",
                "ddt_tpu_torch/serve/batcher.py",
                "ddt_tpu_torch/serve/engine.py",
                "ddt_tpu_torch/serve/fleet.py",
                "ddt_tpu_torch/serve/control.py",
                "ddt_tpu_torch/serve/http.py",
                "ddt_tpu_torch/serve/metrics.py",
                "ddt_tpu_torch/serve/drift.py"):
        with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
            sources[rel] = f.read()
        trees[rel] = ast.parse(sources[rel])
    m = threadmodel.build(trees, sources)
    assert m.findings == [], [f.render() for f in m.findings]
    loop = m.methods[("ddt_tpu_torch/serve/fleet.py", "FleetEngine",
                      "_loop")]
    assert "dispatcher" in loop.roles
    disp = m.methods[("ddt_tpu_torch/serve/engine.py", "",
                      "dispatch_batch")]
    assert disp.roles == {"dispatcher", "handler"}
    assert ("FleetEngine", "_closed") in m.guarded


# --------------------------------------------------------------------- #
# SLO objectives, burn-rate breaches, traces, /metrics
# --------------------------------------------------------------------- #
def test_slo_spec_grammar_and_loud_rejection():
    specs = parse_models_arg("a@prod:slo_p99_ms=5.0,b@canary")
    assert specs[0].slo_p99_ms == 5.0 and specs[1].slo_p99_ms is None
    assert coerce_spec({"ref": "m@1", "slo_p99_ms": "2.5"},
                       "t").slo_p99_ms == 2.5
    with pytest.raises(FleetConfigError, match="positive number"):
        parse_models_arg("a@prod:slo_p99_ms=fast")
    with pytest.raises(FleetConfigError, match="must be > 0"):
        parse_models_arg("a@prod:slo_p99_ms=-1")
    with pytest.raises(FleetConfigError, match="must be > 0"):
        FleetSpec(name="a", ref="a@1", slo_p99_ms=0.0)


def test_slo_burn_tracker_latching_and_rearm():
    """On a fake clock, the same sequence as the reference's tracker."""
    from ddt_tpu.serve.fleet import SloBurnTracker as JTracker

    for cls in (SloBurnTracker, JTracker):
        trk = cls(10.0)
        assert trk.record(0.0, [20.0] * 5) is None
        assert trk.burn_rates(0.0) == {"30s": None, "300s": None}
        assert not trk.has_pending()
        b = trk.record(1.0, [20.0] * 15)
        assert b == {"burn_rate": 100.0, "objective_ms": 10.0,
                     "window_s": 30.0, "requests": 20}
        assert trk.breaches == 1 and trk.has_pending()
        assert trk.record(2.0, [20.0] * 10) is None and trk.breaches == 1
        assert trk.record(40.0, [1.0] * 50) is None
        assert trk.burn_rates(40.0)["30s"] == 0.0
        assert trk.record(41.0, [20.0] * 50) is not None
        assert trk.breaches == 2
        assert len(trk.take_pending()) == 2 and not trk.has_pending()


def test_fleet_slo_breach_counter_fault_and_trace_flush(trained):
    log = RunLog()
    c0 = tele_counters.snapshot()
    eng = _fleet(trained, ("a", "b"),
                 overrides={"a": {"slo_p99_ms": 0.0001}}, run_log=log)
    try:
        X = trained["X"]
        for i in range(SloBurnTracker.MIN_REQUESTS + 5):
            eng.predict(X[i:i + 1], model="a", timeout=60.0)
        h = eng.health()
        assert tele_counters.delta(c0)["slo_breaches"] == 1
        ha = h["models"]["a"]
        assert ha["slo_p99_ms"] == 0.0001 and ha["slo_breaches"] == 1
        assert ha["slo_burn_rate"]["30s"] >= SloBurnTracker.BREACH_BURN
        assert not any(k.startswith("slo") for k in h["models"]["b"])
        faults = [e for e in log.events("fault")
                  if e.get("kind") == "slo_breach"]
        assert len(faults) == 1
        f = faults[0]
        assert f["model_name"] == "a" and f["objective_ms"] == 0.0001
        assert f["requests"] >= SloBurnTracker.MIN_REQUESTS
        jvalidate(dict(f))
        flushed = [e for e in log.events("serve_trace")
                   if e.get("reason") == "slo_breach"]
        assert flushed and flushed[-1]["model_name"] == "a"
        assert flushed[-1]["count"] == len(flushed[-1]["traces"]) >= 1
        jvalidate(dict(flushed[-1]))
        snap = eng.metrics_snapshot()
        assert snap["models"]["a"]["slo"]["breaches"] == 1
        assert snap["models"]["b"]["slo"] is None
        series = parse_exposition(
            render_metrics(tele_counters.snapshot(), snap))
        ka = frozenset({("model", "a")})
        assert series["ddt_serve_slo_breaches_total"][ka] == 1.0
        assert series["ddt_serve_slo_objective_ms"][ka] == 0.0001
        kw = frozenset({("model", "a"), ("window", "30s")})
        assert series["ddt_serve_slo_burn_rate"][kw] >= 2.0
    finally:
        eng.close()


def test_fleet_healthz_backlog_and_resident_fields(trained):
    eng = _fleet(trained, ("a", "b"))
    try:
        eng.predict(trained["X"][:2], model="a", timeout=60.0)
        h = eng.health()
        assert h["resident_models"] == h["resident"] == 2
        assert h["backlog_rows"] == 0
        for m in h["models"].values():
            assert not any(k.startswith("slo") for k in m)
    finally:
        eng.close()


def test_http_fleet_trace_metrics_and_healthz(served_fleet, trained):
    eng, port = served_fleet
    X = trained["X"]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/models/a/predict",
        data=json.dumps({"rows": X[:1].tolist()}).encode(),
        headers={"Content-Type": "application/json",
                 "X-DDT-Trace-Id": "fleet-pin-42"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        json.loads(r.read())
        assert r.headers["X-DDT-Trace-Id"] == "fleet-pin-42"
        timing = r.headers["X-DDT-Timing"]
    parts = dict(p.split("=") for p in timing.split(","))
    assert set(parts) == {"handler", "queue", "gate", "device", "wake",
                          "total"}
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    series = parse_exposition(text)
    ka = frozenset({("model", "a")})
    assert series["ddt_serve_latency_ms_count"][ka] >= 1
    assert series["ddt_serve_resident_models"][()] == 2
    assert series["ddt_serve_backlog_rows"][ka] == 0
    dbg = _get(port, "/debug/requests")
    assert any(t["trace_id"] == "fleet-pin-42" for t in dbg["models"]["a"])
    h = _get(port, "/healthz")
    assert h["resident_models"] == 2 and h["backlog_rows"] == 0
