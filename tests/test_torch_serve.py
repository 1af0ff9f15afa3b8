"""The port's serving tier (ddt_tpu_torch/serve/) on the CPU, mirroring
tests/test_serve.py at the f32, int8 and int4 tiers.

Models are trained by the port on CUDADevice(device="cpu"); the engine
scores with the plain versions. Timing-sensitive behaviour is made
deterministic with barriers and generous admission windows: the tests
assert structure (who got which rows, which model answered), never wall
time. Every response must equal the port's offline api.predict at the
same tier bitwise (each row's score does not depend on the other rows of
its batch), and the reference's scores at that tier within 1e-5.
"""

import threading
import time

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.ops import predict_lut
from ddt_tpu_torch.serve import ServeEngine
from ddt_tpu_torch.serve.batcher import (MicroBatcher, ShuttingDown,
                                         trace_breakdown)
from ddt_tpu_torch.serve.engine import (ServableModel, bucket_for,
                                        default_buckets,
                                        normalize_quantize)

TIERS = [None, "int8", "int4"]
IMPL = {None: "auto", "int8": "lut", "int4": "lut4"}
CFG = TrainConfig(device="cpu", n_bins=31)


@pytest.fixture(scope="module")
def trained():
    """Two small models (learning rates 0.1 and 0.05 move every leaf),
    and each one's offline scores at every tier."""
    X, y = synthetic_binary(3000, seed=5)
    kw = dict(n_trees=6, max_depth=3, n_bins=31, device="cpu")
    res_a = api.train(X, y, **kw)
    res_b = api.train(X, y, learning_rate=0.05, **kw)
    ref = {}
    for name, res in (("a", res_a), ("b", res_b)):
        for tier in TIERS:
            ref[name, tier] = api.predict(
                _bundle(res), X, cfg=CFG.replace(predict_impl=IMPL[tier]))
    return dict(X=X, res_a=res_a, res_b=res_b, ref=ref)


def _bundle(res):
    return api.ModelBundle(ensemble=res.ensemble, mapper=res.mapper)


def _engine(trained, tier=None, **kw):
    kw.setdefault("max_wait_ms", 25.0)      # deterministic coalescing
    kw.setdefault("max_batch", 64)
    return ServeEngine(_bundle(trained["res_a"]), CFG, quantize=tier, **kw)


def test_bucket_ladder_and_tier_spellings():
    assert default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert default_buckets(48) == (1, 2, 4, 8, 16, 32, 48)
    bs = default_buckets(64)
    assert [bucket_for(n, bs) for n in (1, 3, 64, 999)] == [1, 4, 64, 64]
    assert [normalize_quantize(q) for q in (
        None, False, "f32", True, "lut", "float16", "int4", "lut4")] == [
        None, None, None, "int8", "int8", "int8", "int4", "int4"]
    with pytest.raises(ValueError, match="quantization tier"):
        normalize_quantize("int2")


@pytest.mark.parametrize("tier", TIERS)
def test_concurrent_submitters_coalesce_and_keep_rows_straight(trained,
                                                               tier):
    """16 barrier-released single-row submitters: every response is the
    offline answer for that row, and >= 8 of them shared one dispatch."""
    eng = _engine(trained, tier)
    try:
        X, ref = trained["X"], trained["ref"]["a", tier]
        n = 16
        barrier = threading.Barrier(n)
        got = [None] * n

        def worker(i):
            barrier.wait()
            got[i] = eng.predict(X[i:i + 1], timeout=60.0)[0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_array_equal(np.array(got), ref[:n])
        assert eng.stats.coalesce_max >= 8, eng.stats.snapshot()
        assert eng.health()["predict_impl"] == IMPL[tier].replace(
            "auto", "f32")
    finally:
        eng.close()


@pytest.mark.parametrize("tier", TIERS)
def test_mixed_size_requests_slice_back_positionally(trained, tier):
    eng = _engine(trained, tier)
    try:
        X, ref = trained["X"], trained["ref"]["a", tier]
        spans = [(0, 1), (1, 8), (9, 3), (12, 5), (17, 1), (18, 16)]
        barrier = threading.Barrier(len(spans))
        got = [None] * len(spans)

        def worker(k, start, cnt):
            barrier.wait()
            got[k] = eng.predict(X[start:start + cnt], timeout=60.0)

        threads = [threading.Thread(target=worker, args=(k, s, c))
                   for k, (s, c) in enumerate(spans)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for k, (s, c) in enumerate(spans):
            assert got[k].shape[0] == c
            np.testing.assert_array_equal(got[k], ref[s:s + c])
    finally:
        eng.close()


@pytest.mark.parametrize("tier", TIERS)
def test_engine_matches_the_reference_tier(trained, tier):
    """Float rows, binned with the training mapper inside the engine,
    score as the reference's backend does at the same tier (the
    reference's Pallas kernels in interpret mode) within 1e-5, and as
    the port's api.predict bitwise."""
    X = trained["X"][:40]
    res = trained["res_a"]
    eng = _engine(trained, tier)
    try:
        out = eng.predict(X.astype(np.float32), timeout=60.0)
    finally:
        eng.close()
    np.testing.assert_array_equal(out, trained["ref"]["a", tier][:40])
    ens_j = JEnsemble.from_dict(res.ensemble.to_dict())
    want = np.asarray(japi.predict(
        ens_j, res.mapper.transform(X), binned=True,
        cfg=JConfig(backend="tpu", n_bins=31,
                    predict_impl=IMPL[tier])))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_dispatch_errors_reach_the_waiter_not_the_thread(trained):
    eng = ServeEngine(
        api.ModelBundle(ensemble=trained["res_a"].ensemble, mapper=None),
        CFG, quantize="int4", max_wait_ms=5.0)
    try:
        with pytest.raises(ValueError, match="bin mapper"):
            eng.predict(np.zeros((1, eng.n_features), np.float32),
                        timeout=60.0)
        Xb = trained["res_a"].mapper.transform(trained["X"][:3])
        np.testing.assert_array_equal(eng.predict(Xb, timeout=60.0),
                                      trained["ref"]["a", "int4"][:3])
    finally:
        eng.close()


def test_submit_validation_and_shutdown(trained):
    eng = _engine(trained, "int8")
    with pytest.raises(ValueError, match="features"):
        eng.predict(np.zeros((1, 3), np.uint8))
    with pytest.raises(ValueError, match=r"\[n, F\]"):
        eng.predict(np.zeros((1, 2, 28), np.uint8))
    eng.close()
    with pytest.raises(ShuttingDown):
        eng.predict_async(np.zeros((1, eng.n_features), np.uint8))


@pytest.mark.parametrize("tier", TIERS)
def test_oversize_request_scores_in_bucket_pieces(trained, tier):
    eng = _engine(trained, tier, max_batch=8, max_wait_ms=1.0)
    try:
        out = eng.predict(trained["X"][:21], timeout=60.0)
        np.testing.assert_array_equal(out, trained["ref"]["a", tier][:21])
    finally:
        eng.close()


def test_dispatch_validates_width_per_request(trained):
    eng = _engine(trained, "int4")
    try:
        F = eng.n_features
        bad = eng._batcher.submit(np.zeros((1, F + 2), np.uint8), 1)
        good = eng.predict_async(
            trained["res_a"].mapper.transform(trained["X"][:1]))
        with pytest.raises(ValueError, match="features"):
            bad.result(timeout=60.0)
        np.testing.assert_array_equal(good.result(timeout=60.0),
                                      trained["ref"]["a", "int4"][:1])
    finally:
        eng.close()


def test_batcher_respects_row_budget():
    batches = []

    def dispatch(batch, depth):
        batches.append([r.n for r in batch])
        for r in batch:
            r.set_result(np.zeros(r.n))

    mb = MicroBatcher(dispatch, max_wait_ms=30.0, max_batch=4)
    reqs = [mb.submit(np.zeros((n, 2)), n) for n in (3, 3, 4, 9)]
    for r in reqs:
        r.result(timeout=30.0)
    mb.close()
    assert [n for b in batches for n in b] == [3, 3, 4, 9]
    for b in batches:
        assert sum(b) <= 4 or (len(b) == 1 and b[0] > 4)


def test_batcher_delivers_a_raising_dispatch_to_every_waiter():
    def dispatch(batch, depth):
        raise RuntimeError("device lost")

    mb = MicroBatcher(dispatch, max_wait_ms=5.0, max_batch=8)
    try:
        reqs = [mb.submit(np.zeros((1, 2)), 1) for _ in range(3)]
        for r in reqs:
            with pytest.raises(RuntimeError, match="device lost"):
                r.result(timeout=30.0)
        assert isinstance(reqs[0].exception(), RuntimeError)
        exp = mb.express(np.zeros((1, 2)), 1)
        with pytest.raises(RuntimeError, match="device lost"):
            exp.result(timeout=30.0)
    finally:
        mb.close()


@pytest.mark.parametrize("tier", TIERS)
def test_hot_swap_mid_flight_returns_old_or_new_never_a_mix(trained, tier):
    """Requests hammer the engine while it swaps A -> B: no failures, and
    every response is model A's offline answer or model B's, for the
    whole block, as the token stamped on the request says."""
    eng = _engine(trained, tier, max_wait_ms=2.0)
    try:
        X = trained["X"]
        refs = {}
        stop = threading.Event()
        results, errors = [], []

        def hammer(tid):
            rng = np.random.default_rng(tid)
            while not stop.is_set():
                s = int(rng.integers(0, 100))
                c = int(rng.integers(1, 6))
                try:
                    req = eng.predict_async(X[s:s + c])
                    out = req.result(timeout=60.0)
                    results.append((s, c, req.model_token, out))
                except Exception as e:  # ddtlint: disable=broad-except — collected and asserted empty below
                    errors.append(repr(e))

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(4)]
        token_a = eng.model_token
        for t in threads:
            t.start()
        while len(results) < 20:
            time.sleep(0.002)
        info = eng.swap(_bundle(trained["res_b"]))
        while len(results) < 60:
            time.sleep(0.002)
        stop.set()
        for t in threads:
            t.join(60)
        assert not errors, errors[:5]
        assert info == {"old": token_a, "new": eng.model_token}
        assert info["old"] != info["new"]
        refs[info["old"]] = trained["ref"]["a", tier]
        refs[info["new"]] = trained["ref"]["b", tier]
        for s, c, token, out in results:
            np.testing.assert_array_equal(out, refs[token][s:s + c])
        assert {r[2] for r in results} == set(refs)
        assert eng.health()["predict_impl"] == IMPL[tier].replace(
            "auto", "f32")
    finally:
        eng.close()


def test_express_lane_at_idle_and_closed_under_load(trained):
    eng = _engine(trained, "int4", max_wait_ms=60_000.0)
    try:
        X, ref = trained["X"], trained["ref"]["a", "int4"]
        # Idle: the lone row never pays the (absurd) admission window.
        np.testing.assert_array_equal(eng.predict(X[:1], timeout=30.0),
                                      ref[:1])
        w = eng.stats.window_summary(reset=True)
        assert w["express"] == 1 and w["requests"] == 1
    finally:
        eng.close()
    eng = _engine(trained, "int4", max_wait_ms=5.0)
    try:
        eng._batcher._gate.acquire()          # a dispatch in flight
        try:
            queued = [eng.predict_async(X[i:i + 1]) for i in range(4)]
        finally:
            eng._batcher._gate.release()
        for i, p in enumerate(queued):
            np.testing.assert_array_equal(p.result(timeout=30.0),
                                          ref[i:i + 1])
        w = eng.stats.window_summary(reset=False)
        assert w["express"] == 0, w           # the lane stayed shut
        assert w["coalesce_max"] > 1          # the backlog coalesced
    finally:
        eng.close()


def test_batcher_deadline_pinned_to_oldest_request_fake_clock():
    fake = {"t": 0.0}
    batches = []

    def dispatch(batch, depth):
        batches.append([r.n for r in batch])
        for r in batch:
            r.set_result(np.zeros(r.n))

    mb = MicroBatcher(dispatch, max_wait_ms=50.0, max_batch=1000,
                      clock=lambda: fake["t"])
    try:
        a = mb.submit(np.zeros((1, 2)), 1)
        trickle = [mb.submit(np.zeros((1, 2)), 1) for _ in range(3)]
        fake["t"] = 0.06
        late = mb.submit(np.zeros((1, 2)), 1)
        for r in [a, late, *trickle]:
            r.result(timeout=10.0)
        assert sum(len(b) for b in batches) == 5
        assert len(batches[0]) >= 4, batches
    finally:
        mb.close()


def test_health_metrics_and_traces(trained):
    eng = _engine(trained, "int4", max_wait_ms=2.0)
    try:
        for i in range(5):
            eng.predict(trained["X"][i:i + 3], timeout=30.0)
        h = eng.health()
        assert h["quantize_tier"] == "int4" and h["quantized"]
        assert h["lut_max_abs_err"] == \
            eng._model.compiled.quantize("int4").max_abs_err > 0
        assert h["requests"] == 5 and h["p50_ms"] <= h["p999_ms"]
        m = eng.metrics_snapshot()["models"]["default"]
        assert m["hist"]["count"] == 5 and sum(m["hist"]["counts"]) == 5
        assert m["backlog_rows"] == 0
        assert eng.stats.window_summary()["requests"] == 5   # unperturbed
        traces = eng.stats.traces_snapshot()
        assert len(traces) == 5 and all(t["total_ms"] >= 0 for t in traces)
        req = eng.predict_async(trained["X"][:2])
        req.result(timeout=30.0)
        assert trace_breakdown(req)["total_ms"] >= 0
    finally:
        eng.close()


def test_carried_tables_seed_the_served_tier(trained):
    """Tables loaded through the npz layout serve as they are; an int4
    request refuses int8 tables."""
    res = trained["res_a"]
    ce = res.ensemble.compile(tree_chunk=64)
    t4 = predict_lut.tables_from_arrays(
        predict_lut.tables_to_arrays(ce.quantize("int4")))
    eng = _engine(trained, "int4")
    try:
        m = ServableModel(_bundle(res), eng.backend, quantize="int4",
                          tables=t4)
        assert m.compiled.quantize("int4") is t4
        assert m.max_abs_err == t4.max_abs_err
        np.testing.assert_array_equal(
            m.score_binned(res.mapper.transform(trained["X"][:9])),
            trained["ref"]["a", "int4"][:9])
        with pytest.raises(ValueError, match="leaf_dtype"):
            ServableModel(_bundle(res), eng.backend, quantize="int4",
                          tables=ce.quantize("float16"))
    finally:
        eng.close()


def test_engine_on_cuda_without_a_card_raises(trained):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the engine would run on it")
    with pytest.raises(RuntimeError, match="is_available"):
        ServeEngine(_bundle(trained["res_a"]), TrainConfig(),
                    quantize="int4")
