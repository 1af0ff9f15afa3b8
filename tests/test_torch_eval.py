"""Eval sets, metrics and early stopping in the port against ddt_tpu on the
CPU.

Host metrics (auc, accuracy, rmse, logloss) equal the reference's bit for
bit (the same numpy code); the device twins agree with the host metrics
to 1e-5 relative (f32 against f64), the binned-rank auc to 5e-5 (its
within-bin tie mass, utils/metrics.DEVICE_AUC_BINS). Against the
reference's trainer on JAX-CPU (backend="tpu", whose eval also runs in
f32 on the device): per-round validation scores within 2e-5 relative and
the same best round, binary and softmax, with early stopping. On the
port itself the eval step inside the fused round (grow_rounds_eval,
eager on the CPU) equals the granular loop's eval_round bit for bit:
the same scores every round and the same trees.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.utils import metrics as jmetrics
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary, synthetic_multiclass
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.utils import metrics

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


class Granular(CUDADevice):
    grow_rounds = None


def _split(X, y, frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    k = int(len(y) * frac)
    return X[idx[k:]], y[idx[k:]], X[idx[:k]], y[idx[:k]]


def _scores(seed=0, R=3000, C=None):
    rng = np.random.default_rng(seed)
    if C:
        return (rng.integers(0, C, R), (2 * rng.standard_normal(
            (R, C))).astype(np.float32))
    y = (rng.random(R) < 0.35).astype(np.int32)
    return y, (rng.standard_normal(R) + y).astype(np.float32)


@pytest.mark.parametrize("name", ["auc", "accuracy", "rmse", "logloss"])
def test_host_metrics_equal_reference(name):
    y, s = _scores(1)
    assert metrics.evaluate(name, y, s) == jmetrics.evaluate(name, y, s)
    if name in ("accuracy", "logloss"):
        yc, sc = _scores(2, C=5)
        assert metrics.evaluate(name, yc, sc) == \
            jmetrics.evaluate(name, yc, sc)


def test_metric_tables_equal_reference():
    assert metrics.GREATER_IS_BETTER == jmetrics.GREATER_IS_BETTER
    assert sorted(metrics.METRICS) == sorted(jmetrics.METRICS)
    for loss in ("logloss", "softmax", "mse"):
        assert metrics.default_metric(loss) == jmetrics.default_metric(loss)
    with pytest.raises(ValueError, match="logloss"):
        metrics.default_metric("huber")
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.evaluate("f1", [0], [0.0])
    assert metrics.DEVICE_AUC_BINS == jmetrics.DEVICE_AUC_BINS


@pytest.mark.parametrize("name,C", [("accuracy", None), ("rmse", None),
                                    ("logloss", None), ("accuracy", 4),
                                    ("logloss", 4)])
def test_device_twins_match_host(name, C):
    y, s = _scores(3, C=C)
    fn = metrics.device_metric(name, n_classes=C or 1)
    got = float(fn(torch.from_numpy(y.astype(np.float32)),
                   torch.from_numpy(s)))
    assert got == pytest.approx(metrics.evaluate(name, y, s), rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_auc_twin_within_bin_tolerance(seed):
    y, s = _scores(seed)
    s[::7] = s[3]                             # tie groups
    got = float(metrics.device_metric("auc")(
        torch.from_numpy(y.astype(np.float32)), torch.from_numpy(s)))
    assert got == pytest.approx(metrics.auc(y, s), abs=5e-5)
    assert metrics.device_metric("auc", n_classes=3) is None


def test_device_auc_degenerate_inputs():
    fn = metrics.device_metric("auc")
    y = torch.ones(50)
    assert np.isnan(float(fn(y, torch.randn(50))))        # one class
    y = torch.tensor([0.0, 1.0] * 25)
    assert float(fn(y, torch.zeros(50))) == 0.5           # all equal


@pytest.mark.parametrize("loss,metric", [("logloss", "logloss"),
                                         ("logloss", "auc"),
                                         ("softmax", "accuracy"),
                                         ("softmax", "logloss")])
def test_eval_history_and_best_round_match_reference(loss, metric):
    if loss == "softmax":
        X, y = synthetic_multiclass(2500, n_features=10, n_classes=3,
                                    seed=4)
    else:
        X, y = synthetic_binary(2500, n_features=10, seed=3)
    Xt, yt, Xv, yv = _split(X, y)
    kw = dict(n_trees=8, max_depth=4, n_bins=63, loss=loss, n_classes=3,
              min_split_gain=1e-3)
    ref = japi.train(Xt, yt, JConfig(backend="tpu", **kw),
                     eval_set=(Xv, yv), eval_metric=metric, log_every=1)
    port = api.train(Xt, yt, TrainConfig(device="cpu", **kw),
                     eval_set=(Xv, yv), eval_metric=metric)
    key = f"valid_{metric}"
    hr = [r[key] for r in ref.history if key in r]
    hp = [r[key] for r in port.history]
    assert len(hp) == len(hr) == 8
    np.testing.assert_allclose(hp, hr, rtol=2e-5, atol=5e-5)
    assert port.best_round == ref.best_round
    raw = port.ensemble.predict_raw(port.mapper.transform(Xv), binned=True)
    assert metrics.evaluate(metric, yv, raw) == pytest.approx(
        hp[-1], rel=1e-5, abs=5e-5)


@pytest.mark.parametrize("loss", ["logloss", "softmax"])
def test_early_stopping_matches_reference(loss):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((600, 6)).astype(np.float32)
    if loss == "softmax":
        y = rng.integers(0, 3, 600)                    # pure noise labels
    else:
        y = (rng.random(600) < 0.5).astype(np.int64)
    Xt, yt, Xv, yv = _split(X, y, frac=0.3, seed=1)
    kw = dict(n_trees=60, max_depth=3, n_bins=31, loss=loss, n_classes=3)
    ref = japi.train(Xt, yt, JConfig(backend="tpu", **kw),
                     eval_set=(Xv, yv), early_stopping_rounds=4)
    port = api.train(Xt, yt, TrainConfig(device="cpu", **kw),
                     eval_set=(Xv, yv), early_stopping_rounds=4)
    C = 3 if loss == "softmax" else 1
    assert port.best_round == ref.best_round
    assert port.ensemble.n_trees == ref.ensemble.n_trees \
        == (port.best_round + 1) * C < 60 * C
    assert len(port.history) == port.best_round + 1 + 4


@pytest.mark.parametrize("sampling", [{}, dict(subsample=0.7,
                                               colsample_bytree=0.6)],
                         ids=["plain", "sampled"])
@pytest.mark.parametrize("case", ["binary-auc", "softmax-logloss",
                                  "int8-accuracy"])
def test_fused_eval_equals_granular_eval_bitwise(case, sampling):
    loss = "softmax" if case.startswith("softmax") else "logloss"
    metric = case.split("-")[1]
    if loss == "softmax":
        X, y = synthetic_multiclass(2000, n_features=8, n_classes=3, seed=2)
    else:
        X, y = synthetic_binary(2000, n_features=8, seed=2)
    Xb, _ = quantize(X, n_bins=31)
    cfg = TrainConfig(n_trees=9, max_depth=3, n_bins=31, device="cpu",
                      loss=loss, n_classes=3, seed=6, fused_block_rounds=4,
                      grad_dtype="int8" if case.startswith("int8")
                      else "f32", **sampling)
    kw = dict(eval_set=(Xb[1500:], y[1500:]), eval_metric=metric,
              early_stopping_rounds=3)
    fd = Driver(get_backend(cfg), cfg)
    gd = Driver(Granular(cfg), cfg)
    fused = fd.fit(Xb[:1500], y[:1500], **kw)
    gran = gd.fit(Xb[:1500], y[:1500], **kw)
    key = f"valid_{metric}"
    assert [r[key] for r in fd.history] == [r[key] for r in gd.history]
    assert fd.best_round == gd.best_round
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(fused, k), getattr(gran, k))


def test_grow_rounds_eval_contract():
    """grow_rounds_eval leaves its inputs alone, and its scores are the
    granular eval_round's after each round."""
    X, y = synthetic_multiclass(1500, n_features=8, n_classes=3, seed=3)
    Xb, _ = quantize(X, n_bins=31)
    cfg = TrainConfig(max_depth=3, n_bins=31, loss="softmax", n_classes=3,
                      device="cpu")
    be = get_backend(cfg)
    data, yd = be.upload(Xb[:1000]), be.upload_labels(y[:1000])
    vdata, vy = be.upload(Xb[1000:]), be.upload_labels(y[1000:])
    pred0 = be.init_pred(yd, 0.0)
    vpred0 = torch.zeros((500, 3))
    trees, pred, losses, vpred, scores = be.grow_rounds_eval(
        data, pred0, yd, 3, vdata, vpred0, vy, "logloss")
    assert not pred0.any() and not vpred0.any()
    assert scores.shape == (3,) and vpred.shape == (500, 3)
    vp = vpred0
    for k in range(3):
        vp, sc = be.eval_round(vdata, vp, list(trees[k]), vy, "logloss")
        assert float(sc) == float(scores[k])
    assert torch.equal(vp, vpred)
    host = be.fetch_rounds(trees, losses, scores)
    np.testing.assert_array_equal(host[2], scores.numpy())


def test_eval_refusals():
    X, y = synthetic_binary(800, n_features=6, seed=1)
    Xb, _ = quantize(X, n_bins=31)
    cfg = TrainConfig(n_trees=3, max_depth=2, n_bins=31, device="cpu")
    d = Driver(get_backend(cfg), cfg)
    with pytest.raises(ValueError, match="eval_set"):
        d.fit(Xb, y, early_stopping_rounds=2)
    with pytest.raises(ValueError, match="unknown metric"):
        d.fit(Xb, y, eval_set=(Xb, y), eval_metric="f1")
    soft = cfg.replace(loss="softmax", n_classes=2)
    with pytest.raises(ValueError, match="binary metric"):
        Driver(get_backend(soft), soft).fit(Xb, y, eval_set=(Xb, y),
                                            eval_metric="auc")
    # A single-class eval set makes auc NaN from round 1.
    with pytest.raises(ValueError, match="NaN since round 1"):
        d.fit(Xb, y, eval_set=(Xb[y == 1], y[y == 1]), eval_metric="auc",
              early_stopping_rounds=2)
    with pytest.raises(TypeError, match="uint8"):
        api.train(Xb, y, n_trees=1, binned=True, device="cpu",
                  eval_set=(X, y))
