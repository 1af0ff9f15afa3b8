"""The port's scikit-learn-style estimators against ddt_tpu's, on the CPU.

Mirrors the estimator cases of tests/test_sample_weight.py and
tests/test_sampling.py on ddt_tpu_torch.sklearn, whose `device`
parameter (default "cuda", the card) stands where the reference's
`backend` does. Every case fits ddt_tpu.sklearn's estimator
(backend="cpu") on the same X, y, weights and eval set, and holds the
wrapper's own logic to it: trees equal except at provable bf16-boundary
ties (tests/tree_compare), equal classes_, predict and
feature_importances_, predict_proba, the score (accuracy, R^2) and the
eval curves within f32 tolerance, equal best_iteration_. The estimators'
scores are also bitwise the port's api on the model they fitted.
"""

import numpy as np
import pytest

from ddt_tpu import sklearn as jsk
from ddt_tpu_torch import api
from ddt_tpu_torch import sklearn as psk
from ddt_tpu_torch.data.datasets import (synthetic_binary,
                                         synthetic_multiclass)
from ddt_tpu_torch.sklearn import DDTClassifier, DDTRegressor
from tree_compare import assert_trees_match_mod_ties


def _fit_both(name: str, X, y, fit_kw: dict | None = None, **params):
    """The port's estimator `name` (device="cpu") and the reference's
    (backend="cpu"), each fitted on the same X, y and fit arguments."""
    fit_kw = fit_kw or {}
    port = getattr(psk, name)(device="cpu", **params).fit(X, y, **fit_kw)
    ref = getattr(jsk, name)(backend="cpu", **params).fit(X, y, **fit_kw)
    return port, ref


def _assert_same_estimator(port, ref, X, y) -> None:
    assert_trees_match_mod_ties(ref.ensemble_, port.ensemble_,
                                port.min_split_gain)
    assert port.n_features_in_ == ref.n_features_in_
    np.testing.assert_array_equal(port.feature_importances_,
                                  ref.feature_importances_)
    assert port.best_iteration_ == ref.best_iteration_
    assert port.evals_result_.keys() == ref.evals_result_.keys()
    for k, curve in ref.evals_result_.items():
        np.testing.assert_allclose(port.evals_result_[k], curve,
                                   rtol=1e-5, atol=1e-6)
    if ref.best_score_ is None:
        assert port.best_score_ is None
    else:
        assert port.best_score_ == pytest.approx(ref.best_score_, abs=1e-6)
    if hasattr(ref, "classes_"):
        np.testing.assert_array_equal(port.classes_, ref.classes_)
        np.testing.assert_allclose(port.predict_proba(X),
                                   ref.predict_proba(X),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(port.predict(X), ref.predict(X))
        assert port.score(X, y) == ref.score(X, y)
    else:
        np.testing.assert_allclose(port.predict(X), ref.predict(X),
                                   rtol=1e-5, atol=1e-5)
        assert port.score(X, y) == pytest.approx(ref.score(X, y), abs=1e-6)


def test_sklearn_sample_weight():
    X, y = synthetic_binary(1500, n_features=8, seed=5)
    w = np.where(y == 1, 5.0, 1.0)          # upweight the positive class
    kw = dict(n_trees=10, max_depth=3, n_bins=31)
    clf, ref = _fit_both("DDTClassifier", X, y, dict(sample_weight=w), **kw)
    clfp, refp = _fit_both("DDTClassifier", X, y, **kw)
    assert clf.predict_proba(X)[:, 1].mean() \
        > clfp.predict_proba(X)[:, 1].mean()
    _assert_same_estimator(clf, ref, X, y)
    _assert_same_estimator(clfp, refp, X, y)


def test_sklearn_classifier_binary():
    X, y = synthetic_binary(4000, n_features=8, seed=3)
    y_lab = np.where(y > 0, "pos", "neg")        # non-integer labels
    clf, ref = _fit_both("DDTClassifier", X, y_lab, n_trees=15,
                         max_depth=4, n_bins=63)
    assert set(clf.classes_) == {"neg", "pos"}
    proba = clf.predict_proba(X)
    assert proba.shape == (len(X), 2)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-5)
    assert clf.score(X, y_lab) > 0.72
    assert clf.feature_importances_.shape == (X.shape[1],)
    assert np.array_equal(clf.feature_importances_,
                          clf.ensemble_.feature_importances())
    # The estimator scores bitwise what api.predict gives on its model.
    want = api.predict(clf.ensemble_, X, mapper=clf.mapper_, device="cpu")
    assert np.array_equal(proba[:, 1], want)
    _assert_same_estimator(clf, ref, X, y_lab)


def test_sklearn_classifier_multiclass_and_regressor():
    X, y = synthetic_multiclass(3000, n_features=6, n_classes=3, seed=2)
    clf, ref = _fit_both("DDTClassifier", X, y + 10, n_trees=8,
                         max_depth=4, n_bins=63)   # offset labels map back
    assert set(clf.classes_) == {10, 11, 12}
    assert clf.ensemble_.loss == "softmax"
    assert clf.score(X, y + 10) > 0.7
    assert clf.predict_proba(X).shape == (len(X), 3)
    _assert_same_estimator(clf, ref, X, y + 10)

    rng = np.random.default_rng(0)
    Xr = rng.standard_normal((3000, 5)).astype(np.float32)
    yr = Xr[:, 0] * 2 - Xr[:, 1] + 0.1 * rng.standard_normal(3000)
    reg, rref = _fit_both("DDTRegressor", Xr, yr, n_trees=30, max_depth=4,
                          n_bins=63)
    assert reg.score(Xr, yr) > 0.8
    want = api.predict(reg.ensemble_, Xr, mapper=reg.mapper_, raw=True,
                       device="cpu")
    assert np.array_equal(reg.predict(Xr), want)
    _assert_same_estimator(reg, rref, Xr, yr)


def test_sklearn_params_protocol():
    clf = DDTClassifier(n_trees=7, max_depth=3, device="cpu")
    p = clf.get_params()
    assert p["n_trees"] == 7 and p["max_depth"] == 3
    assert p["device"] == "cpu"
    assert "backend" not in p
    assert DDTRegressor().get_params()["device"] == "cuda"
    # The reference's parameters, with `backend` as `device` and no
    # run_log (telemetry is not ported).
    ref = jsk.DDTClassifier(n_trees=7, max_depth=3, backend="cpu")
    want = {("device" if k == "backend" else k): v
            for k, v in ref.get_params().items()}
    assert p == want
    clone = DDTClassifier(**p)              # sklearn.clone() equivalent
    assert clone.get_params() == p
    clf.set_params(n_trees=9, device="cuda")
    assert (clf.n_trees, clf.device) == (9, "cuda")
    assert clf._cfg().device == "cuda"
    with pytest.raises(ValueError, match="unknown parameter"):
        clf.set_params(nope=1)
    try:
        from sklearn.base import clone as skclone
    except ImportError:
        return
    c2 = skclone(clf)
    assert c2.get_params() == clf.get_params()


def test_classifier_single_class_raises_at_fit():
    X = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    y = np.ones(50, dtype=np.int64)
    with pytest.raises(ValueError, match="only one class") as port:
        DDTClassifier(n_trees=2, max_depth=2, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="only one class") as ref:
        jsk.DDTClassifier(n_trees=2, max_depth=2, backend="cpu").fit(X, y)
    assert str(port.value) == str(ref.value)


def test_sklearn_facade_eval_attributes():
    X, y = synthetic_binary(3000, n_features=8, seed=3)
    clf, ref = _fit_both(
        "DDTClassifier", X[:2400], y[:2400],
        dict(eval_set=(X[2400:], y[2400:]), eval_metric="auc",
             early_stopping_rounds=8),
        n_trees=12, max_depth=4, n_bins=63)
    assert clf.best_iteration_ is not None
    assert clf.best_score_ == max(clf.evals_result_["auc"])
    assert len(clf.evals_result_["auc"]) >= clf.best_iteration_ + 1
    _assert_same_estimator(clf, ref, X[2400:], y[2400:])
    with pytest.raises(ValueError, match="not present in y"):
        DDTClassifier(n_trees=2, max_depth=2, device="cpu").fit(
            X[:100], y[:100], eval_set=(X[:10], y[:10] + 5))
    clf, ref = _fit_both("DDTClassifier", X[:500], y[:500], n_trees=3,
                         max_depth=3, n_bins=63)
    assert clf.best_iteration_ is None and clf.evals_result_ == {}
    _assert_same_estimator(clf, ref, X[:500], y[:500])
