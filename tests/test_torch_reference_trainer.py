"""The port's NumPy oracle trainer (ddt_tpu_torch/reference/numpy_trainer.py)
against tests/test_reference_trainer.py: the same kernel- and
algorithm-level checks, and in every training case the reference
oracle's `fit` on the same binned rows and config, whose trees the
port's must equal bitwise (the port rounds the tie-break's gains to
bf16 in NumPy where the reference uses ml_dtypes).
"""

import numpy as np

from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data.quantizer import quantize as jquantize
from ddt_tpu.reference import numpy_trainer as jref
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import (synthetic_binary,
                                         synthetic_multiclass,
                                         synthetic_regression)
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.reference import numpy_trainer as ref

FIELDS = ("feature", "threshold_bin", "threshold_raw", "is_leaf",
          "leaf_value", "split_gain", "default_left")


def auc(y, score):
    order = np.argsort(score)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    pos = y == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def _fit(X, y, n_bins, with_mapper=False, **kw):
    """The port oracle's fit, held bitwise to the reference oracle's on
    the same binned rows (and mapper)."""
    Xb, mapper = quantize(X, n_bins=n_bins)
    jXb, jmapper = jquantize(X, n_bins=n_bins)
    np.testing.assert_array_equal(Xb, jXb)
    ens = ref.fit(Xb, y, TrainConfig(n_bins=n_bins, backend="cpu", **kw),
                  mapper if with_mapper else None)
    jens = jref.fit(jXb, y, JConfig(n_bins=n_bins, backend="cpu", **kw),
                    jmapper if with_mapper else None)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ens, k), getattr(jens, k),
                                      err_msg=k)
    assert ens.base_score == jens.base_score
    return ens, Xb


def test_histogram_mass_conservation():
    rng = np.random.default_rng(0)
    R, F, B, N = 1000, 4, 16, 4
    Xb = rng.integers(0, B, (R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    node_index = rng.integers(-1, N, R).astype(np.int32)
    hist = ref.build_histograms(Xb, g, h, node_index, N, B)
    np.testing.assert_array_equal(
        hist, jref.build_histograms(Xb, g, h, node_index, N, B))
    assert hist.shape == (N, F, B, 2)
    for n in range(N):
        mask = node_index == n
        for f in range(F):
            np.testing.assert_allclose(hist[n, f, :, 0].sum(),
                                       g[mask].sum(), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(hist[n, f, :, 1].sum(),
                                       h[mask].sum(), rtol=1e-4, atol=1e-4)
    for b in range(B):
        mask = (node_index == 1) & (Xb[:, 2] == b)
        np.testing.assert_allclose(hist[1, 2, b, 0], g[mask].sum(),
                                   rtol=1e-4, atol=1e-4)


def test_split_gain_hand_computed():
    lam = 1.0
    hist = np.zeros((1, 1, 3, 2), np.float32)
    hist[0, 0, :, 0] = [-4.0, 1.0, 3.0]
    hist[0, 0, :, 1] = [2.0, 1.0, 2.0]
    gains, feats, bins, _ = ref.best_splits(hist, lam, min_child_weight=0.0)
    g0 = 0.5 * (16 / 3 + 16 / 4)
    g1 = 0.5 * (9 / 4 + 9 / 3)
    assert g0 > g1
    # The returned gain is bf16-rounded: compare at bf16 resolution, and
    # bitwise to the reference's.
    np.testing.assert_allclose(gains[0], g0, rtol=1 / 128)
    assert feats[0] == 0 and bins[0] == 0
    for a, b in zip(ref.best_splits(hist, lam, 0.0),
                    jref.best_splits(hist, lam, 0.0)):
        np.testing.assert_array_equal(a, b)


def test_split_gain_respects_min_child_weight():
    hist = np.zeros((1, 1, 3, 2), np.float32)
    hist[0, 0, :, 0] = [-4.0, 1.0, 3.0]
    hist[0, 0, :, 1] = [0.5, 1.0, 2.0]
    _, _, bins, _ = ref.best_splits(hist, 1.0, min_child_weight=1.0)
    assert bins[0] == 1
    assert jref.best_splits(hist, 1.0, min_child_weight=1.0)[2][0] == 1


def test_last_bin_never_chosen():
    hist = np.ones((1, 2, 4, 2), np.float32)
    _, _, bins, _ = ref.best_splits(hist, 1.0, 0.0)
    assert bins[0] < 3


def test_binary_training_learns():
    X, y = synthetic_binary(4000, seed=0)
    ens, Xb = _fit(X, y, 63, with_mapper=True, n_trees=20, max_depth=4,
                   learning_rate=0.3)
    p = ens.predict(Xb, binned=True)
    assert auc(y, p) > 0.85
    np.testing.assert_allclose(p, ens.predict(X, binned=False), atol=1e-5)


def test_training_reduces_loss_monotonically_early():
    X, y = synthetic_binary(2000, seed=1)
    losses = []
    for t in (1, 5, 15):
        ens, Xb = _fit(X, y, 31, n_trees=t, max_depth=3, learning_rate=0.3)
        p = np.clip(ens.predict(Xb, binned=True), 1e-7, 1 - 1e-7)
        losses.append(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    assert losses[0] > losses[1] > losses[2]


def test_regression_mse():
    X, y = synthetic_regression(3000, seed=2)
    ens, Xb = _fit(X, y, 63, n_trees=30, max_depth=4, loss="mse",
                   learning_rate=0.2)
    pred = ens.predict(Xb, binned=True)
    assert np.mean((pred - y) ** 2) < 0.35 * np.var(y)


def test_multiclass_softmax():
    X, y = synthetic_multiclass(3000, n_features=20, n_classes=5, seed=3)
    ens, Xb = _fit(X, y, 63, n_trees=10, max_depth=4, loss="softmax",
                   n_classes=5, learning_rate=0.3)
    p = ens.predict(Xb, binned=True)
    assert p.shape == (3000, 5)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    assert np.mean(np.argmax(p, axis=1) == y) > 0.8


def test_deterministic():
    X, y = synthetic_binary(1000, seed=4)
    Xb, _ = quantize(X, n_bins=31)
    cfg = TrainConfig(n_trees=5, max_depth=3, n_bins=31, backend="cpu")
    e1 = ref.fit(Xb, y, cfg)
    e2 = ref.fit(Xb, y, cfg)
    assert np.array_equal(e1.feature, e2.feature)
    assert np.array_equal(e1.leaf_value, e2.leaf_value)


def test_ensemble_save_load(tmp_path):
    from ddt_tpu.models.tree import TreeEnsemble as JEnsemble

    X, y = synthetic_binary(500, seed=5)
    ens, _ = _fit(X, y, 31, with_mapper=True, n_trees=3, max_depth=3)
    path = str(tmp_path / "ens.npz")
    ens.save(path)
    ens2 = ens.load(path)
    np.testing.assert_array_equal(ens.feature, ens2.feature)
    np.testing.assert_allclose(ens.predict(X), ens2.predict(X), atol=0)
    # The oracle's model loads in the reference too.
    np.testing.assert_array_equal(JEnsemble.load(path).predict(X),
                                  ens.predict(X))
