"""Learned missing-value directions (missing_policy="learn") in the port,
mirroring tests/test_missing.py against ddt_tpu on the CPU.

NaN rows sit in the reserved top bin; every split scores both default
directions and routes the bin's rows the way it learned. Held bitwise:
the split choice with its direction bit (small-integer histograms, exact
gains), the routing of rows through grown trees (grow_tree's leaf of each
row, the eval-set router apply_tree_pred and the traversal's plain
version against the host oracle), and tree structure against the
reference's trainer on NaN data (same decisions; leaves to 2e-4 as the
reference's own backend-parity test holds them). Quality: on informative
missingness at coarse bins the learned direction beats NaN -> bin 0 on
held-out AUC by more than 0.005, as in the reference.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.reference import numpy_trainer as ref
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_missing
from ddt_tpu_torch.data.quantizer import fit_bin_mapper, quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import grad, grow, split
from ddt_tpu_torch.utils.metrics import evaluate
from test_missing import _nan_data


def test_synthetic_missing_is_the_reference_recipe():
    for kw in (dict(), dict(rows=900, f=5, seed=7, frac=0.1),
               dict(rows=500, informative=False)):
        want = _nan_data(**kw)
        got = synthetic_missing(kw.get("rows", 4000), kw.get("f", 8),
                                kw.get("seed", 3), kw.get("frac", 0.25),
                                kw.get("informative", True))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_mapper_reserves_top_bin():
    X, _ = synthetic_missing(800)
    m = fit_bin_mapper(X, n_bins=32, missing_policy="learn")
    assert m.missing_bin and m.n_value_bins == 31
    Xb = m.transform(X)
    assert (Xb[np.isnan(X)] == 31).all()
    assert (Xb[~np.isnan(X)] <= 30).all()
    assert (fit_bin_mapper(X, n_bins=32).transform(X)[np.isnan(X)]
            == 0).all()


def test_split_direction_matches_oracle():
    rng = np.random.default_rng(11)
    hist = rng.integers(-6, 7, (4, 5, 16, 2)).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1])
    want = ref.best_splits(hist, 1.0, 1e-3, missing_bin=True)
    got = split.best_splits_impl(torch.from_numpy(hist), 1.0, 1e-3,
                                 missing_bin=True)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_zero_missing_mass_defaults_right():
    rng = np.random.default_rng(5)
    hist = np.abs(rng.standard_normal((3, 4, 8, 2))).astype(np.float32)
    hist[:, :, -1, :] = 0.0              # no mass in the NaN bin
    *_, dl = split.best_splits_impl(torch.from_numpy(hist), 1.0, 1e-3,
                                    missing_bin=True)
    assert not dl.any()


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_parity_with_reference_on_nans(grad_dtype):
    X, y = synthetic_missing(3000)
    kw = dict(n_trees=5, max_depth=4, n_bins=31, missing_policy="learn",
              min_split_gain=1e-3, grad_dtype=grad_dtype)
    a = japi.train(X, y, JConfig(backend="tpu", **kw)).ensemble
    res = api.train(X, y, TrainConfig(device="cpu", **kw))
    b = res.ensemble
    assert b.missing_bin and b.n_bins == 31
    np.testing.assert_array_equal(b.feature, a.feature)
    np.testing.assert_array_equal(b.threshold_bin, a.threshold_bin)
    np.testing.assert_array_equal(b.default_left, a.default_left)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=2e-4,
                               atol=2e-5)
    assert b.default_left.any()          # informative missingness was used
    np.testing.assert_array_equal(b.threshold_raw, a.threshold_raw)


def test_grow_routing_equals_host_traversal_bitwise():
    """Each training row's leaf as grow_tree routes it equals the host
    oracle's traversal of the finished tree, and apply_tree_pred (the
    eval-set router) adds exactly lr * that leaf's value."""
    X, y = synthetic_missing(2500, seed=4)
    Xb, _ = quantize(X, n_bins=31, missing_policy="learn")
    p = (np.float32(y.mean()) - y).astype(np.float32)
    tree = grow.grow_tree(torch.from_numpy(Xb), torch.from_numpy(p),
                          torch.full((len(y),), 0.25), max_depth=4,
                          n_bins=31, reg_lambda=1.0, min_child_weight=1e-3,
                          min_split_gain=0.0, missing_bin=True)
    assert bool(tree.default_left.any())
    ens = empty_ensemble(1, 4, Xb.shape[1], 0.5, 0.0, "logloss",
                         missing_bin=True, n_bins=31)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value",
              "default_left"):
        getattr(ens, k)[0] = getattr(tree, k).numpy()
    leaf = ens._traverse_np(Xb, binned=True)[0]
    np.testing.assert_array_equal(tree.leaf_of_row.numpy(), leaf)
    pred = torch.zeros(len(y))
    grow.apply_tree_pred(torch.from_numpy(Xb), pred, tree.feature,
                         tree.threshold_bin, tree.is_leaf, tree.leaf_value,
                         tree.default_left, max_depth=4, learning_rate=0.5,
                         missing_bin_value=30)
    np.testing.assert_array_equal(
        pred.numpy(), (np.float32(0.5) * ens.leaf_value[0][leaf]))


def test_learned_direction_beats_zero_policy():
    X, y = synthetic_missing(8000, seed=7)
    tr, va = slice(0, 6000), slice(6000, None)
    kw = dict(n_trees=25, max_depth=5, n_bins=8, device="cpu")
    r_learn = api.train(X[tr], y[tr], missing_policy="learn", **kw)
    r_zero = api.train(X[tr], y[tr], missing_policy="zero", **kw)
    auc_learn = evaluate("auc", y[va], api.predict(
        r_learn.ensemble, X[va], mapper=r_learn.mapper, raw=True,
        device="cpu"))
    auc_zero = evaluate("auc", y[va], api.predict(
        r_zero.ensemble, X[va], mapper=r_zero.mapper, raw=True,
        device="cpu"))
    assert auc_learn > auc_zero + 0.005, (auc_learn, auc_zero)


def test_predict_paths_agree_with_nans():
    X, y = synthetic_missing(3000)
    res = api.train(X, y, n_trees=6, max_depth=4, n_bins=31, device="cpu",
                    missing_policy="learn")
    ens, mapper = res.ensemble, res.mapper
    Xb = mapper.transform(X)
    want = ens.predict_raw(Xb, binned=True)
    got = api.predict(ens, Xb, binned=True, raw=True, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        api.predict(ens, X, mapper=mapper, raw=True, device="cpu"), want,
        rtol=1e-6, atol=1e-6)
    # The raw-value path (NaN detected directly, direction honoured).
    np.testing.assert_allclose(ens.predict_raw(X, binned=False), want,
                               rtol=2e-4, atol=2e-4)


def test_checkpoint_resume_preserves_default_left(tmp_path):
    X, y = synthetic_missing(1500)
    Xb, _ = quantize(X, n_bins=31, missing_policy="learn")
    cfg = TrainConfig(n_trees=8, max_depth=4, n_bins=31, device="cpu",
                      missing_policy="learn")
    full = Driver(get_backend(cfg), cfg).fit(Xb, y)
    ck = str(tmp_path / "ck")
    half = cfg.replace(n_trees=4)
    Driver(get_backend(half), half, checkpoint_dir=ck,
           checkpoint_every=2).fit(Xb, y)
    resumed = Driver(get_backend(cfg), cfg, checkpoint_dir=ck).fit(Xb, y)
    for k in ("feature", "threshold_bin", "default_left", "leaf_value"):
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))


def test_missing_policy_validation():
    with pytest.raises(ValueError, match="missing_policy"):
        TrainConfig(missing_policy="nan")
    with pytest.raises(ValueError, match="n_bins >= 3"):
        TrainConfig(missing_policy="learn", n_bins=2)
    assert TrainConfig(missing_policy="learn", n_bins=31) \
        .missing_bin_value == 30
    assert TrainConfig().missing_bin_value == -1
    X, y = synthetic_missing(200)
    m = fit_bin_mapper(X, n_bins=31)   # zero-policy mapper
    with pytest.raises(ValueError, match="same policy"):
        api.train(X, y, n_trees=1, n_bins=31, missing_policy="learn",
                  mapper=m, device="cpu")
    assert grad.base_score_np(y, "logloss") == ref.base_score(y, "logloss")
