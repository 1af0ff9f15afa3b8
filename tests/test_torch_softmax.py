"""Softmax multiclass training in the port against ddt_tpu on the CPU.

The losses: grad/hess, the mean loss (weighted too) and the base score
against the reference's jax functions and numpy oracle, to 1e-6 (softmax
normalisation and summation order differ by ULPs). Whole runs at the
Covertype shape cut small (synthetic_multiclass, 4 classes, 12 features):
the port's api.train against ddt_tpu.api.train(backend="tpu") on JAX-CPU,
f32 and int8, trees equal except at provable bf16-boundary ties
(tests/tree_compare.py), scores to 1e-5. On the port itself the fused
round (C trees a round, eager on the CPU) equals the granular loop bit for
bit, with bagging and colsample, and api.predict (the traversal's plain
version) equals the host oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.ops import grad as jgrad
from ddt_tpu.reference import numpy_trainer as oracle
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_multiclass
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import grad
from tree_compare import assert_trees_match_mod_ties

C = 4
FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


@pytest.fixture(scope="module")
def data():
    return synthetic_multiclass(3000, n_features=12, n_classes=C, seed=1)


def _pred_y(R=1500, seed=0):
    rng = np.random.default_rng(seed)
    pred = (2 * rng.standard_normal((R, C))).astype(np.float32)
    y = rng.integers(0, C, R).astype(np.int32)
    w = rng.random(R).astype(np.float32)
    return pred, y, w


def test_softmax_grad_hess_matches_reference():
    pred, y, _ = _pred_y()
    gj, hj = jgrad.grad_hess(jnp.asarray(pred), jnp.asarray(y), "softmax")
    gt, ht = grad.grad_hess(torch.from_numpy(pred), torch.from_numpy(y),
                            "softmax")
    assert gt.shape == ht.shape == (len(y), C)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                               atol=1e-6)
    go, ho = oracle.grad_hess(pred, y, "softmax")
    np.testing.assert_allclose(gt.numpy(), go, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), ho, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss", ["softmax", "logloss", "mse"])
def test_mean_loss_matches_reference(loss, weighted):
    pred, y, w = _pred_y(seed=2)
    if loss != "softmax":
        pred, y = pred[:, 0], (y > 1).astype(np.int32)
    v = w if weighted else np.ones(len(y), np.float32)
    want = float(jgrad.mean_loss(jnp.asarray(pred), jnp.asarray(y),
                                 jnp.asarray(v), loss))
    got = float(grad.mean_loss(torch.from_numpy(pred), torch.from_numpy(y),
                               loss, torch.from_numpy(v)))
    assert got == pytest.approx(want, rel=1e-6)
    if not weighted:
        assert float(grad.mean_loss(torch.from_numpy(pred),
                                    torch.from_numpy(y), loss)) \
            == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("loss", ["softmax", "logloss", "mse"])
def test_base_score_matches_reference(loss):
    _, y, w = _pred_y(seed=3)
    if loss != "softmax":
        y = (y > 1).astype(np.int32)
    assert grad.base_score_np(y, loss) == oracle.base_score(y, loss, C)
    assert grad.base_score_np(y, loss, sample_weight=w) == \
        oracle.base_score(y, loss, C, sample_weight=w)
    assert float(grad.base_score(torch.from_numpy(y), loss)) == \
        pytest.approx(float(jgrad.base_score(jnp.asarray(y), loss)),
                      rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_softmax_train_matches_reference(data, grad_dtype):
    X, y = data
    kw = dict(n_trees=6, max_depth=4, n_bins=63, loss="softmax",
              n_classes=C, min_split_gain=1e-3, grad_dtype=grad_dtype)
    ref = japi.train(X, y, JConfig(backend="tpu", **kw))
    port = api.train(X, y, TrainConfig(device="cpu", **kw))
    a, b = ref.ensemble, port.ensemble
    assert b.n_trees == a.n_trees == 6 * C
    assert (b.loss, b.n_classes, b.base_score) == ("softmax", C, 0.0)
    assert_trees_match_mod_ties(a, b, kw["min_split_gain"])
    got = api.predict(b, X, mapper=port.mapper, raw=True, device="cpu")
    assert got.shape == (len(y), C)
    np.testing.assert_allclose(got, a.predict_raw(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b.threshold_raw, a.threshold_raw)


def _granular(cfg, Xb, y):
    be = get_backend(cfg)
    yd = be.upload_labels(y)
    ens = empty_ensemble(cfg.n_trees * C, cfg.max_depth, Xb.shape[1],
                         cfg.learning_rate, 0.0, "softmax", n_classes=C,
                         n_bins=cfg.n_bins)
    return Driver(be, cfg)._fit_granular(be.upload(Xb), yd,
                                         be.init_pred(yd, 0.0), ens)


@pytest.mark.parametrize("sampling", [{}, dict(subsample=0.8,
                                               colsample_bytree=0.6)],
                         ids=["plain", "sampled"])
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_softmax_fused_equals_granular_bitwise(data, grad_dtype, sampling):
    X, y = data
    cfg = TrainConfig(n_trees=5, max_depth=3, n_bins=31, loss="softmax",
                      n_classes=C, device="cpu", seed=9,
                      grad_dtype=grad_dtype, fused_block_rounds=2,
                      **sampling)
    Xb = fit_bin_mapper(X, 31).transform(X)
    fused = Driver(get_backend(cfg), cfg).fit(Xb, y)
    gran = _granular(cfg, Xb, y)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(fused, k), getattr(gran, k),
                                      err_msg=k)


def test_softmax_round_contract(data):
    """grow_rounds returns [K, C, 6, N] trees and an [R, C] pred; the
    class trees of a round share the round's gradients."""
    X, y = data
    cfg = TrainConfig(max_depth=3, n_bins=31, loss="softmax", n_classes=C,
                      device="cpu")
    be = get_backend(cfg)
    Xb = fit_bin_mapper(X, 31).transform(X)
    data_d, yd = be.upload(Xb), be.upload_labels(y)
    pred0 = be.init_pred(yd, 0.0)
    assert pred0.shape == (len(y), C) and not pred0.any()
    trees, pred, losses = be.grow_rounds(data_d, pred0, yd, 2)
    assert trees.shape == (2, C, 6, 15) and pred.shape == (len(y), C)
    g, h = be.grad_hess(pred0, yd)
    p = pred0
    for c in range(C):
        handle, delta = be.grow_tree(data_d, g[:, c], h[:, c], tree_id=c)
        assert torch.equal(handle, trees[0, c])
        p = be.apply_delta(p, delta, c)
    assert float(losses[0]) == be.loss_value(p, yd)
    with pytest.raises(ValueError, match="fmasks"):
        be.grow_rounds_masked(data_d, pred0, yd, 2,
                              np.ones((2, Xb.shape[1]), bool))


def test_softmax_predict_equals_host_oracle(data):
    X, y = data
    res = api.train(X, y, n_trees=4, max_depth=3, n_bins=31,
                    loss="softmax", n_classes=C, device="cpu")
    Xb = res.mapper.transform(X)
    raw = api.predict(res.ensemble, Xb, binned=True, raw=True, device="cpu")
    np.testing.assert_allclose(raw, res.ensemble.predict_raw(Xb, binned=True),
                               rtol=1e-6, atol=1e-6)
    p = api.predict(res.ensemble, X, mapper=res.mapper, device="cpu")
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-6)
    assert (p.argmax(axis=1) == y).mean() > 0.9


def test_softmax_config_validation():
    with pytest.raises(ValueError, match="n_classes"):
        TrainConfig(loss="softmax", n_classes=1)
    assert TrainConfig(loss="softmax", n_classes=7).n_outputs == 7
    assert TrainConfig().n_outputs == 1
