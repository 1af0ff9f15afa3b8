"""One-vs-rest categorical splits (cat_features) and the categorical
encoder in the port, mirroring tests/test_categorical_splits.py against
ddt_tpu on the CPU.

Bitwise: the encoder (frequency and hash binning, and its save/load dict)
against ddt_tpu.data.categorical on Criteo-shaped ids (synthetic_ctr);
the split choice on small-integer histograms (exact gains); the routing
of rows through a grown tree; trees against the reference's trainer
(feature, bin, leaf-ness exact; leaves to 2e-4 as the reference's own
backend-parity test holds them). Quality: one-vs-rest beats ordinal on
exact-category signal, as in the reference. The eval-set router honours
one-vs-rest routing: the recorded auc equals the host oracle's on the
truncated ensemble, within the device twin's binned-rank tolerance.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data import categorical as jcat
from ddt_tpu.data.datasets import synthetic_ctr as j_synthetic_ctr
from ddt_tpu.reference import numpy_trainer as ref
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import categorical as tcat
from ddt_tpu_torch.data.datasets import synthetic_ctr
from ddt_tpu_torch.data.quantizer import fit_bin_mapper, quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import grow, split
from ddt_tpu_torch.utils.metrics import evaluate


def _ctr_matrix(rows=4000, bins=63, seed=0):
    """(X float32 with the encoded categorical columns, y, their indices)."""
    Xn, Xc, y = synthetic_ctr(rows, seed=seed)
    enc = tcat.fit_categorical_encoder(Xc, n_bins=bins)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    return X, y, tuple(range(Xn.shape[1], X.shape[1]))


def test_synthetic_ctr_equals_reference():
    for a, b in zip(synthetic_ctr(3000, seed=2), j_synthetic_ctr(3000,
                                                                seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bins", [255, 63, 8])
def test_encoder_bitwise(bins):
    _, Xc, _ = synthetic_ctr(5000, seed=1)
    fit, tr = Xc[:4000], Xc[4000:]           # unseen ids go to bin 0
    e_t = tcat.fit_categorical_encoder(fit, n_bins=bins)
    e_j = jcat.fit_categorical_encoder(fit, n_bins=bins)
    for a, b in zip(e_t.vocab_ids, e_j.vocab_ids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(e_t.transform(tr), e_j.transform(tr))
    np.testing.assert_array_equal(tcat.bin_categoricals(fit, bins),
                                  jcat.bin_categoricals(fit, bins))
    np.testing.assert_array_equal(tcat.hash_bin_categoricals(Xc, bins),
                                  jcat.hash_bin_categoricals(Xc, bins))
    back = jcat.CategoricalEncoder.load(e_t.save())
    np.testing.assert_array_equal(back.transform(tr), e_t.transform(tr))
    again = tcat.CategoricalEncoder.load(e_j.save())
    np.testing.assert_array_equal(again.transform(tr), e_j.transform(tr))


def test_onehot_gain_matches_oracle():
    rng = np.random.default_rng(3)
    hist = rng.integers(-5, 6, (4, 6, 16, 2)).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1])
    cat = np.zeros(6, bool)
    cat[[1, 4]] = True
    want = ref.best_splits(hist, 1.0, 1e-3, cat_mask=cat)
    got = split.best_splits_impl(torch.from_numpy(hist), 1.0, 1e-3,
                                 cat_mask=torch.from_numpy(cat))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_onehot_gain_hand_computed():
    """Isolating the LAST category is expressible only one-vs-rest."""
    hist = np.zeros((1, 1, 3, 2), np.float32)
    hist[0, 0, :, 0] = [1.0, 1.0, -4.0]
    hist[0, 0, :, 1] = [1.0, 1.0, 2.0]
    gains, _, bins, _ = split.best_splits_impl(
        torch.from_numpy(hist), 1.0, 0.0, cat_mask=torch.ones(1, dtype=bool))
    assert int(bins[0]) == 2
    np.testing.assert_allclose(float(gains[0]),
                               0.5 * (16 / 3 + 4 / 3 - 4 / 5), rtol=1 / 128)
    _, _, b_ord, _ = split.best_splits_impl(torch.from_numpy(hist), 1.0, 0.0)
    assert int(b_ord[0]) != 2


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_parity_with_reference_cat_splits(grad_dtype):
    X, y, cat = _ctr_matrix()
    kw = dict(n_trees=5, max_depth=4, n_bins=63, cat_features=cat,
              min_split_gain=1e-3, grad_dtype=grad_dtype)
    a = japi.train(X, y, JConfig(backend="tpu", **kw)).ensemble
    b = api.train(X, y, TrainConfig(device="cpu", **kw)).ensemble
    np.testing.assert_array_equal(b.feature, a.feature)
    np.testing.assert_array_equal(b.threshold_bin, a.threshold_bin)
    np.testing.assert_array_equal(b.is_leaf, a.is_leaf)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(b.cat_features, a.cat_features)
    np.testing.assert_array_equal(b.threshold_raw, a.threshold_raw)
    used = b.feature[(~b.is_leaf) & (b.feature >= 0)]
    assert np.isin(used, cat).any()


def test_cat_routing_equals_host_traversal_bitwise():
    X, y, cat = _ctr_matrix(rows=3000, bins=31)
    m = fit_bin_mapper(X, n_bins=31, cat_features=cat)
    Xb = m.transform(X)
    mask = grow.cat_feature_mask(cat, Xb.shape[1], "cpu")
    p = (np.float32(y.mean()) - y).astype(np.float32)
    tree = grow.grow_tree(torch.from_numpy(Xb), torch.from_numpy(p),
                          torch.full((len(y),), 0.2), max_depth=4,
                          n_bins=31, reg_lambda=1.0, min_child_weight=1e-3,
                          min_split_gain=0.0, cat_mask=mask)
    ens = empty_ensemble(1, 4, Xb.shape[1], 0.5, 0.0, "logloss", n_bins=31,
                         cat_features=cat)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value"):
        getattr(ens, k)[0] = getattr(tree, k).numpy()
    assert np.isin(ens.feature[0][~ens.is_leaf[0]], cat).any()
    leaf = ens._traverse_np(Xb, binned=True)[0]
    np.testing.assert_array_equal(tree.leaf_of_row.numpy(), leaf)
    pred = torch.zeros(len(y))
    grow.apply_tree_pred(torch.from_numpy(Xb), pred, tree.feature,
                         tree.threshold_bin, tree.is_leaf, tree.leaf_value,
                         max_depth=4, learning_rate=0.5, cat_mask=mask)
    np.testing.assert_array_equal(
        pred.numpy(), np.float32(0.5) * ens.leaf_value[0][leaf])


def test_onehot_beats_ordinal_on_exact_category_signal():
    rng = np.random.default_rng(11)
    rows = 12000
    Xn = rng.standard_normal((rows, 4)).astype(np.float32)
    ids = rng.integers(0, 40, size=(rows, 2))
    hot = np.isin(ids[:, 0], [7, 23, 31]) | np.isin(ids[:, 1], [4, 18])
    score = 1.8 * hot + 0.4 * Xn[:, 0] + rng.standard_normal(rows) * 0.8
    y = (score > np.quantile(score, 0.7)).astype(np.int32)
    enc = tcat.fit_categorical_encoder(ids, n_bins=63)
    X = np.concatenate([Xn, enc.transform(ids).astype(np.float32)], axis=1)
    tr, va = slice(0, 9000), slice(9000, None)
    kw = dict(n_trees=30, max_depth=4, n_bins=63, device="cpu")
    r_one = api.train(X[tr], y[tr], cat_features=(4, 5), **kw)
    r_ord = api.train(X[tr], y[tr], **kw)
    auc_one = evaluate("auc", y[va], api.predict(
        r_one.ensemble, X[va], mapper=r_one.mapper, raw=True, device="cpu"))
    auc_ord = evaluate("auc", y[va], api.predict(
        r_ord.ensemble, X[va], mapper=r_ord.mapper, raw=True, device="cpu"))
    assert auc_one > auc_ord + 0.002, (auc_one, auc_ord)


def test_predict_paths_agree_with_cat_splits():
    X, y, cat = _ctr_matrix(rows=3000)
    res = api.train(X, y, n_trees=6, max_depth=4, n_bins=63, device="cpu",
                    cat_features=cat)
    ens, mapper = res.ensemble, res.mapper
    Xb = mapper.transform(X)
    want = ens.predict_raw(Xb, binned=True)
    np.testing.assert_allclose(
        api.predict(ens, Xb, binned=True, raw=True, device="cpu"), want,
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        api.predict(ens, X, mapper=mapper, raw=True, device="cpu"), want,
        rtol=1e-6, atol=1e-6)


def test_cat_mapper_identity_edges():
    X, _, cat = _ctr_matrix(rows=2000, bins=31)
    Xb = fit_bin_mapper(X, n_bins=31, cat_features=cat).transform(X)
    for f in cat:
        np.testing.assert_array_equal(Xb[:, f], X[:, f].astype(np.uint8))


@pytest.mark.parametrize("fused", [True, False])
def test_cat_eval_set_scores_the_truncated_ensemble(fused):
    X, y, cat = _ctr_matrix(rows=4000)
    cfg = TrainConfig(n_trees=8, max_depth=4, n_bins=63, device="cpu",
                      cat_features=cat)
    Xb = fit_bin_mapper(X, n_bins=63, cat_features=cat).transform(X)

    class Granular(CUDADevice):
        grow_rounds = None

    d = Driver(get_backend(cfg) if fused else Granular(cfg), cfg)
    ens = d.fit(Xb[:3000], y[:3000], eval_set=(Xb[3000:], y[3000:]),
                eval_metric="auc")
    for rec in (d.history[2], d.history[-1]):
        part = ens.truncate(rec["round"])
        want = evaluate("auc", y[3000:],
                        part.predict_raw(Xb[3000:], binned=True))
        np.testing.assert_allclose(rec["valid_auc"], want, atol=5e-5)


def test_cat_config_guards():
    with pytest.raises(ValueError, match="missing_policy"):
        TrainConfig(cat_features=(1,), missing_policy="learn")
    assert TrainConfig(cat_features=[]).cat_features == ()
    assert TrainConfig(cat_features=[5, 2]).cat_features == (2, 5)
    with pytest.raises(ValueError, match=">= 0"):
        TrainConfig(cat_features=(-1,))
    X, y, _ = _ctr_matrix(rows=200)
    Xb, _ = quantize(X, n_bins=63)
    cfg = TrainConfig(n_trees=1, max_depth=2, n_bins=63, device="cpu",
                      cat_features=(X.shape[1] + 3,))
    with pytest.raises(ValueError, match="out of range"):
        Driver(get_backend(cfg), cfg).fit(Xb, y)


def test_mapper_without_identity_cat_bins_rejected():
    X, y, cat = _ctr_matrix(rows=600)
    m_plain = fit_bin_mapper(X, n_bins=63)
    with pytest.raises(ValueError, match="identity-binned"):
        api.train(X, y, mapper=m_plain, cat_features=cat, n_trees=2,
                  max_depth=3, n_bins=63, device="cpu")
    m_cat = fit_bin_mapper(X, n_bins=63, cat_features=cat)
    res = api.train(X, y, mapper=m_cat, cat_features=cat, n_trees=2,
                    max_depth=3, n_bins=63, device="cpu")
    with pytest.raises(ValueError, match="identity-bin"):
        api.predict(res.ensemble, X, mapper=m_plain, device="cpu")
    p = api.predict(res.ensemble, X, mapper=m_cat, device="cpu")
    assert p.shape == (X.shape[0],)
