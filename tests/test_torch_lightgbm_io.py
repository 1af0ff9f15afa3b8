"""The port's LightGBM model.txt interop against ddt_tpu's, on the CPU.

Mirrors tests/test_lightgbm_io.py's cases on the port (export -> parse
-> the same predictions, NaN default directions, categorical bitsets,
multi-bit import against the independent LightGBM-semantics oracle,
validation), then holds the port's text byte for byte equal to the
reference's for the same ensemble and has each package parse the other's
text into equal arrays. Models are trained by the port on the CPU.
"""

import numpy as np
import pytest

from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch import api
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.categorical import fit_categorical_encoder
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from test_lightgbm_io import _lgbm_oracle_raw


def _train(loss="logloss", **kw):
    if loss == "softmax":
        X, y = datasets.synthetic_multiclass(1500, n_features=8,
                                             n_classes=3, seed=11)
        kw.setdefault("n_classes", 3)
    elif loss == "mse":
        X, y = datasets.synthetic_regression(1500, seed=11)
    else:
        X, y = datasets.synthetic_binary(1500, n_features=8, seed=11)
    res = api.train(X, y, n_trees=4, max_depth=3, n_bins=31, loss=loss,
                    device="cpu", **kw)
    return res, X


def _train_missing():
    X, y = datasets.synthetic_binary(2000, n_features=6, seed=3)
    X = X.copy()
    X[::7, 2] = np.nan
    res = api.train(X, y, n_trees=4, max_depth=3, n_bins=31,
                    missing_policy="learn", device="cpu")
    return res, X


def _train_categorical(seed=0):
    """A model with one-vs-rest categorical splits (CTR-shaped data)."""
    Xn, Xc, y = datasets.synthetic_ctr(4000, seed=seed)
    enc = fit_categorical_encoder(Xc, n_bins=63)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    res = api.train(X, y, n_trees=5, max_depth=4, n_bins=63,
                    cat_features=cat, device="cpu")
    return res, X, cat


@pytest.fixture(scope="module")
def categorical():
    return _train_categorical()


@pytest.mark.parametrize("loss", ["logloss", "mse", "softmax"])
def test_roundtrip_predictions(loss):
    res, X = _train(loss)
    txt = res.ensemble.to_lightgbm_text()
    assert txt.startswith("tree\nversion=v3")
    assert "end of trees" in txt
    back = TreeEnsemble.from_lightgbm_text(txt)
    assert back.loss == loss
    assert back.n_features == res.ensemble.n_features
    want = res.ensemble.predict_raw(X, binned=False)
    got = back.predict_raw(X, binned=False)
    # The base-score fold and the pre-multiplied shrinkage reorder f32
    # adds: ULPs, not structure.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_roundtrip_missing_default_directions():
    res, X = _train_missing()
    back = TreeEnsemble.from_lightgbm_text(res.ensemble.to_lightgbm_text())
    want = res.ensemble.predict_raw(X, binned=False)
    got = back.predict_raw(X, binned=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert back.default_left is not None


def test_export_validates():
    bare = empty_ensemble(2, 3, 5, 0.1, 0.0, "logloss")
    with pytest.raises(ValueError, match="raw-value thresholds"):
        bare.to_lightgbm_text()


def test_roundtrip_categorical(categorical):
    res, X, cat = categorical
    ens = res.ensemble
    assert ens.has_cat_splits
    txt = ens.to_lightgbm_text()
    blocks = [b for b in txt.split("Tree=") if "num_cat" in b]
    n_cat_total = sum(
        int(b.split("num_cat=")[1].splitlines()[0]) for b in blocks)
    assert n_cat_total > 0, "model grew no cat splits; test data too easy"
    assert "cat_boundaries=" in txt and "cat_threshold=" in txt
    back = TreeEnsemble.from_lightgbm_text(txt)
    assert back.cat_features is not None
    assert set(back.cat_features) <= set(cat)
    want = ens.predict_raw(X, binned=False)
    got = back.predict_raw(X, binned=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _multibit_text() -> str:
    """tests/test_lightgbm_io.py's hand-built model: f0 numeric, f1
    categorical; tree 0's root sends {1, 5, 33, 38} left (a two-word
    bitset), tree 1 has an empty bitset whose NaN rows go left."""
    def words(cats):
        w = [0, 0]
        for c in cats:
            w[c // 32] |= 1 << (c % 32)
        return w

    w0 = words([1, 5, 33, 38])
    return "\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", "max_feature_idx=1",
        "objective=binary sigmoid:1", "feature_names=Column_0 Column_1",
        "feature_infos=[-inf:inf] [-inf:inf]", "",
        "Tree=0", "num_leaves=4", "num_cat=2",
        "split_feature=1 0 1", "split_gain=9 4 2", "threshold=0 0.35 1",
        "decision_type=1 0 1", "left_child=1 -1 -3",
        "right_child=2 -2 -4", "leaf_value=0.5 -0.25 0.125 -0.75",
        "leaf_weight=0 0 0 0", "leaf_count=0 0 0 0",
        "internal_value=0 0 0", "internal_weight=0 0 0",
        "internal_count=0 0 0", "cat_boundaries=0 2 3",
        f"cat_threshold={w0[0]} {w0[1]} {1 << 7}",
        "is_linear=0", "shrinkage=1", "",
        "Tree=1", "num_leaves=2", "num_cat=1", "split_feature=1",
        "split_gain=1", "threshold=0", "decision_type=11",
        "left_child=-1", "right_child=-2", "leaf_value=100.0 0.0625",
        "leaf_weight=0 0", "leaf_count=0 0", "internal_value=0",
        "internal_weight=0", "internal_count=0", "cat_boundaries=0 1",
        "cat_threshold=0", "is_linear=0", "shrinkage=1", "",
        "end of trees", "", "pandas_categorical:null", "",
    ])


def test_multibit_categorical_import():
    txt = _multibit_text()
    back = TreeEnsemble.from_lightgbm_text(txt)
    assert back.cat_features is not None and 1 in set(back.cat_features)
    assert back.max_depth == 5      # a 4-link chain above a depth-1 subtree
    rng = np.random.default_rng(7)
    X = np.stack([rng.random(400).astype(np.float32),
                  rng.integers(0, 40, size=400).astype(np.float32)], axis=1)
    X[::11, 1] = np.nan
    X[::13, 0] = np.nan
    want = _lgbm_oracle_raw(txt, X)
    got = back.predict_raw(X, binned=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    nan_f1 = np.isnan(X[:, 1])
    assert got[~nan_f1].max() < 50
    assert (got[nan_f1] > 50).all()
    # Each original split counted once: f0 gain 4, f1 9 + 2 + 1.
    np.testing.assert_allclose(back.feature_importances("gain"),
                               [4 / 16, 12 / 16], rtol=1e-6)


def test_multibit_roundtrip_of_doctored_export(categorical):
    res, X, _ = categorical
    lines = res.ensemble.to_lightgbm_text().splitlines()
    for i, ln in enumerate(lines):
        if ln.startswith("cat_threshold="):
            words = ln.split("=")[1].split()
            words[0] = str(int(words[0]) | (1 << 31) | 1)
            lines[i] = "cat_threshold=" + " ".join(words)
            break
    doctored = "\n".join(lines)
    back = TreeEnsemble.from_lightgbm_text(doctored)
    np.testing.assert_allclose(back.predict_raw(X, binned=False),
                               _lgbm_oracle_raw(doctored, X),
                               rtol=1e-5, atol=1e-6)


def test_malformed_cat_node_rejected():
    txt = "\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", "max_feature_idx=0",
        "objective=binary sigmoid:1", "feature_names=Column_0",
        "feature_infos=[-inf:inf]", "",
        "Tree=0", "num_leaves=2", "num_cat=0",
        "split_feature=0", "split_gain=1", "threshold=0",
        "decision_type=1", "left_child=-1", "right_child=-2",
        "leaf_value=1 0", "leaf_weight=0 0", "leaf_count=0 0",
        "internal_value=0", "internal_weight=0", "internal_count=0",
        "is_linear=0", "shrinkage=1", "",
        "end of trees", "", "pandas_categorical:null", "",
    ])
    with pytest.raises(ValueError, match="num_cat=0"):
        TreeEnsemble.from_lightgbm_text(txt)


def _cat_missing_ensemble():
    ens = empty_ensemble(1, 2, 3, 0.1, 0.0, "logloss",
                         missing_bin=True, n_bins=31, cat_features=(1,))
    ens.feature[0, 0] = 1
    ens.threshold_bin[0, 0] = 2
    ens.threshold_raw[0, 0] = 2.0
    ens.is_leaf[0, 1:3] = True
    ens.has_raw_thresholds = True
    return ens


def test_cat_missing_export_warns():
    with pytest.warns(UserWarning, match="NaN"):
        _cat_missing_ensemble().to_lightgbm_text()


def test_categorical_bitset_validation(categorical):
    res, _, _ = categorical
    lines = res.ensemble.to_lightgbm_text().splitlines()
    for i, ln in enumerate(lines):
        if ln.startswith("decision_type="):
            dts = [int(v) for v in ln.split("=")[1].split()]
            if not any(d & 1 for d in dts):
                continue
            cat_pos = next(j for j, d in enumerate(dts) if d & 1)
            ord_pos = next((j for j, d in enumerate(dts) if not d & 1), None)
            if ord_pos is None:
                continue
            sf_line = i - 3          # split_feature precedes decision_type
            assert lines[sf_line].startswith("split_feature=")
            sfs = lines[sf_line].split("=")[1].split()
            sfs[cat_pos] = sfs[ord_pos]
            lines[sf_line] = "split_feature=" + " ".join(sfs)
            break
    with pytest.raises(ValueError, match="both categorical and numerical"):
        TreeEnsemble.from_lightgbm_text("\n".join(lines))


def test_header_fields_and_leaf_encoding():
    res, _ = _train()
    txt = res.ensemble.to_lightgbm_text(
        feature_names=[f"f{i}" for i in range(8)])
    lines = dict(
        ln.partition("=")[::2] for ln in txt.splitlines() if "=" in ln)
    assert lines["num_class"] == "1"
    assert lines["objective"] == "binary sigmoid:1"
    assert lines["max_feature_idx"] == "7"
    assert "feature_names=f0 f1 f2 f3 f4 f5 f6 f7" in txt
    lc = [int(v) for v in lines["left_child"].split()]
    rc = [int(v) for v in lines["right_child"].split()]
    n_leaves = int(lines["num_leaves"])
    refs = lc + rc
    assert sum(1 for r in refs if r < 0) == n_leaves
    assert all(-n_leaves <= r < n_leaves - 1 for r in refs)


# --------------------------------------------------------------------- #
# cross-package: byte-identical text, each parses the other's
# --------------------------------------------------------------------- #
_CASES = ["logloss", "mse", "softmax", "missing", "categorical"]


def _model(case: str, categorical) -> TreeEnsemble:
    if case == "categorical":
        return categorical[0].ensemble
    if case == "missing":
        return _train_missing()[0].ensemble
    return _train(case)[0].ensemble


@pytest.mark.parametrize("case", _CASES)
def test_text_matches_reference_byte_for_byte(categorical, case):
    ens = _model(case, categorical)
    ref = JEnsemble.from_dict(ens.to_dict())
    names = [f"x{i}" for i in range(ens.n_features)]
    assert ens.to_lightgbm_text() == ref.to_lightgbm_text()
    assert ens.to_lightgbm_text(names) == ref.to_lightgbm_text(names)


@pytest.mark.parametrize("case", _CASES + ["multibit"])
def test_each_package_parses_the_others_text(categorical, case):
    if case == "multibit":
        txt = _multibit_text()
    else:
        txt = _model(case, categorical).to_lightgbm_text()
    port = TreeEnsemble.from_lightgbm_text(txt)
    ref = JEnsemble.from_lightgbm_text(txt)
    pd, rd = port.to_dict(), ref.to_dict()
    assert pd.keys() == rd.keys()
    for k in pd:
        a, b = np.asarray(pd[k]), np.asarray(rd[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # The parsed models write the same text again in either package (the
    # multi-bit import's sentinel link for a NaN-only split has no
    # single-bit rendering in either).
    if case != "multibit":
        assert port.to_lightgbm_text() == ref.to_lightgbm_text()


# --------------------------------------------------------------------- #
# a parsed model scores on bins again (api.fill_bin_thresholds)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["logloss", "softmax", "missing",
                                  "categorical"])
def test_fill_bin_thresholds_restores_the_routing(categorical, case):
    """The text carries raw thresholds only; the bins filled back from
    the training mapper route every row as the raw thresholds do, so the
    parsed model's device scores (plain version here) equal its own host
    raw-value traversal and the trained model's within the round trip's
    f32 tolerance, and its splits are the trained model's."""
    if case == "categorical":
        res, X, _ = categorical
    elif case == "missing":
        res, X = _train_missing()
    else:
        res, X = _train(case)
    ens = res.ensemble
    back = TreeEnsemble.from_lightgbm_text(ens.to_lightgbm_text())
    api.fill_bin_thresholds(back, res.mapper)
    split = back.feature >= 0
    np.testing.assert_array_equal(back.feature[split], ens.feature[split])
    np.testing.assert_array_equal(back.threshold_bin[split],
                                  ens.threshold_bin[split])
    got = api.predict(back, X, mapper=res.mapper, raw=True, device="cpu")
    np.testing.assert_allclose(got, back.predict_raw(X, binned=False),
                               rtol=1e-6, atol=1e-6)
    want = api.predict(ens, X, mapper=res.mapper, raw=True, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fill_bin_thresholds_refuses_a_threshold_off_the_edges():
    res, _ = _train()
    back = TreeEnsemble.from_lightgbm_text(res.ensemble.to_lightgbm_text())
    node = np.argwhere((back.feature >= 0)
                       & np.isfinite(back.threshold_raw))[0]
    back.threshold_raw[tuple(node)] = np.nextafter(
        back.threshold_raw[tuple(node)], np.float32(np.inf))
    with pytest.raises(ValueError, match="not one of the mapper's edges"):
        api.fill_bin_thresholds(back, res.mapper)
