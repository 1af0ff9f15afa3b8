"""The port's binning, datasets and model files against ddt_tpu's.

Binning is held bitwise (the same numpy code on the same inputs); model
parameters cross in both directions: an npz saved by either package loads
in the other and scores the same, and BinMapper.save() dicts cross-load.
"""

import numpy as np
import pytest

from ddt_tpu.data import datasets as jdata
from ddt_tpu.data import quantizer as jq
from ddt_tpu.models import tree as jtree
from ddt_tpu_torch.data import datasets as tdata
from ddt_tpu_torch.data import quantizer as tq
from ddt_tpu_torch.models import tree as ttree


def _X(seed=0, rows=3000, F=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, F)).astype(np.float32)
    X[rng.random((rows, F)) < 0.05] = np.nan
    X[:7, 1] = np.inf
    X[7:9, 1] = -np.inf
    X[:, 2] = 1.5                       # constant column
    X[:, 3] = np.round(X[:, 3] * 2)     # few distinct values
    return X


@pytest.mark.parametrize("n_bins", [255, 128, 64, 3])
@pytest.mark.parametrize("missing_policy", ["zero", "learn"])
def test_quantize_bitwise(n_bins, missing_policy):
    X = _X()
    Xb_j, m_j = jq.quantize(X, n_bins=n_bins, max_sample=1000, seed=3,
                            missing_policy=missing_policy)
    Xb_t, m_t = tq.quantize(X, n_bins=n_bins, max_sample=1000, seed=3,
                            missing_policy=missing_policy)
    assert Xb_t.dtype == np.uint8
    np.testing.assert_array_equal(Xb_t, Xb_j)
    np.testing.assert_array_equal(m_t.edges, m_j.edges)
    assert (m_t.n_bins, m_t.missing_bin) == (m_j.n_bins, m_j.missing_bin)
    for f in range(X.shape[1]):
        for t in (0, n_bins // 2, n_bins - 1):
            assert m_t.threshold_value(f, t) == m_j.threshold_value(f, t)


def test_fit_bin_mapper_cat_features_bitwise():
    X = _X(1)
    X[:, 4] = np.random.default_rng(2).integers(0, 9, len(X))
    m_j = jq.fit_bin_mapper(X, n_bins=32, cat_features=(4,))
    m_t = tq.fit_bin_mapper(X, n_bins=32, cat_features=(4,))
    np.testing.assert_array_equal(m_t.edges, m_j.edges)
    assert m_t.cat_features == m_j.cat_features == (4,)
    np.testing.assert_array_equal(m_t.transform(X), m_j.transform(X))


def test_feature_bincounts_and_datasets_identical():
    Xb = jq.quantize(_X(), n_bins=64)[0]
    np.testing.assert_array_equal(tq.feature_bincounts(Xb, 64),
                                  jq.feature_bincounts(Xb, 64))
    for args in ((500,), (300, 5, 7, 0.5)):
        Xj, yj = jdata.synthetic_binary(*args)
        Xt, yt = tdata.synthetic_binary(*args)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)


def test_bin_mapper_dicts_cross_load():
    X = _X()
    Xb, m_j = jq.quantize(X, n_bins=31, missing_policy="learn")
    m_j.ref_counts = jq.feature_bincounts(Xb, 31)
    m_t = tq.BinMapper.load(m_j.save())
    np.testing.assert_array_equal(m_t.transform(X), Xb)
    np.testing.assert_array_equal(m_t.ref_counts, m_j.ref_counts)
    back = jq.BinMapper.load(m_t.save())
    np.testing.assert_array_equal(back.transform(X), Xb)
    assert back.missing_bin and back.n_bins == 31


def _rand_ens(mod, seed=0, T=11, depth=4, F=6, B=31, loss="logloss", C=2,
              missing=False, cat=()):
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = mod.empty_ensemble(T, depth, F, 0.1, 0.3, loss, n_classes=C,
                             missing_bin=missing, n_bins=B,
                             cat_features=tuple(cat))
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 2, size=(T, N))
    ens.threshold_raw[:] = rng.standard_normal((T, N))
    ens.has_raw_thresholds = True
    ens.is_leaf[:] = rng.random((T, N)) < 0.2
    ens.leaf_value[:] = rng.standard_normal((T, N))
    ens.split_gain[:] = rng.random((T, N))
    if missing:
        ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


_VARIANTS = [dict(), dict(missing=True), dict(cat=(1, 4)),
             dict(loss="softmax", C=3, missing=True, cat=(2,))]


@pytest.mark.parametrize("kw", _VARIANTS)
def test_ensemble_npz_reference_to_port(tmp_path, kw):
    ens = _rand_ens(jtree, **kw)
    ens.save(str(tmp_path / "ref.npz"))
    got = ttree.TreeEnsemble.load(str(tmp_path / "ref.npz"))
    X = np.random.default_rng(5).integers(0, 31, (400, 6)).astype(np.uint8)
    Xf = np.random.default_rng(6).standard_normal((400, 6))
    np.testing.assert_array_equal(got.predict_raw(X, binned=True),
                                  ens.predict_raw(X, binned=True))
    np.testing.assert_array_equal(got.predict_raw(Xf), ens.predict_raw(Xf))
    assert got.cache_token() == ens.cache_token()


@pytest.mark.parametrize("kw", _VARIANTS)
def test_ensemble_npz_port_to_reference(tmp_path, kw):
    ens = _rand_ens(ttree, **kw)
    path = tmp_path / "port.npz"
    ens.save(str(path))
    got = jtree.TreeEnsemble.load(str(path))
    X = np.random.default_rng(5).integers(0, 31, (400, 6)).astype(np.uint8)
    np.testing.assert_array_equal(got.predict(X, binned=True),
                                  ens.predict(X, binned=True))
    for k, v in ens.to_dict().items():
        np.testing.assert_array_equal(got.to_dict()[k], v, err_msg=k)
    # Deterministic bytes: a second save of the same model is identical.
    ens.save(str(tmp_path / "again.npz"))
    assert path.read_bytes() == (tmp_path / "again.npz").read_bytes()


@pytest.mark.parametrize("kw", _VARIANTS)
def test_compiled_ensemble_matches_reference(kw):
    ens_j = _rand_ens(jtree, T=70, **kw)
    ens_t = ttree.TreeEnsemble.from_dict(ens_j.to_dict())
    cj = jtree.CompiledEnsemble.build(ens_j, tree_chunk=32)
    ct = ttree.CompiledEnsemble.build(ens_t, tree_chunk=32)
    assert ct.token == cj.token
    assert (ct.n_classes_out, ct.missing_bin_value, ct.n_trees_padded) == \
        (cj.n_classes_out, cj.missing_bin_value, cj.n_trees_padded)
    assert len(ct.arrays()) == len(cj.arrays())
    for a, b in zip(ct.arrays(), cj.arrays()):
        np.testing.assert_array_equal(a, b)


def test_truncate_matches_reference():
    ens_j = _rand_ens(jtree, missing=True)
    ens_t = ttree.TreeEnsemble.from_dict(ens_j.to_dict())
    a, b = ens_t.truncate(4), ens_j.truncate(4)
    assert a.n_trees == 4
    X = np.random.default_rng(1).integers(0, 31, (200, 6)).astype(np.uint8)
    np.testing.assert_array_equal(a.predict_raw(X, binned=True),
                                  b.predict_raw(X, binned=True))
