"""The port's native C++ kernels (ddt_tpu_torch/native: its own copies of
histogram.cpp, split_gain.cpp and csv_loader.cpp, built by its own
loader), against tests/test_native.py: bitwise the port's NumPy oracle
(same f32 operation order) and bitwise the reference's native library on
the same inputs, histogram, split gain (plain and full), traversal with
missing and categorical routing, and CSV parse.

Bit-exactness against the row-order oracle holds on the serial kernel
path: the module pins one OpenMP thread (the reference's conftest pins
its own library the same way); the multi-thread contract has its own
case below.
"""

import numpy as np
import pytest

from ddt_tpu import native as jnative
from ddt_tpu.reference import numpy_trainer as jref
from ddt_tpu_torch import native
from ddt_tpu_torch.backends.cpu import CPUDevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.reference import numpy_trainer as ref


@pytest.fixture(autouse=True)
def _serial():
    with native.omp_threads(1):
        yield


def _cfg(**kw):
    return TrainConfig(**{"backend": "cpu", **kw})


@pytest.mark.parametrize("R,F,B,N", [
    (1000, 6, 31, 1),
    (2048, 4, 255, 8),
    (777, 3, 16, 32),
])
def test_native_histogram_exact(R, F, B, N):
    rng = np.random.default_rng(1)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(-1, N, size=R).astype(np.int32)
    got = native.histogram_native(Xb, g, h, ni, N, B)
    np.testing.assert_array_equal(ref.build_histograms(Xb, g, h, ni, N, B),
                                  got)
    np.testing.assert_array_equal(
        jnative.histogram_native(Xb, g, h, ni, N, B), got)


def _random_ensemble(rng, T, depth, F, B, loss="logloss"):
    ens = empty_ensemble(T, depth, F, 0.1, 0.0, loss)
    N = ens.feature.shape[1]
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 1, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.15
    ens.is_leaf[:, (1 << depth) - 1:] = True
    return ens


def test_native_traverse_matches_ensemble():
    rng = np.random.default_rng(2)
    R, F, B, depth, T = 3000, 8, 63, 5, 12
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    ens = _random_ensemble(rng, T, depth, F, B)
    dl = rng.random(ens.feature.shape) < 0.5
    got = native.traverse_native(Xb, ens.feature, ens.threshold_bin,
                                 ens.is_leaf, depth)
    np.testing.assert_array_equal(ens._traverse_np(Xb, binned=True), got)
    # Missing and categorical routing, against the reference's library.
    cat = np.isin(ens.feature, [1, 4])
    args = (Xb, ens.feature, ens.threshold_bin, ens.is_leaf, depth)
    np.testing.assert_array_equal(
        jnative.traverse_native(*args, default_left=dl,
                                missing_bin_value=B - 1, cat_node=cat),
        native.traverse_native(*args, default_left=dl,
                               missing_bin_value=B - 1, cat_node=cat))


def test_cpu_backend_uses_native():
    be = CPUDevice(_cfg(n_bins=31))
    assert be._native is not None and be._native_split is not None
    assert be._native_traverse is not None and be.hist_impl == "native"
    assert CPUDevice(_cfg(n_bins=31), use_native=False).hist_impl == "numpy"


def test_native_library_is_the_ports_own():
    """The port builds its own sources into its own _build directory and
    checks the versioned traversal symbol."""
    from pathlib import Path

    path = native.lib_path()
    assert path.parent == Path(native.__file__).parent.parent / "_build"
    assert path.exists() and "ddt_traverse_v3" in native._SYMBOLS
    assert native.SRC_DIR == Path(native.__file__).parent
    for name in native.SOURCES:
        assert (native.SRC_DIR / name).exists()


@pytest.mark.parametrize("reg_lambda,mcw,seed", [
    (1.0, 1e-3, 0),
    (0.0, 0.0, 1),
    (5.0, 2.0, 2),
])
def test_native_split_gain_exact(reg_lambda, mcw, seed):
    rng = np.random.default_rng(seed)
    N, F, B = 8, 5, 31
    hist = rng.standard_normal((N, F, B, 2)).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1])
    hist[2] = 0.0
    hist[:, 3] = hist[:, 1]         # exact bf16 ties: first index wins
    got = native.split_gain_native(hist, reg_lambda, mcw)
    for want in (ref.best_splits(hist, reg_lambda, mcw)[:3],
                 jref.best_splits(hist, reg_lambda, mcw)[:3],
                 jnative.split_gain_native(hist, reg_lambda, mcw)):
        for w, g_ in zip(want, got):
            np.testing.assert_array_equal(w, g_)


def _binary(rows, features, bins, seed):
    from ddt_tpu_torch.data.datasets import synthetic_binary
    from ddt_tpu_torch.data.quantizer import quantize

    X, y = synthetic_binary(rows, n_features=features, seed=seed)
    return quantize(X, n_bins=bins, seed=seed)[0], y


def test_native_trainer_identical_to_numpy_trainer():
    Xb, y = _binary(3000, 8, 63, 13)
    cfg = _cfg(n_trees=6, max_depth=4, n_bins=63)
    e_native = Driver(CPUDevice(cfg, use_native=True), cfg,
                      log_every=10**9).fit(Xb, y)
    e_numpy = Driver(CPUDevice(cfg, use_native=False), cfg,
                     log_every=10**9).fit(Xb, y)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(getattr(e_native, k),
                                      getattr(e_numpy, k), err_msg=k)


def test_native_predict_matches_numpy_predict():
    from ddt_tpu_torch.data.datasets import synthetic_multiclass
    from ddt_tpu_torch.data.quantizer import quantize

    X, y = synthetic_multiclass(1500, n_features=6, n_classes=3, seed=4)
    Xb, _ = quantize(X, n_bins=31, seed=4)
    cfg = _cfg(n_trees=4, max_depth=3, n_bins=31, loss="softmax",
               n_classes=3)
    be = CPUDevice(cfg, use_native=True)
    ens = Driver(be, cfg, log_every=10**9).fit(Xb, y)
    np.testing.assert_allclose(be.predict_raw(ens, Xb),
                               ens.predict_raw(Xb, binned=True),
                               rtol=1e-6, atol=1e-6)


def test_cpu_backend_histogram_exact():
    be = CPUDevice(_cfg(n_bins=31), use_native=True)
    rng = np.random.default_rng(3)
    Xb = rng.integers(0, 31, size=(500, 4), dtype=np.uint8)
    g = rng.standard_normal(500).astype(np.float32)
    h = rng.random(500).astype(np.float32)
    ni = rng.integers(0, 4, size=500).astype(np.int32)
    got = be.build_histograms(be.upload(Xb), g, h, ni, 4)
    np.testing.assert_array_equal(ref.build_histograms(Xb, g, h, ni, 4, 31),
                                  got)


def test_split_gain_full_matches_oracle_fuzz():
    rng = np.random.default_rng(0)
    for trial in range(50):
        n = int(rng.integers(1, 5))
        F = int(rng.integers(2, 7))
        B = int(rng.integers(3, 20))
        hist = rng.standard_normal((n, F, B, 2)).astype(np.float32)
        hist[..., 1] = np.abs(hist[..., 1])
        lam = float(rng.choice([0.0, 0.5, 1.0]))
        mcw = float(rng.choice([0.0, 1e-3, 0.7]))
        fm = rng.random(F) < 0.7 if rng.random() < 0.5 else None
        if fm is not None and not fm.any():
            fm[0] = True
        missing = bool(rng.random() < 0.5)
        cm = (rng.random(F) < 0.4) if rng.random() < 0.5 else None
        got = native.split_gain_full_native(hist, lam, mcw, fm, missing, cm)
        for want in (ref.best_splits(hist, lam, mcw, fm, missing_bin=missing,
                                     cat_mask=cm),
                     jnative.split_gain_full_native(hist, lam, mcw, fm,
                                                    missing, cm)):
            for w, g in zip(want, got):
                np.testing.assert_array_equal(
                    np.asarray(w, np.float64), np.asarray(g, np.float64),
                    err_msg=f"trial {trial}")


def _ctr(rows, seed):
    from ddt_tpu_torch.data.categorical import fit_categorical_encoder
    from ddt_tpu_torch.data.datasets import synthetic_ctr
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper

    Xn, Xc, y = synthetic_ctr(rows, seed=seed)
    enc = fit_categorical_encoder(Xc, n_bins=63)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    m = fit_bin_mapper(X, n_bins=63, cat_features=cat)
    return X, y, cat, m


def test_native_traverse_cat_routing_matches_numpy():
    from ddt_tpu_torch import api

    X, y, cat, m = _ctr(2000, 0)
    res = api.train(X, y, mapper=m, cat_features=cat, n_trees=5,
                    max_depth=4, n_bins=63, backend="cpu", log_every=10**9)
    Xb = m.transform(X)
    be = CPUDevice(_cfg(n_bins=63, cat_features=cat), use_native=True)
    np.testing.assert_array_equal(res.ensemble.predict_raw(Xb, binned=True),
                                  be.predict_raw(res.ensemble, Xb))
    used = res.ensemble.feature[(~res.ensemble.is_leaf)
                                & (res.ensemble.feature >= 0)]
    assert np.isin(used, cat).any()


def test_cpu_backend_uses_native_full_split_missing_colsample():
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper

    rng = np.random.default_rng(5)
    X = rng.standard_normal((3000, 8)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    y = (X[:, 0] > 0.2).astype(np.int64)
    y[np.isnan(X[:, 0])] = rng.integers(0, 2, np.isnan(X[:, 0]).sum())
    m = fit_bin_mapper(X, n_bins=31, missing_policy="learn")
    Xb = m.transform(X)
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=31, missing_policy="learn",
               colsample_bytree=0.75)
    be_n = CPUDevice(cfg, use_native=True)
    assert be_n._native_split_full is not None
    e_n = Driver(be_n, cfg, log_every=10**9).fit(Xb, y)
    e_0 = Driver(CPUDevice(cfg, use_native=False), cfg,
                 log_every=10**9).fit(Xb, y)
    for k in ("feature", "threshold_bin", "default_left"):
        np.testing.assert_array_equal(getattr(e_n, k), getattr(e_0, k))
    np.testing.assert_allclose(e_n.leaf_value, e_0.leaf_value, rtol=1e-6)


def test_cpu_backend_uses_native_full_split_cat_training():
    X, y, cat, m = _ctr(2500, 2)
    Xb = m.transform(X)
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=63, cat_features=cat)
    e_n = Driver(CPUDevice(cfg, use_native=True), cfg,
                 log_every=10**9).fit(Xb, y)
    e_0 = Driver(CPUDevice(cfg, use_native=False), cfg,
                 log_every=10**9).fit(Xb, y)
    np.testing.assert_array_equal(e_n.feature, e_0.feature)
    np.testing.assert_array_equal(e_n.threshold_bin, e_0.threshold_bin)
    np.testing.assert_allclose(e_n.leaf_value, e_0.leaf_value, rtol=1e-6)
    used = e_n.feature[(~e_n.is_leaf) & (e_n.feature >= 0)]
    assert np.isin(used, cat).any()


def test_csv_parse_native_matches_loadtxt(tmp_path):
    text = ("colA,colB,colC\n"
            "1.5,2,-3e2\r\n"
            "# a full-line comment\n"
            "\n"
            "4,5.25,6 # trailing comment\n"
            "-0.125,1e-3,+7\n")
    p = tmp_path / "t.csv"
    p.write_text(text)
    want = np.loadtxt(str(p), delimiter=",", skiprows=1)
    got = native.csv_parse_native(text.encode(), skip_rows=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.csv_parse_native(text.encode(), skip_rows=1))
    got2 = native.csv_parse_native(text.encode(), skip_rows=1, max_rows=2)
    np.testing.assert_array_equal(got2, want[:2])


def test_csv_parse_native_rejects_malformed():
    with pytest.raises(ValueError, match="line 2.*expected"):
        native.csv_parse_native(b"1,2,3\n4,5\n")
    with pytest.raises(ValueError, match="unparseable"):
        native.csv_parse_native(b"1,2\n3,x\n")
    with pytest.raises(ValueError, match="empty"):
        native.csv_parse_native(b"1,,3\n")
    assert native.csv_parse_native(b"").shape == (0, 0)


def test_load_file_csv_native_equals_fallback(tmp_path, monkeypatch):
    """load_file's CSV branch: the native parse == np.loadtxt == the
    reference's load_file."""
    from ddt_tpu.data import datasets as jds
    from ddt_tpu_torch.data import datasets as ds

    rng = np.random.default_rng(3)
    M = rng.standard_normal((200, 5)).round(4)
    M[:, 0] = rng.integers(0, 2, 200)
    p = tmp_path / "d.csv"
    np.savetxt(str(p), M, delimiter=",", fmt="%.6g")
    calls = []
    real = native.csv_parse_native
    monkeypatch.setattr(native, "csv_parse_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    Xn, yn = ds.load_file(str(p))
    assert calls                               # the native path ran
    monkeypatch.setattr(native, "available", lambda: False)
    Xf, yf = ds.load_file(str(p))
    Xj, yj = jds.load_file(str(p))
    for a, b in ((Xn, Xf), (yn, yf), (Xn, Xj), (yn, yj)):
        np.testing.assert_array_equal(a, b)


def test_native_multithread_allclose_deterministic():
    rng = np.random.default_rng(7)
    R, F, B, N = 20_000, 8, 63, 16
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(-1, N, size=R).astype(np.int32)
    want = ref.build_histograms(Xb, g, h, ni, N, B)
    with native.omp_threads(4):
        a = native.histogram_native(Xb, g, h, ni, N, B)
        b = native.histogram_native(Xb, g, h, ni, N, B)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, want, rtol=2e-5, atol=2e-5)
        M = rng.standard_normal((2_000, 6))
        text = "\n".join(",".join(f"{v:.6f}" for v in row) for row in M)
        np.testing.assert_array_equal(
            native.csv_parse_native((text + "\n").encode()), np.round(M, 6))
        hist = want + 0.0
        hist[..., 1] = np.abs(hist[..., 1])
        for w_, g_ in zip(ref.best_splits(hist, 1.0, 1e-3)[:3],
                          native.split_gain_native(hist, 1.0, 1e-3)):
            np.testing.assert_array_equal(w_, g_)
        ens = _random_ensemble(rng, 12, 5, F, B)
        np.testing.assert_array_equal(
            ens._traverse_np(Xb, binned=True),
            native.traverse_native(Xb, ens.feature, ens.threshold_bin,
                                   ens.is_leaf, 5))
        Xb4, y4 = _binary(5000, 8, 63, 21)
        cfg = _cfg(n_trees=3, max_depth=4, n_bins=63)
        e4 = Driver(CPUDevice(cfg, use_native=True), cfg,
                    log_every=10**9).fit(Xb4, y4)
    e1 = Driver(CPUDevice(cfg, use_native=True), cfg,
                log_every=10**9).fit(Xb4, y4)
    np.testing.assert_array_equal(e4.feature, e1.feature)
    np.testing.assert_array_equal(e4.threshold_bin, e1.threshold_bin)
    np.testing.assert_allclose(e4.leaf_value, e1.leaf_value, rtol=1e-5,
                               atol=1e-6)


def test_cpu_backend_never_quietly_numpy(monkeypatch):
    """use_native=True raises when the library cannot be had; the default
    falls back to NumPy and says so in hist_impl."""
    def unavailable():
        raise ImportError("native kernels unavailable: no g++")

    monkeypatch.setattr(native, "load", unavailable)
    with pytest.raises(ImportError, match="native"):
        CPUDevice(_cfg(n_bins=31), use_native=True)
    assert CPUDevice(_cfg(n_bins=31)).hist_impl == "numpy"
