"""File ingestion (data/datasets.load_file, which the streamed path
uses too) and the model artifact's preprocessing through the port's
CLI, against ddt_tpu on the CPU (mirrors tests/test_datasets_io.py case
by case).

Each loader case writes one file and reads it through both packages'
load_file: the arrays are held equal exactly (values, shapes, dtypes),
and a refused file raises the same error in both.
"""

import gzip
import json

import numpy as np
import pytest

from ddt_tpu.data import datasets as jdatasets
from ddt_tpu_torch import api
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets


def _both(path, **kw):
    """load_file of both packages; their results are equal exactly."""
    X, y = datasets.load_file(path, **kw)
    jX, jy = jdatasets.load_file(path, **kw)
    for a, b in ((X, jX), (y, jy)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return X, y


def _refused(path, match, **kw):
    with pytest.raises(ValueError, match=match):
        datasets.load_file(path, **kw)
    with pytest.raises(ValueError, match=match):
        jdatasets.load_file(path, **kw)


def test_load_npz_roundtrip(tmp_path):
    X = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    p = str(tmp_path / "d.npz")
    np.savez(p, X=X, y=y)
    X2, y2 = _both(p)
    np.testing.assert_array_equal(X2, X)
    np.testing.assert_array_equal(y2, y)
    assert y2.dtype == np.int32


def test_load_npz_missing_keys_raises(tmp_path):
    p = str(tmp_path / "bad.npz")
    np.savez(p, a=np.zeros(3))
    _refused(p, "must contain arrays 'X' and 'y'")


def test_load_csv_higgs_convention(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((30, 5)).astype(np.float32)
    y = rng.integers(0, 2, 30)
    p = str(tmp_path / "higgs.csv")
    np.savetxt(p, np.column_stack([y.astype(np.float64), X]), delimiter=",")
    X2, y2 = _both(p)
    np.testing.assert_allclose(X2, X, rtol=1e-6)
    np.testing.assert_array_equal(y2, y)


def test_load_csv_covertype_convention(tmp_path):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((40, 6)).astype(np.float32) * 10 + 100
    y = rng.integers(1, 8, 40)
    p = str(tmp_path / "covtype.csv")
    np.savetxt(p, np.column_stack([X, y.astype(np.float64)]), delimiter=",")
    X2, y2 = _both(p, label_col="last")
    np.testing.assert_allclose(X2, X, rtol=1e-6)
    np.testing.assert_array_equal(y2, y - 1)


def test_load_csv_gz_with_header_and_auto_label(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((25, 3))
    y = rng.integers(0, 2, 25)
    p = str(tmp_path / "d.csv.gz")
    lines = ["label,f0,f1,f2"]
    for i in range(25):
        lines.append(",".join([str(y[i])] + [f"{v:.6f}" for v in X[i]]))
    with gzip.open(p, "wt") as f:
        f.write("\n".join(lines) + "\n")
    X2, y2 = _both(p)
    assert X2.shape == (25, 3)
    np.testing.assert_array_equal(y2, y)


def test_load_libsvm_sparse(tmp_path):
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("1 1:0.5 3:2.0\n0 2:-1.0\n# comment line\n"
                "1 1:1.0 4:4.0  # trailing comment\n")
    X, y = _both(p)
    np.testing.assert_allclose(
        X, [[0.5, 0, 2.0, 0], [0, -1.0, 0, 0], [1.0, 0, 0, 4.0]])
    np.testing.assert_array_equal(y, [1, 0, 1])


def test_load_libsvm_bad_line_raises(tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("1 0:0.5\n")
    _refused(p, "bad libsvm line")


def test_load_libsvm_minus_one_plus_one_labels(tmp_path):
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("-1 1:0.5\n+1 2:1.0\n-1 1:2.0\n")
    _, y = _both(p)
    np.testing.assert_array_equal(y, [0, 1, 0])


def test_load_npz_labels_verbatim(tmp_path):
    p = str(tmp_path / "d.npz")
    yc = np.arange(1, 41)
    np.savez(p, X=np.zeros((40, 2), np.float32), y=yc)
    _, y = _both(p)
    np.testing.assert_array_equal(y, yc)


def test_load_csv_regression_labels_not_normalized(tmp_path):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((20, 3))
    yc = rng.integers(1, 6, 20)
    p = str(tmp_path / "r.csv")
    np.savetxt(p, np.column_stack([X, yc.astype(np.float64)]), delimiter=",")
    _, y = _both(p, label_col="last", normalize_labels=False)
    np.testing.assert_array_equal(y, yc)


def test_cli_label_col_last_for_regression(tmp_path, capsys):
    X, yt = datasets.synthetic_regression(800, n_features=6, seed=9)
    p = str(tmp_path / "r.csv")
    np.savetxt(p, np.column_stack([X, yt.astype(np.float64)]), delimiter=",")
    assert main(["train", "--device=cpu", f"--data={p}", "--label-col=last",
                 "--loss=mse", "--trees=3", "--depth=3", "--bins=31",
                 f"--out={tmp_path / 'm.npz'}"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["final_train_loss"] < np.var(yt) * 0.7


def test_cli_criteo_predict_refuses_missing_encoder(tmp_path):
    X, y = datasets.synthetic_binary(500, n_features=8, seed=1)
    res = api.train(X, y, n_trees=2, max_depth=2, n_bins=31, device="cpu")
    model = str(tmp_path / "no_enc.npz")
    res.save(model)
    with pytest.raises(SystemExit, match="categorical encoder"):
        main(["predict", "--device=cpu", f"--model={model}",
              "--dataset=criteo", "--rows=100", "--bins=31"])


def test_load_libsvm_n_features_pins_width(tmp_path):
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("1 1:0.5 2:1.0\n0 1:2.0\n")
    X, _ = _both(p, n_features=5)
    assert X.shape == (2, 5)
    _refused(p, "exceeds n_features", n_features=1)


def test_load_libsvm_dense_guardrail(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "_LIBSVM_DENSE_MAX_ELEMS", 10)
    monkeypatch.setattr(jdatasets, "_LIBSVM_DENSE_MAX_ELEMS", 10)
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("1 20:0.5\n")
    _refused(p, "dense-only")


def test_labels_not_shifted_when_class_zero_merely_absent(tmp_path):
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("1 1:0.5\n1 1:1.5\n")
    _, y = _both(p)
    np.testing.assert_array_equal(y, [1, 1])
    p2 = str(tmp_path / "d2.libsvm")
    with open(p2, "w") as f:
        f.write("1 1:0.5\n3 1:1.5\n")
    _, y2 = _both(p2)
    np.testing.assert_array_equal(y2, [1, 3])


def test_cli_predict_rejects_wrong_width_file(tmp_path, capsys):
    X, y = datasets.synthetic_binary(800, n_features=8, seed=0)
    ptrain = str(tmp_path / "t.npz")
    np.savez(ptrain, X=X, y=y)
    model = str(tmp_path / "m.npz")
    assert main(["train", "--device=cpu", f"--data={ptrain}", "--trees=2",
                 "--depth=2", "--bins=31", f"--out={model}"]) == 0
    capsys.readouterr()
    pbad = str(tmp_path / "bad.npz")
    np.savez(pbad, X=X[:, :5], y=y)
    with pytest.raises(ValueError, match="expected 8 feature columns"):
        main(["predict", "--device=cpu", f"--model={model}",
              f"--data={pbad}"])


def test_load_csv_comment_before_header(tmp_path):
    p = str(tmp_path / "c.csv")
    with open(p, "w") as f:
        f.write("# exported 2026-07-30\n\nlabel,f0,f1\n1,0.5,0.2\n0,1.5,0.8\n")
    X, y = _both(p)
    assert X.shape == (2, 2)
    np.testing.assert_array_equal(y, [1, 0])


def test_load_csv_auto_refuses_float_targets(tmp_path):
    M = np.random.default_rng(6).standard_normal((20, 4))
    p = str(tmp_path / "r.csv")
    np.savetxt(p, M, delimiter=",")
    _refused(p, "label_col")
    X, _ = _both(p, label_col="last")
    assert X.shape == (20, 3)


def test_load_file_max_rows(tmp_path):
    p = str(tmp_path / "d.npz")
    np.savez(p, X=np.zeros((100, 2), np.float32), y=np.zeros(100))
    X, y = _both(p, max_rows=7)
    assert len(X) == 7 and len(y) == 7


def test_train_from_csv_end_to_end(tmp_path, capsys):
    X, y = datasets.synthetic_binary(1500, n_features=8, seed=5)
    p = str(tmp_path / "higgs.csv")
    np.savetxt(p, np.column_stack([y.astype(np.float64), X]), delimiter=",")
    model = str(tmp_path / "m.npz")
    assert main(["train", "--device=cpu", f"--data={p}", "--trees=3",
                 "--depth=3", "--bins=31", f"--out={model}"]) == 0
    bundle = api.load_model(model)
    assert bundle.ensemble.n_trees == 3 and bundle.mapper is not None
    Xf, yf = _both(p)
    want = api.train(Xf, yf, TrainConfig(device="cpu", n_trees=3,
                                         max_depth=3, n_bins=31))
    np.testing.assert_array_equal(bundle.ensemble.leaf_value,
                                  want.ensemble.leaf_value)


def test_save_load_model_bundle_roundtrip(tmp_path):
    from ddt_tpu import api as japi
    from ddt_tpu_torch.data.categorical import fit_categorical_encoder
    from ddt_tpu_torch.models.tree import TreeEnsemble

    X, y = datasets.synthetic_binary(1000, n_features=6, seed=0)
    res = api.train(X, y, n_trees=3, max_depth=3, n_bins=31, device="cpu")
    Xc = np.random.default_rng(0).integers(0, 50, size=(1000, 2))
    enc = fit_categorical_encoder(Xc, n_bins=31)
    p = str(tmp_path / "m.npz")
    api.save_model(p, res.ensemble, mapper=res.mapper, encoder=enc)
    for load in (api.load_model, japi.load_model):
        b = load(p)
        np.testing.assert_array_equal(b.ensemble.feature,
                                      res.ensemble.feature)
        np.testing.assert_array_equal(b.mapper.edges, res.mapper.edges)
        assert b.mapper.n_bins == res.mapper.n_bins
        np.testing.assert_array_equal(b.encoder.transform(Xc),
                                      enc.transform(Xc))
    ens = TreeEnsemble.load(p)
    np.testing.assert_array_equal(ens.feature, res.ensemble.feature)


def test_cli_predict_uses_training_mapper_on_shifted_data(tmp_path, capsys):
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper

    X, y = datasets.synthetic_binary(2000, n_features=8, seed=0)
    ptrain = str(tmp_path / "train.npz")
    np.savez(ptrain, X=X, y=y)
    model = str(tmp_path / "m.npz")
    assert main(["train", "--device=cpu", f"--data={ptrain}", "--trees=4",
                 "--depth=3", "--bins=31", f"--out={model}"]) == 0
    capsys.readouterr()
    Xs = np.square(X[:500]).astype(np.float32)
    pshift = str(tmp_path / "shift.npz")
    np.savez(pshift, X=Xs, y=y[:500])
    sout = str(tmp_path / "scores.npy")
    assert main(["predict", "--device=cpu", f"--model={model}",
                 f"--data={pshift}", f"--out={sout}"]) == 0
    bundle = api.load_model(model)
    want = api.predict(bundle.ensemble, Xs, mapper=bundle.mapper,
                       device="cpu")
    np.testing.assert_array_equal(np.load(sout), want)
    refit = fit_bin_mapper(Xs, n_bins=31, seed=0)
    assert (refit.transform(Xs) != bundle.mapper.transform(Xs)).any()


def test_cli_predict_refuses_a_mapperless_model(tmp_path):
    """The port scores binned rows only: a model file without its bin
    mapper is refused for float rows."""
    X, y = datasets.synthetic_binary(400, n_features=5, seed=2)
    res = api.train(X, y, n_trees=2, max_depth=2, n_bins=15, device="cpu")
    p = str(tmp_path / "bare.npz")
    res.ensemble.save(p)
    with pytest.raises(SystemExit, match="no bin mapper"):
        main(["predict", "--device=cpu", f"--model={p}", "--rows=50"])
