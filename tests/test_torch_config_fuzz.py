"""Randomized config fuzz for the port, the twin of tests/test_config_fuzz.py:
any valid config (loss x missing x categorical x sampling x weights x bins
x depth x lambda) grows the same trees on the port's CPU oracle
(backend="cpu"), on CUDADevice's plain versions (backend="cuda",
device="cpu") and on the reference's CPU backend (JAX-CPU side, NumPy),
and a run partitioned over gloo ranks grows the one-device trees. Trees
are held with tests/tree_compare.py's comparator (bitwise but for proven
bf16 ties; leaves to its tolerance: the exact int64 sums of the CUDADevice
path and the f32 sums of the oracles part by f32 rounding, and an mse
base score is the f64 label mean against an f32 mean, which moves leaves
by up to ~5e-7). Scores: every scorer path agrees on random models, to
the reference's tolerances. Streamed training (the device loop and the
CPU oracle's host loop) over random chunk bounds and cache budgets grows
the in-memory trees. The generator below is the port's own copy of the
reference's.
"""

import numpy as np
import pytest

from ddt_tpu.backends import get_backend as j_get_backend
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.driver import Driver as JDriver
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cpu import CPUDevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.categorical import fit_categorical_encoder
from ddt_tpu_torch.data.datasets import synthetic_multiclass
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.streaming import fit_streaming
from tree_compare import assert_trees_match_mod_ties

JFIELDS = ("n_trees", "max_depth", "n_bins", "loss", "n_classes",
           "learning_rate", "reg_lambda", "min_split_gain",
           "min_child_weight", "subsample", "colsample_bytree",
           "missing_policy", "cat_features", "seed")


@pytest.fixture(scope="module")
def pool():
    p = spawn.Pool(2, backend="gloo", device="cpu", timeout_s=120.0)
    yield p
    p.close()


def _random_case(rng):
    """(binned rows, labels, config) of one random valid config."""
    rows = int(rng.integers(300, 1500))
    n_num = int(rng.integers(3, 9))
    loss = rng.choice(["logloss", "mse", "softmax"])
    n_classes = int(rng.integers(3, 5)) if loss == "softmax" else 2
    missing = bool(rng.random() < 0.35)
    cat = bool(rng.random() < 0.35) and not missing   # config forbids both
    bins = int(rng.choice([7, 31, 63, 255]))
    X = rng.standard_normal((rows, n_num)).astype(np.float32)
    if loss == "softmax":
        _, y = synthetic_multiclass(rows, n_features=4, n_classes=n_classes,
                                    seed=int(rng.integers(99)))
        y = y[:rows]
    elif loss == "mse":
        y = (X[:, 0] * 1.5 + rng.standard_normal(rows) * 0.3).astype(
            np.float32)
    else:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    cat_features: tuple = ()
    if cat:
        ids = rng.integers(0, 12, size=(rows, 2))
        enc = fit_categorical_encoder(ids, n_bins=bins)
        X = np.concatenate([X, enc.transform(ids).astype(np.float32)],
                           axis=1)
        cat_features = (n_num, n_num + 1)
        y = np.asarray(y)
        if loss == "logloss":
            y = ((X[:, 0] > 0) | (ids[:, 0] == 3)).astype(np.int64)
    if missing:
        X[rng.random(X.shape) < 0.1] = np.nan
    # A noise-floor min_split_gain, and a hessian floor at lambda 0: the
    # determinism boundary of the split rule (ops/split.py).
    lam = float(rng.choice([0.0, 1.0]))
    mcw = float(rng.choice([0.0, 1e-3, 0.5]))
    cfg = TrainConfig(
        n_trees=int(rng.integers(2, 5)), max_depth=int(rng.integers(2, 6)),
        n_bins=bins, loss=str(loss), n_classes=n_classes,
        learning_rate=float(rng.choice([0.1, 0.3])), reg_lambda=lam,
        min_split_gain=1e-3,
        min_child_weight=max(mcw, 1e-3) if lam == 0.0 else mcw,
        subsample=float(rng.choice([1.0, 0.8])),
        colsample_bytree=float(rng.choice([1.0, 0.7])),
        missing_policy="learn" if missing else "zero",
        cat_features=cat_features, seed=int(rng.integers(1000)))
    m = fit_bin_mapper(X, n_bins=bins, missing_policy=cfg.missing_policy,
                       cat_features=cat_features)
    return m.transform(X), np.asarray(y), cfg


def _jcfg(cfg: TrainConfig, backend: str) -> JConfig:
    return JConfig(backend=backend,
                   **{k: getattr(cfg, k) for k in JFIELDS})


def _port(cfg, backend, Xb, y, w):
    c = (cfg.replace(backend="cpu") if backend == "cpu"
         else cfg.replace(backend="cuda", device="cpu"))
    return Driver(get_backend(c), c, log_every=10**9).fit(
        Xb, y, sample_weight=w)


@pytest.mark.parametrize("case_seed", range(15))
def test_random_config_backend_and_partition_identity(pool, case_seed):
    rng = np.random.default_rng((97, case_seed))
    Xb, y, cfg = _random_case(rng)
    w = (rng.integers(1, 4, len(y)).astype(np.float64)
         if rng.random() < 0.35 else None)
    ens = {b: _port(cfg, b, Xb, y, w) for b in ("cpu", "cuda")}
    jc = _jcfg(cfg, "cpu")
    ref = JDriver(j_get_backend(jc), jc, log_every=10**9).fit(
        Xb, y, sample_weight=w)
    g = cfg.min_split_gain
    assert_trees_match_mod_ties(ens["cpu"], ens["cuda"], g)
    assert_trees_match_mod_ties(ref, ens["cpu"], g)
    assert_trees_match_mod_ties(ref, ens["cuda"], g)
    # Two gloo ranks, each on its row block, grow the one-device trees.
    kw = {k: getattr(cfg, k) for k in JFIELDS}
    parts = pool.run(tasks.train, Xb, y, kw,
                     {"binned": True, "sample_weight": w})
    for r in parts:
        assert_trees_match_mod_ties(ens["cuda"], r["ensemble"], g)
    np.testing.assert_array_equal(parts[0]["ensemble"].feature,
                                  parts[1]["ensemble"].feature)
    # Both backends score the oracle's model alike.
    pc = get_backend(cfg.replace(backend="cpu")).predict_raw(ens["cpu"], Xb)
    pt = get_backend(cfg.replace(backend="cuda", device="cpu")
                     ).predict_raw(ens["cpu"], Xb)
    np.testing.assert_allclose(pc, pt, rtol=5e-4, atol=5e-5)


def test_lambda_zero_empty_nodes_have_finite_leaves():
    """reg_lambda=0 and nodes empty at training: leaf 0, not -0/0, on
    both backends, and unseen rows through such nodes score finite."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((120, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    m = fit_bin_mapper(X, n_bins=15)
    Xb = m.transform(X)
    cfg = TrainConfig(n_trees=2, max_depth=6, n_bins=15, reg_lambda=0.0,
                      min_child_weight=0.0)
    X2 = rng.standard_normal((500, 4)).astype(np.float32) * 3
    for backend in ("cpu", "cuda"):
        ens = _port(cfg, backend, Xb, y, None)
        assert np.isfinite(ens.leaf_value).all(), backend
        assert np.isfinite(ens.predict_raw(m.transform(X2),
                                           binned=True)).all(), backend


@pytest.mark.parametrize("trial", range(8))
def test_random_model_predict_paths_agree(tmp_path, trial):
    """Every scorer of a random oracle model (missing and categorical
    included) agrees: the native traversal and the reference's NumPy
    scorer on the saved model exactly; CUDADevice's plain traversal,
    api.predict from raw floats and the float raw thresholds within the
    reference's 3e-4."""
    rng = np.random.default_rng((31, trial))
    rows = int(rng.integers(200, 1200))
    F = int(rng.integers(3, 9))
    bins = int(rng.choice([7, 31, 63, 255]))
    loss = str(rng.choice(["logloss", "mse", "softmax"]))
    nc = int(rng.integers(3, 5)) if loss == "softmax" else 2
    missing = bool(rng.random() < 0.4)
    cat = bool(rng.random() < 0.4) and not missing
    X = rng.standard_normal((rows, F)).astype(np.float32)
    catf: tuple = ()
    if cat:
        ids = rng.integers(0, 10, size=(rows, 1))
        enc = fit_categorical_encoder(ids, n_bins=bins)
        X = np.concatenate([X, enc.transform(ids).astype(np.float32)], 1)
        catf = (F,)
    if missing:
        X[rng.random(X.shape) < 0.1] = np.nan
    y = (rng.integers(0, nc, rows) if loss == "softmax"
         else (np.nan_to_num(X[:, 0]) > 0).astype(np.int64)
         if loss == "logloss"
         else rng.standard_normal(rows).astype(np.float32))
    res = api.train(X, y, n_trees=int(rng.integers(2, 5)),
                    max_depth=int(rng.integers(2, 5)), n_bins=bins,
                    loss=loss, n_classes=nc, backend="cpu",
                    missing_policy="learn" if missing else "zero",
                    cat_features=catf, log_every=10**9)
    ens, m = res.ensemble, res.mapper
    Xb = m.transform(X)
    want = ens.predict_raw(Xb, binned=True)
    path = str(tmp_path / "m.npz")
    ens.save(path)
    exact = {
        "native": CPUDevice(TrainConfig(backend="cpu", n_bins=bins,
                                        cat_features=catf),
                            use_native=True).predict_raw(ens, Xb),
        "reference_numpy": JEnsemble.load(path).predict_raw(Xb,
                                                            binned=True),
    }
    for name, got in exact.items():
        np.testing.assert_array_equal(want, got, err_msg=name)
    approx = {
        "cuda_plain": get_backend(TrainConfig(
            n_bins=bins, cat_features=catf, device="cpu")).predict_raw(
                ens, Xb),
        "api_raw_mapper": api.predict(ens, X, mapper=m, raw=True,
                                      device="cpu"),
        "raw_thresholds": ens.predict_raw(X, binned=False),
    }
    for name, got in approx.items():
        np.testing.assert_allclose(want, got, rtol=3e-4, atol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case_seed", range(5))
def test_random_config_streaming_identity(case_seed):
    """fit_streaming over random chunk bounds and a random device chunk
    cache budget grows the in-memory trees, on the device loop
    (CUDADevice on the CPU) and on the oracle's host loop (cache_preds
    drawn too)."""
    rng = np.random.default_rng((113, case_seed))
    Xb, y, cfg = _random_case(rng)
    rows = len(y)
    n_chunks = int(rng.integers(2, 6))
    bounds = np.linspace(0, rows, n_chunks + 1).astype(int)

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    chunk_fn.labels = lambda c: y[bounds[c]:bounds[c + 1]]
    chunk_fn.n_features = Xb.shape[1]
    budget = int(rng.integers(0, Xb.nbytes + 1))   # 0 = no caching
    cache_preds = bool(rng.random() < 0.5)
    for backend in ("cuda", "cpu"):
        full = _port(cfg, backend, Xb, y, None)
        c = (cfg.replace(backend="cpu") if backend == "cpu"
             else cfg.replace(device="cpu"))
        streamed = fit_streaming(chunk_fn, n_chunks, c,
                                 device_chunk_cache=budget,
                                 cache_preds=cache_preds)
        assert_trees_match_mod_ties(full, streamed, cfg.min_split_gain)
