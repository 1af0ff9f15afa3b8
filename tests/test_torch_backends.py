"""The port's two backends through one Driver, against tests/test_backends.py:
the CPU oracle (TrainConfig(backend="cpu"): backends/cpu.CPUDevice, the
NumPy trainer with the native C++ kernels) and CUDADevice on the CPU
(backend="cuda", device="cpu": the kernels' plain versions; the
reference's "tpu" reads as the port's "cuda").

Tolerances, as the reference states them: the oracle's trees have the
CUDADevice's exact structure and leaves within rtol 2e-4 / atol 2e-5
(its f32 sums are exact fixed point, the oracle's are f32 adds), and
the port's oracle equals the reference's CPU backend bitwise on the same
inputs (the same NumPy trainer and C++ kernels, driven by each
package's Driver).
"""

import numpy as np
import pytest

from ddt_tpu.backends import get_backend as jget_backend
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.driver import Driver as JDriver
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import CPUDevice, CUDADevice, get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain")


def _small_problem(rows=2000, loss="logloss", seed=0, bins=31):
    if loss == "softmax":
        X, y = datasets.synthetic_multiclass(rows, n_features=12, seed=seed)
    elif loss == "mse":
        X, y = datasets.synthetic_regression(rows, n_features=8, seed=seed)
    else:
        X, y = datasets.synthetic_binary(rows, n_features=10, seed=seed)
    Xb, mapper = quantize(X, n_bins=bins, seed=seed)
    return Xb, y, mapper


def _cfg(backend, **kw):
    dev = {"device": "cpu"} if backend == "cuda" else {}
    return TrainConfig(**{"n_trees": 5, "max_depth": 4, "n_bins": 31,
                          "backend": backend, **dev, **kw})


def _fit(backend, Xb, y, **kw):
    cfg = _cfg(backend, **kw)
    return Driver(get_backend(cfg), cfg, log_every=10**9).fit(Xb, y), cfg


def _parity(a, b):
    np.testing.assert_array_equal(a.feature, b.feature)
    np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
    np.testing.assert_array_equal(a.is_leaf, b.is_leaf)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("loss,extra", [
    ("logloss", {}),
    ("mse", {}),
    ("softmax", {"n_classes": 7}),
])
def test_backend_parity_cpu_vs_cuda(loss, extra):
    Xb, y, _ = _small_problem(loss=loss)
    ens_cpu, _ = _fit("cpu", Xb, y, loss=loss, **extra)
    ens_cuda, _ = _fit("cuda", Xb, y, loss=loss, **extra)
    _parity(ens_cpu, ens_cuda)
    # The oracle is the reference's CPU backend, bit for bit.
    jcfg = JConfig(n_trees=5, max_depth=4, n_bins=31, backend="cpu",
                   loss=loss, **extra)
    jens = JDriver(jget_backend(jcfg), jcfg, log_every=10**9).fit(Xb, y)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ens_cpu, k), getattr(jens, k),
                                      err_msg=k)


def test_backend_registry_flag():
    assert get_backend(TrainConfig(backend="cpu")).name == "cpu"
    assert isinstance(get_backend(TrainConfig(backend="cpu")), CPUDevice)
    be = get_backend(TrainConfig(backend="cuda", device="cpu"))
    assert isinstance(be, CUDADevice) and be.name == "cuda"
    for bad in ("tpu", "fpga"):
        with pytest.raises(ValueError):
            TrainConfig(backend=bad)
    with pytest.raises(NotImplementedError, match="grad_dtype"):
        CPUDevice(TrainConfig(backend="cpu", grad_dtype="int8"))


def test_granular_kernel_contract_via_backend():
    from ddt_tpu_torch.reference import numpy_trainer as ref

    rng = np.random.default_rng(3)
    R, F, B, N = 512, 6, 16, 4
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(-1, N, size=R).astype(np.int32)
    want_h = ref.build_histograms(Xb, g, h, ni, N, B)
    want_s = ref.best_splits(want_h, 1.0, 1e-3)
    for cfg in (TrainConfig(backend="cpu", n_bins=B),
                TrainConfig(device="cpu", n_bins=B)):
        be = get_backend(cfg)
        got_h = np.asarray(be.build_histograms(be.upload(Xb), g, h, ni, N))
        np.testing.assert_allclose(got_h, want_h, rtol=1e-5, atol=1e-5)
        _, feats, bins = be.best_splits(got_h)
        np.testing.assert_array_equal(np.asarray(feats), want_s[1])
        np.testing.assert_array_equal(np.asarray(bins), want_s[2])


def test_api_train_predict_roundtrip(tmp_path):
    from ddt_tpu_torch.models.tree import TreeEnsemble

    X, y = datasets.synthetic_binary(3000, n_features=10, seed=1)
    res = api.train(X, y, n_trees=10, max_depth=4, n_bins=31,
                    backend="cpu", log_every=10**9)
    assert res.ensemble.n_trees == 10 and res.ensemble.has_raw_thresholds
    p_np = api.predict(res.ensemble, X, mapper=res.mapper,
                       backend=get_backend(TrainConfig(backend="cpu")))
    assert p_np[y == 1].mean() - p_np[y == 0].mean() > 0.1
    be = get_backend(TrainConfig(device="cpu", n_bins=31))
    Xb = res.mapper.transform(X)
    p_dev = api.predict(res.ensemble, Xb, binned=True, backend=be)
    np.testing.assert_allclose(p_dev, p_np, rtol=2e-4, atol=2e-5)
    path = str(tmp_path / "ens.npz")
    res.ensemble.save(path)
    np.testing.assert_array_equal(TreeEnsemble.load(path).feature,
                                  res.ensemble.feature)


def _resume(cfg, Xb, y, ck):
    full = Driver(get_backend(cfg), cfg, log_every=10**9).fit(Xb, y)
    six = cfg.replace(n_trees=6)
    Driver(get_backend(six), six, log_every=10**9, checkpoint_dir=ck,
           checkpoint_every=3).fit(Xb, y)
    resumed = Driver(get_backend(cfg), cfg, log_every=10**9,
                     checkpoint_dir=ck, checkpoint_every=5).fit(Xb, y)
    return full, resumed


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    Xb, y, _ = _small_problem(rows=1500)
    full, resumed = _resume(_cfg("cpu", n_trees=10), Xb, y,
                            str(tmp_path / "ck"))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))
    assert np.any(resumed.split_gain[:6] > 0)


def test_checkpoint_resume_with_sampling_matches_uninterrupted(tmp_path):
    Xb, y, _ = _small_problem(rows=1500)
    cfg = _cfg("cpu", n_trees=10, subsample=0.75, colsample_bytree=0.7,
               seed=11)
    full, resumed = _resume(cfg, Xb, y, str(tmp_path / "ck"))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))
    assert np.any(resumed.split_gain[:6] > 0)
    # The oracle's sampled trees are the CUDADevice's.
    _parity(full, Driver(get_backend(cfg.replace(backend="cuda",
                                                 device="cpu")),
                         cfg, log_every=10**9).fit(Xb, y))


def test_streaming_checkpoint_resume_with_sampling(tmp_path):
    """The streamed twin on CUDADevice (device="cpu") and on the oracle's
    host loop (backend="cpu"): each resumed run equals its uninterrupted
    one bitwise."""
    from ddt_tpu_torch.streaming import fit_streaming

    Xb, y, _ = _small_problem(rows=2000)
    cfg = _cfg("cuda", n_trees=8, max_depth=3, subsample=0.8,
               colsample_bytree=0.7, seed=5)

    def cf(c):
        return Xb[c * 500:(c + 1) * 500], y[c * 500:(c + 1) * 500]

    full = fit_streaming(cf, 4, cfg)
    ck = str(tmp_path / "ck")
    fit_streaming(cf, 4, cfg.replace(n_trees=4), checkpoint_dir=ck,
                  checkpoint_every=2)
    resumed = fit_streaming(cf, 4, cfg, checkpoint_dir=ck,
                            checkpoint_every=4)
    for k in ("feature", "threshold_bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))
    host = cfg.replace(backend="cpu")
    full = fit_streaming(cf, 4, host)
    ck = str(tmp_path / "ck_host")
    fit_streaming(cf, 4, host.replace(n_trees=4), checkpoint_dir=ck,
                  checkpoint_every=2)
    resumed = fit_streaming(cf, 4, host, checkpoint_dir=ck,
                            checkpoint_every=4)
    for k in ("feature", "threshold_bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))


def test_checkpoint_config_mismatch_refuses(tmp_path):
    Xb, y, _ = _small_problem(rows=500)
    ck = str(tmp_path / "ck")
    cfg = _cfg("cpu", n_trees=4, max_depth=3)
    Driver(get_backend(cfg), cfg, log_every=10**9, checkpoint_dir=ck,
           checkpoint_every=2).fit(Xb, y)
    bad = cfg.replace(max_depth=5)
    with pytest.raises(ValueError, match="incompatible"):
        Driver(get_backend(bad), bad, log_every=10**9,
               checkpoint_dir=ck).fit(Xb, y)
    # The backend is outside the fingerprint: CUDADevice resumes it.
    other = cfg.replace(backend="cuda", device="cpu", n_trees=6)
    ens = Driver(get_backend(other), other, log_every=10**9,
                 checkpoint_dir=ck, checkpoint_every=2).fit(Xb, y)
    assert ens.n_trees == 6


def test_driver_history_logging():
    Xb, y, _ = _small_problem(rows=800)
    cfg = _cfg("cpu", n_trees=6, max_depth=3)
    d = Driver(get_backend(cfg), cfg, log_every=2)
    d.fit(Xb, y)
    assert len(d.history) == 3 and d.history[-1]["round"] == 6
    losses = [r["train_loss"] for r in d.history]
    assert losses == sorted(losses, reverse=True)


@pytest.mark.parametrize("depth,bins,loss", [
    (1, 2, "logloss"),
    (2, 3, "mse"),
    (8, 17, "logloss"),
    (3, 256, "logloss"),
    (2, 63, "softmax"),
])
def test_backend_parity_edge_configs(depth, bins, loss):
    from ddt_tpu_torch.data.datasets import (synthetic_binary,
                                             synthetic_multiclass)

    if loss == "softmax":
        X, y = synthetic_multiclass(1200, n_features=5, n_classes=3, seed=7)
        extra = dict(loss="softmax", n_classes=3)
    else:
        X, y = synthetic_binary(1200, n_features=5, seed=7)
        if loss == "mse":
            y = y + 0.1 * np.random.default_rng(0).standard_normal(len(y))
        extra = dict(loss=loss)
    Xb, _ = quantize(X, n_bins=bins, seed=7)
    kw = dict(n_trees=3, max_depth=depth, n_bins=bins, seed=7, **extra)
    ec = api.train(Xb, y, TrainConfig(backend="cpu", **kw), binned=True,
                   log_every=10**9).ensemble
    et = api.train(Xb, y, TrainConfig(device="cpu", **kw), binned=True,
                   log_every=10**9).ensemble
    _parity(ec, et)


def test_api_predict_accepts_model_bundle(tmp_path):
    X, y = datasets.synthetic_binary(1500, n_features=6, seed=2)
    res = api.train(X, y, n_trees=4, max_depth=3, n_bins=31,
                    backend="cpu", log_every=10**9)
    p = str(tmp_path / "m.npz")
    res.save(p)
    be = get_backend(TrainConfig(backend="cpu"))
    got = api.predict(api.load_model(p), X, backend=be)
    want = api.predict(res.ensemble, X, mapper=res.mapper, backend=be)
    np.testing.assert_array_equal(got, want)


def test_predict_backend_row_chunking_identity():
    """The oracle's scoring of rows cut at any point equals its scoring
    of the whole batch (a row's score never depends on its batch), the
    host oracle within f32 summation, and CUDADevice's."""
    Xb, y, _ = _small_problem()
    ens, cfg = _fit("cpu", Xb, y, n_trees=6)
    be = get_backend(cfg)
    want = be.predict_raw(ens, Xb)
    cut = 96 * 7 + 13
    got = np.concatenate([be.predict_raw(ens, Xb[:cut]),
                          be.predict_raw(ens, Xb[cut:])])
    np.testing.assert_array_equal(want, got)
    np.testing.assert_allclose(got, ens.predict_raw(Xb, binned=True),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        got, get_backend(_cfg("cuda")).predict_raw(ens, Xb), rtol=3e-4,
        atol=3e-4)


@pytest.mark.parametrize("block_rounds", [3, 4])
def test_fused_block_cap_multi_block_identity(block_rounds):
    Xb, y, _ = _small_problem()
    one_block, _ = _fit("cuda", Xb, y, n_trees=10)
    multi, _ = _fit("cuda", Xb, y, n_trees=10,
                    fused_block_rounds=block_rounds)
    cpu, _ = _fit("cpu", Xb, y, n_trees=10)
    for k in FIELDS + ("default_left",):
        a, b = getattr(one_block, k), getattr(multi, k)
        if a is None or b is None:
            assert a is b, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(cpu.feature, multi.feature)


@pytest.mark.parametrize("use_native", [True, False])
def test_cpu_backend_eval_set_matches_cuda(use_native):
    """The oracle's eval step (eval_round: each round's trees routed
    through the eval rows, the metric on the host) agrees with
    CUDADevice's device metric, and early stopping picks the same
    round; the native and NumPy routings agree exactly."""
    X, y = datasets.synthetic_binary(3000, n_features=8, seed=1)
    Xv, yv = datasets.synthetic_binary(800, n_features=8, seed=2)
    kw = dict(log_every=10**9, eval_set=(Xv, yv), eval_metric="logloss",
              early_stopping_rounds=2)
    cfg = TrainConfig(backend="cpu", n_trees=12, max_depth=4, n_bins=31,
                      learning_rate=0.5)
    cpu = api.train(X, y, cfg,
                    backend=CPUDevice(cfg, use_native=use_native), **kw)
    dev = api.train(X, y, cfg.replace(backend="cuda", device="cpu"), **kw)
    a = [h["valid_logloss"] for h in cpu.history]
    b = [h["valid_logloss"] for h in dev.history]
    np.testing.assert_allclose(a, b, rtol=1e-5)
    assert cpu.best_round == dev.best_round
    _parity(cpu.ensemble, dev.ensemble)
