"""Instance weights (sample_weight) in the port, mirroring
tests/test_sample_weight.py against ddt_tpu on the CPU.

The anchor: integer weights are exactly row duplication. Histograms add,
the base score is the weighted mean and the loss the weighted mean, and
an integer multiple of a gradient is exact in f32, so the trees come out
identical in structure (leaves to 2e-4, as the reference holds them:
duplication sums the same terms in another order). All-ones weights give
the unweighted trees bitwise (a multiply by 1.0 is exact). The fused
round equals the granular loop bitwise with weights. Against the
reference's trainer on JAX-CPU, weighted trees match structure exactly
and leaves to 2e-4.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data.datasets import synthetic_regression
from ddt_tpu.ops import grad as jgrad
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.ops import grad

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


def _dup_problem(seed=7, rows=2000):
    X, y = datasets.synthetic_binary(rows, n_features=8, seed=seed)
    Xb, _ = quantize(X, n_bins=31, seed=seed)
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 4, rows)            # integer weights 1..3
    idx = np.repeat(np.arange(rows), w)
    return Xb, y, w, Xb[idx], y[idx]


def _fit(cfg, Xb, y, **kw):
    return Driver(get_backend(cfg), cfg).fit(Xb, y, **kw)


@pytest.mark.parametrize("fused", [True, False])
def test_integer_weights_equal_duplication(fused):
    """(f32 gradients: quantized ones take their grid from max|g * w| and
    round per row id, which duplication changes.)"""
    Xb, y, w, Xd, yd = _dup_problem()
    cfg = TrainConfig(n_trees=5, max_depth=4, n_bins=31, device="cpu")

    class Granular(CUDADevice):
        grow_rounds = None

    be = get_backend(cfg) if fused else Granular(cfg)
    wtd = Driver(be, cfg).fit(Xb, y, sample_weight=w.astype(np.float64))
    dup = Driver(be, cfg).fit(Xd, yd)
    np.testing.assert_array_equal(wtd.feature, dup.feature)
    np.testing.assert_array_equal(wtd.threshold_bin, dup.threshold_bin)
    np.testing.assert_array_equal(wtd.is_leaf, dup.is_leaf)
    np.testing.assert_allclose(wtd.leaf_value, dup.leaf_value, rtol=2e-4,
                               atol=2e-5)
    assert abs(wtd.base_score - dup.base_score) < 1e-6


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_all_ones_weights_equal_no_weights_bitwise(grad_dtype):
    Xb, y, _, _, _ = _dup_problem(seed=2)
    cfg = TrainConfig(n_trees=4, max_depth=4, n_bins=31, device="cpu",
                      grad_dtype=grad_dtype, subsample=0.8, seed=4)
    a = _fit(cfg, Xb, y)
    b = _fit(cfg, Xb, y, sample_weight=np.ones(len(y)))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("loss", ["logloss", "softmax"])
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_weighted_fused_equals_granular_bitwise(grad_dtype, loss):
    if loss == "softmax":
        X, y = datasets.synthetic_multiclass(2000, n_features=8,
                                             n_classes=3, seed=5)
    else:
        X, y = datasets.synthetic_binary(2000, n_features=8, seed=5)
    Xb, _ = quantize(X, n_bins=31)
    w = np.random.default_rng(1).integers(0, 4, len(y)).astype(np.float32)
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=31, device="cpu",
                      loss=loss, n_classes=3, grad_dtype=grad_dtype,
                      fused_block_rounds=3)

    class Granular(CUDADevice):
        grow_rounds = None

    fused = Driver(get_backend(cfg), cfg).fit(Xb, y, sample_weight=w)
    gran = Driver(Granular(cfg), cfg).fit(Xb, y, sample_weight=w)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(fused, k), getattr(gran, k))


def test_weighted_loss_is_the_weighted_mean():
    X, y = datasets.synthetic_binary(1500, n_features=8, seed=3)
    Xb, _ = quantize(X, n_bins=31)
    w = np.random.default_rng(3).integers(0, 4, len(y)).astype(np.float32)
    cfg = TrainConfig(n_trees=3, max_depth=3, n_bins=31, device="cpu")
    d = Driver(get_backend(cfg), cfg)
    ens = d.fit(Xb, y, sample_weight=w)
    raw = ens.predict_raw_roundwise(Xb, binned=True)
    per = np.logaddexp(0.0, raw.astype(np.float64)) - raw * y
    want = float((per * w).sum() / w.sum())
    assert d.history[-1]["train_loss"] == pytest.approx(want, rel=1e-5)
    v = torch.from_numpy(w)
    jw = float(jgrad.mean_loss(raw, y, w, "logloss"))
    got = float(grad.mean_loss(torch.from_numpy(raw), torch.from_numpy(y),
                               "logloss", v))
    assert got == pytest.approx(jw, rel=1e-6)


def test_weighted_parity_with_reference():
    Xb, y, w, _, _ = _dup_problem(seed=11)
    kw = dict(n_trees=5, max_depth=4, n_bins=31)
    a = japi.train(Xb, y, JConfig(backend="tpu", **kw), binned=True,
                   sample_weight=w).ensemble
    b = api.train(Xb, y, TrainConfig(device="cpu", **kw), binned=True,
                  sample_weight=w).ensemble
    np.testing.assert_array_equal(b.feature, a.feature)
    np.testing.assert_array_equal(b.threshold_bin, a.threshold_bin)
    np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=2e-4,
                               atol=2e-5)
    assert b.base_score == a.base_score


def test_weights_change_the_model_and_validate():
    Xb, y, w, _, _ = _dup_problem(seed=3)
    kw = dict(n_trees=4, max_depth=3, n_bins=31, binned=True, device="cpu")
    plain = api.train(Xb, y, **kw).ensemble
    wtd = api.train(Xb, y, sample_weight=w * 10.0, **kw).ensemble
    assert not np.array_equal(plain.leaf_value, wtd.leaf_value)
    with pytest.raises(ValueError, match="sample_weight must be"):
        api.train(Xb, y, sample_weight=w[:-1], **kw)
    with pytest.raises(ValueError, match="finite"):
        api.train(Xb, y, sample_weight=np.full(len(y), np.nan), **kw)
    with pytest.raises(ValueError, match="finite"):
        api.train(Xb, y, sample_weight=-np.ones(len(y)), **kw)
    with pytest.raises(ValueError, match="all zero"):
        api.train(Xb, y, sample_weight=np.zeros(len(y)), **kw)


def test_weighted_softmax_and_mse_equal_duplication():
    X, y = datasets.synthetic_multiclass(1500, n_features=8, n_classes=3,
                                         seed=9)
    Xb, _ = quantize(X, n_bins=31, seed=9)
    rng = np.random.default_rng(9)
    w = rng.integers(1, 3, len(y))
    idx = np.repeat(np.arange(len(y)), w)
    kw = dict(n_trees=3, max_depth=3, n_bins=31, binned=True, device="cpu",
              loss="softmax", n_classes=3)
    wtd = api.train(Xb, y, sample_weight=w, **kw).ensemble
    dup = api.train(Xb[idx], y[idx], **kw).ensemble
    np.testing.assert_array_equal(wtd.feature, dup.feature)
    Xr, yr = synthetic_regression(1500, seed=4)
    Xrb, _ = quantize(Xr, n_bins=31, seed=4)
    wr = rng.integers(1, 3, len(yr))
    ir = np.repeat(np.arange(len(yr)), wr)
    kwr = dict(n_trees=3, max_depth=3, n_bins=31, binned=True, device="cpu",
               loss="mse")
    wm = api.train(Xrb, yr, sample_weight=wr, **kwr).ensemble
    dm = api.train(Xrb[ir], yr[ir], **kwr).ensemble
    np.testing.assert_array_equal(wm.feature, dm.feature)
    assert abs(wm.base_score - dm.base_score) < 1e-5
