"""Exact, order-free f32 histograms (ops/grad "EXACT f32 HISTOGRAMS") on
the CPU: the plain version of K1's exact mode and what the f32 training
path builds on it.

- The fixed-point grid: one row's q fits 32 bits and any sum over the
  global rows fits 63 (the bound in ops/grad.fixed_scales), and the
  rounding rint(g * 2^k) equals numpy's float64 rint of the exact
  product, ties to even.
- The int64 histogram is bitwise the same under a row permutation, over
  chunks accumulated into one table, and summed over any number of row
  blocks (the partitions' local tables), and converted once it stays
  within the f32 tolerance of ddt_tpu's segment histogram (rtol = atol =
  1e-5, the bound tests/test_torch_hist.py holds the f32 plain version
  to).
- The split search on an int64 histogram equals the f32 search on the
  same sums where f32 holds them exactly (small integers, scale 1).
- f32 training: a resumed run equals the uninterrupted one bit for bit,
  and a permutation-free refit is bitwise (the sums do not depend on the
  order).
- Heavy tails (gradients spread over ~1e6, where the grid keeps fewer
  bits of a small row than f32 does): each converted cell stays within
  the grid's rounding bound of the reference's segment histogram, and
  the trees of a squared-loss run with outlier targets or weights match
  ddt_tpu's f32 trees except at provable ties (tests/tree_compare.py).
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.ops.histogram import build_histograms_segment as j_segment
from ddt_tpu_torch import api as tapi
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_multiclass
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.ops import grad, histogram, split
from tree_compare import assert_trees_match_mod_ties

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


def _case(R, F, B, N, seed=0, frozen=0.2):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    g[::5] *= np.float32(1e-4)            # small values beside large ones
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(0, N, size=R).astype(np.int32)
    ni[rng.random(R) < frozen] = -1
    return [torch.from_numpy(a) for a in (Xb, g, h, ni)]


def _scales(g, h, n_rows=None):
    return grad.fixed_scales(grad.abs_max2(g, h),
                             g.shape[0] if n_rows is None else n_rows)


@pytest.mark.parametrize("max_abs,n_rows", [
    (1.0, 1000), (0.25, 1), (3.0e-30, 10**6), (7.5e30, 10**6),
    (1.0, 10_000_000_000), (0.0, 5), (1.0, 2**40)])
def test_fixed_scales_keep_rows_in_32_bits_and_sums_in_63(max_abs, n_rows):
    sc = grad.fixed_scales(torch.tensor([max_abs, max_abs],
                                        dtype=torch.float32), n_rows)
    k = np.log2(sc.numpy().astype(np.float64))
    assert np.all(k == np.round(k))                      # powers of two
    q = abs(np.float64(np.float32(max_abs)) * 2.0 ** k[0])
    assert np.rint(q) <= 2**30 < 2**31                   # one row: int32
    assert n_rows * np.rint(q) < 2**63                   # the sum: int64
    # The inverse is exact.
    inv = grad.fixed_inverse(sc).numpy().astype(np.float64)
    np.testing.assert_array_equal(inv * sc.numpy(), [1.0, 1.0])


def test_to_fixed_rounds_the_exact_product_half_to_even():
    g = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.0, 1e-45, -1e-38, 0.0,
                  -0.0, 0.49999997, 1.0], np.float32)
    rng = np.random.default_rng(1)
    g = np.concatenate([g, rng.standard_normal(1000).astype(np.float32)])
    for k in (0, 1, 20, 30, -3):
        sc = torch.tensor(2.0 ** k, dtype=torch.float32)
        got = grad.to_fixed(torch.from_numpy(g), sc).numpy()
        want = np.rint(g.astype(np.float64) * 2.0 ** k).astype(np.int64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R,F,B,N", [
    (3000, 6, 255, 8), (2049, 5, 128, 32), (999, 7, 64, 16),
    (64, 3, 255, 1)])
def test_fixed_hist_is_order_free(R, F, B, N):
    Xb, g, h, ni = _case(R, F, B, N, seed=R)
    sc = _scales(g, h)
    whole = histogram.build_histograms_exact(Xb, g, h, ni, N, B, sc)
    assert whole.dtype == torch.int64
    perm = torch.from_numpy(np.random.default_rng(2).permutation(R))
    assert torch.equal(histogram.build_histograms_exact(
        Xb[perm], g[perm], h[perm], ni[perm], N, B, sc), whole)
    # Chunks accumulated into one table.
    acc = torch.zeros_like(whole)
    for lo in range(0, R, 700):
        sl = slice(lo, lo + 700)
        histogram.build_histograms_exact(Xb[sl], g[sl], h[sl], ni[sl], N,
                                         B, sc, out=acc)
    assert torch.equal(acc, whole)
    # Any number of row blocks (the ranks' local tables), summed.
    for P in (2, 3, 4):
        parts = [histogram.build_histograms_exact(
            Xb[i::P], g[i::P], h[i::P], ni[i::P], N, B, sc)
            for i in range(P)]
        assert torch.equal(torch.stack(parts).sum(0), whole)


@pytest.mark.parametrize("R,F,B,N", [
    (3000, 6, 255, 8), (2049, 5, 128, 32), (999, 7, 64, 16)])
def test_fixed_hist_within_f32_tolerance_of_reference(R, F, B, N):
    Xb, g, h, ni = _case(R, F, B, N, seed=7)
    sc = _scales(g, h)
    got = grad.from_fixed(
        histogram.build_histograms_exact(Xb, g, h, ni, N, B, sc), sc)
    want = np.asarray(j_segment(*(a.numpy() for a in (Xb, g, h, ni)), N, B))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fixed_hist_heavy_tail_within_grid_bound_of_reference():
    """g and h spread over ~1e6 (a few rows 1e5-1e6 times the typical
    one): every cell differs from the reference's f32 segment sum by at
    most its rows' rounding, n_cell half-steps of the 2^-k grid, beside
    f32's own 1e-5 of the cell's |sum|."""
    R, F, B, N = 4000, 4, 31, 8
    Xb, g, h, ni = _case(R, F, B, N, seed=11, frozen=0.0)
    rng = np.random.default_rng(12)
    big = rng.choice(R, 6, replace=False)
    g[big] *= torch.from_numpy(10.0 ** rng.uniform(5, 6, 6)).float()
    h[big] *= torch.from_numpy(10.0 ** rng.uniform(5, 6, 6)).float()
    sc = _scales(g, h)
    got = grad.from_fixed(
        histogram.build_histograms_exact(Xb, g, h, ni, N, B, sc),
        sc).numpy().astype(np.float64)
    a = (Xb.numpy(), g.numpy(), h.numpy(), ni.numpy())
    want = np.asarray(j_segment(*a, N, B), np.float64)
    count = np.asarray(j_segment(a[0], np.ones(R, np.float32),
                                 np.ones(R, np.float32), a[3], N, B))
    absum = np.asarray(j_segment(a[0], np.abs(a[1]), np.abs(a[2]), a[3],
                                 N, B), np.float64)
    half_step = 0.5 * grad.fixed_inverse(sc).numpy().astype(np.float64)
    bound = count * half_step + 1e-5 * absum
    assert np.all(np.abs(got - want) <= bound)
    # The grid is the coarser term here: a typical row keeps ~11 bits.
    assert half_step[0] > 1e-5 * np.median(np.abs(a[1]))


@pytest.mark.parametrize("loss,tail", [("mse", "target"), ("mse", "weight"),
                                       ("logloss", "weight")])
def test_heavy_tailed_f32_trees_match_reference(loss, tail):
    """Squared loss with a few targets 1e5-1e6 times the typical residual,
    or instance weights spread over 1e6: the port's exact f32 trees
    against ddt_tpu's f32 trees on JAX-CPU, equal except at provable
    ties, raw predictions to 1e-5 relative."""
    rng = np.random.default_rng(0)
    R, F = 4000, 6
    X = rng.standard_normal((R, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.1 * rng.standard_normal(R)).astype(np.float32)
    if loss == "logloss":
        y = (y > 0).astype(np.float32)
    fit_kw = {}
    if tail == "target":
        big = rng.choice(R, 4, replace=False)
        y[big] = (rng.choice([-1.0, 1.0], 4)
                  * 10.0 ** rng.uniform(5, 6, 4)).astype(np.float32)
    else:
        fit_kw["sample_weight"] = (
            10.0 ** rng.uniform(-6, 0, R)).astype(np.float32)
    kw = dict(n_trees=8, max_depth=4, n_bins=63, min_split_gain=1e-3,
              loss=loss)
    ref = japi.train(X, y, JConfig(backend="tpu", **kw), **fit_kw)
    port = tapi.train(X, y, TrainConfig(device="cpu", **kw), **fit_kw)
    assert_trees_match_mod_ties(ref.ensemble, port.ensemble,
                                kw["min_split_gain"])
    want = ref.ensemble.predict_raw(X)
    got = tapi.predict(port.ensemble, X, mapper=port.mapper, raw=True,
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dispatch_takes_fixed_plain_on_cpu():
    Xb, g, h, ni = _case(300, 3, 31, 2)
    sc = _scales(g, h)
    np.testing.assert_array_equal(
        histogram.build_histograms_exact(Xb, g, h, ni, 2, 31, sc).numpy(),
        histogram.build_histograms_fixed_segment(Xb, g, h, ni, 2, 31,
                                                 sc).numpy())


@pytest.mark.parametrize("missing_bin,cat", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_int64_split_search_equals_f32_on_exact_sums(missing_bin, cat):
    rng = np.random.default_rng(4)
    n, F, B = 6, 5, 16
    hist = np.stack([rng.integers(-40, 41, size=(n, F, B)),
                     rng.integers(0, 30, size=(n, F, B))], -1)
    hi = torch.from_numpy(hist.astype(np.int64))
    hf = torch.from_numpy(hist.astype(np.float32))
    cat_mask = torch.tensor([False, True, False, False, True]) if cat \
        else None
    one = torch.ones(2, dtype=torch.float32)
    a = split.best_splits_impl(hi, 1.0, 1.0, missing_bin=missing_bin,
                               cat_mask=cat_mask, inv_scale=one)
    b = split.best_splits_impl(hf, 1.0, 1.0, missing_bin=missing_bin,
                               cat_mask=cat_mask)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="inv_scale"):
        split.best_splits_impl(hi, 1.0, 1.0)


def _softmax_data():
    X, y = synthetic_multiclass(3000, n_features=8, n_classes=3, seed=5)
    Xb, _ = quantize(X, n_bins=31, seed=5)
    return Xb, y


@pytest.mark.parametrize("fused", [True, False])
def test_f32_resume_is_bitwise(tmp_path, fused):
    Xb, y = _softmax_data()
    cfg = TrainConfig(n_trees=6, max_depth=4, n_bins=31, loss="softmax",
                      n_classes=3, device="cpu", fused_block_rounds=2,
                      subsample=0.8, seed=3)

    def fit(c, **kw):
        be = get_backend(c)
        d = Driver(be, c, **kw)
        if fused:
            return d.fit(Xb, y)
        be.grow_rounds = None          # the granular loop
        try:
            return d.fit(Xb, y)
        finally:
            del be.grow_rounds

    full = fit(cfg)
    ck = str(tmp_path / "ck")
    fit(cfg.replace(n_trees=3), checkpoint_dir=ck, checkpoint_every=1)
    resumed = fit(cfg, checkpoint_dir=ck, checkpoint_every=2)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))


def test_f32_trees_do_not_depend_on_row_order_within_a_node():
    """Permuting the training rows (and their labels) permutes nothing a
    histogram sees: the fixed-point sums, hence the trees, are bitwise
    those of the original order."""
    Xb, y = _softmax_data()
    cfg = TrainConfig(n_trees=3, max_depth=4, n_bins=31, loss="softmax",
                      n_classes=3, device="cpu")
    a = Driver(get_backend(cfg), cfg).fit(Xb, y)
    perm = np.random.default_rng(9).permutation(len(y))
    b = Driver(get_backend(cfg), cfg).fit(Xb[perm], y[perm])
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
