"""Quantized-gradient training in the port (cfg.grad_dtype) against ddt_tpu
on the CPU, with bagging and colsample.

Bitwise where the reference is exact: the quantizer (scales and q's, the
tensor path against the reference's jax and numpy twins), every int32
histogram (the port's plain version against the reference's Pallas kernel
in interpret mode and its segment path), integer sibling subtraction, and
trees grown from exact-grid gradients (structure and leaves). Trees grown
from real logloss gradients, and whole runs, are held to the tie-aware
comparator (tests/tree_compare.py): their f32 seams (sigmoid, cumsum
order) sit outside the integer histograms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.backends import get_backend as jget_backend
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data.datasets import synthetic_binary
from ddt_tpu.ops import grad as jgrad
from ddt_tpu.ops import histogram as jhist
from ddt_tpu.ops.hist_pallas import build_histograms_pallas
from ddt_tpu_torch import api as tapi
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.ops import grad, grow, hist_cuda, histogram, sampling
from tree_compare import assert_trees_match_mod_ties

DTYPES = ["int8", "int16"]
FIELDS = ("feature", "threshold_bin", "is_leaf", "default_left")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------- #
# the quantizer
# --------------------------------------------------------------------- #

def test_constants_equal_reference():
    assert grad.GRAD_DTYPES == jgrad.GRAD_DTYPES
    assert grad.GRAD_QMAX == jgrad.GRAD_QMAX
    assert grad.GRAD_ITEMSIZE == jgrad.GRAD_ITEMSIZE
    assert (grad.GRAD_SUM_CAP, grad.GRAD_ROW_LIMIT) == (
        jgrad.GRAD_SUM_CAP, jgrad.GRAD_ROW_LIMIT)
    assert (grad._G_SALT, grad._H_SALT) == (jgrad._G_SALT, jgrad._H_SALT)
    assert grad.grad_quant_dtype("int8") == torch.int8
    assert grad.grad_quant_dtype("int16") == torch.int16
    with pytest.raises(ValueError, match="grad_dtype"):
        grad.grad_quant_dtype("f32")


@pytest.mark.parametrize("grad_dtype", DTYPES)
@pytest.mark.parametrize("R", [2000, 50_000])
def test_quantize_bitwise_equal_reference(grad_dtype, R):
    rng = np.random.default_rng(R)
    g = rng.standard_normal(R).astype(np.float32)
    h = (rng.random(R) * 0.25).astype(np.float32)
    qg, qh, gs, hs = grad.quantize_gradients(
        _t(g), _t(h), grad_dtype=grad_dtype, tree_id=5, seed=11)
    jqg, jqh, jgs, jhs = jgrad.quantize_gradients(
        jnp.asarray(g), jnp.asarray(h), grad_dtype=grad_dtype,
        tree_id=jnp.int32(5), seed=11, local_offset=jnp.int32(0))
    nqg, nqh, ngs, nhs = jgrad.quantize_gradients_np(
        g, h, grad_dtype=grad_dtype, tree_id=5, seed=11)
    assert qg.dtype == grad.grad_quant_dtype(grad_dtype)
    assert float(gs) == float(jgs) == float(ngs)
    assert float(hs) == float(jhs) == float(nhs)
    for got, a, b in ((qg, jqg, nqg), (qh, jqh, nqh)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(a))
        np.testing.assert_array_equal(got.numpy(), b)
    # The port's numpy twin is the reference's.
    pqg, pqh, pgs, phs = grad.quantize_gradients_np(
        g, h, grad_dtype=grad_dtype, tree_id=5, seed=11)
    np.testing.assert_array_equal(pqg, nqg)
    np.testing.assert_array_equal(pqh, nqh)
    assert (pgs, phs) == (ngs, nhs)
    qmax = grad.GRAD_QMAX[grad_dtype]
    assert int(qg.abs().max()) <= qmax


def test_quantize_64bit_row_base_equals_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal(500).astype(np.float32)
    h = (rng.random(500) + 0.1).astype(np.float32)
    base = (1 << 33) + 0xFFFFFF00
    nqg, nqh, gs, hs = jgrad.quantize_gradients_np(
        g, h, grad_dtype="int8", tree_id=2, seed=9, row_start=base)
    qg, qh = grad.quantize_with_scales(
        _t(g), _t(h), torch.tensor(gs), torch.tensor(hs),
        grad_dtype="int8", tree_id=2, seed=9, row_start=base)
    np.testing.assert_array_equal(qg.numpy(), nqg)
    np.testing.assert_array_equal(qh.numpy(), nqh)


def test_quantize_exact_grid_and_zeros():
    scale = np.float32(2.0 ** -6)
    g = np.arange(-127, 128).astype(np.float32) * scale
    h = np.abs(g) + scale
    qg, qh, gs, hs = grad.quantize_gradients(
        _t(g), _t(h), grad_dtype="int8", tree_id=0, seed=0)
    assert float(gs) == float(scale)
    np.testing.assert_array_equal(qg.numpy().astype(np.float32) * scale, g)
    z = torch.zeros(64)
    qz, qzh, zs, zhs = grad.quantize_gradients(
        z, z, grad_dtype="int16", tree_id=3, seed=1)
    assert not qz.any() and not qzh.any()
    assert float(zs) == float(zhs) == 1.0


@pytest.mark.parametrize("max_abs,sum_abs", [
    (1.0, 2.0 ** 34),              # the sum cap engages
    (1.0, 2.0 ** 34 + 2 ** 11),    # just above a power of two: snaps up
    (1e-3, 3.0), (5.0, 2.0 ** 30), (0.0, 0.0), (2.0, 1e38),
])
@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_quant_scale_equals_reference(max_abs, sum_abs, grad_dtype):
    want = jgrad.quant_scale_np(max_abs, sum_abs, grad_dtype)
    got = grad.quant_scale(torch.tensor(max_abs), torch.tensor(sum_abs),
                           grad_dtype)
    jx = jgrad.quant_scale(jnp.float32(max_abs), jnp.float32(sum_abs),
                           grad_dtype)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want) == float(jx)
    assert grad.quant_scale_np(max_abs, sum_abs, grad_dtype) == want
    if sum_abs >= 2.0 ** 34:
        assert float(got) >= sum_abs / grad.GRAD_SUM_CAP
        m, _ = np.frexp(np.float32(got))
        assert m == 0.5                               # a power of two


def test_quantize_refuses_past_the_row_limit():
    big = torch.zeros(1).expand(grad.GRAD_ROW_LIMIT)
    with pytest.raises(ValueError, match="row ceiling"):
        grad.quantize_gradients(big, big, grad_dtype="int8", tree_id=0,
                                seed=0)


@pytest.mark.parametrize("args", [("int8", 2.0, 300.0, 1000),
                                  ("int16", 0.5, 2.0 ** 31, 10 ** 6)])
def test_error_bound_formula_equals_reference(args):
    assert grad.grad_quant_error_bound(*args) == \
        jgrad.grad_quant_error_bound(*args)


# --------------------------------------------------------------------- #
# integer histograms
# --------------------------------------------------------------------- #

def _int_case(R, F, B, N, grad_dtype, seed=2):
    rng = np.random.default_rng(seed)
    npdt = np.int8 if grad_dtype == "int8" else np.int16
    qmax = grad.GRAD_QMAX[grad_dtype]
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    qg = rng.integers(-qmax, qmax + 1, size=R).astype(npdt)
    qh = rng.integers(0, qmax + 1, size=R).astype(npdt)
    qg[rng.random(R) < 0.2] = 0
    ni = rng.integers(-1, N, size=R).astype(np.int32)
    return Xb, qg, qh, ni


@pytest.mark.parametrize("grad_dtype", DTYPES)
@pytest.mark.parametrize("R,F,B,N", [
    (2500, 5, 255, 4), (1500, 4, 128, 8), (2049, 3, 64, 2),
])
def test_plain_int_hist_bitwise_equals_reference(grad_dtype, R, F, B, N):
    Xb, qg, qh, ni = _int_case(R, F, B, N, grad_dtype)
    got = histogram.build_histograms(*map(_t, (Xb, qg, qh, ni)), N, B)
    assert got.dtype == torch.int32 and got.shape == (N, F, B, 2)
    seg = np.asarray(jhist.build_histograms_segment(
        *map(jnp.asarray, (Xb, qg, qh, ni)), N, B))
    pal = np.asarray(build_histograms_pallas(
        *map(jnp.asarray, (Xb, qg, qh, ni)), N, B, interpret=True))
    assert seg.dtype == pal.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), seg)
    np.testing.assert_array_equal(got.numpy(), pal)


def test_int_hist_dispatch_takes_plain_on_cpu():
    Xb, qg, qh, ni = _int_case(300, 3, 31, 2, "int8")
    args = list(map(_t, (Xb, qg, qh, ni)))
    before = (hist_cuda.launches, hist_cuda.launches_int)
    out = histogram.build_histograms(*args, 2, 31)
    assert (hist_cuda.launches, hist_cuda.launches_int) == before
    assert out.dtype == torch.int32
    with pytest.raises(TypeError, match="CUDA tensor"):
        hist_cuda.build_histograms_cuda(*args, 2, 31)


def test_int_hist_all_frozen_is_zero():
    Xb, qg, qh, ni = _int_case(400, 3, 16, 4, "int16")
    ni[:] = -1
    out = histogram.build_histograms(*map(_t, (Xb, qg, qh, ni)), 4, 16)
    assert out.dtype == torch.int32 and not out.any()


@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_integer_sibling_subtraction_equals_direct_build(grad_dtype):
    """parent - left is exact in int32: the subtracted level equals a
    direct build, and gated children of unsplit parents are zero."""
    rng = np.random.default_rng(4)
    R, F, B = 3000, 6, 31
    Xb, qg, qh, _ = _int_case(R, F, B, 1, grad_dtype, seed=5)
    parent_ni = rng.integers(-1, 4, size=R).astype(np.int32)
    child = np.where(parent_ni >= 0,
                     2 * parent_ni + rng.integers(0, 2, size=R), -1)
    split = np.array([True, True, False, True])
    child = np.where((parent_ni >= 0) & split[np.maximum(parent_ni, 0)],
                     child, -1).astype(np.int32)
    Xt, gt, ht = _t(Xb), _t(qg), _t(qh)
    parent = histogram.build_histograms(Xt, gt, ht, _t(parent_ni), 4, B)
    got = grow.level_histograms(Xt, gt, ht, _t(child), 8, B,
                                parent_hist=parent,
                                parent_split=_t(split))
    direct = histogram.build_histograms(Xt, gt, ht, _t(child), 8, B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_whole_tree_invariant_to_subtraction(grad_dtype):
    rng = np.random.default_rng(4)
    R, F, B = 3000, 6, 31
    Xb = _t(rng.integers(0, B, size=(R, F), dtype=np.uint8))
    g = _t(rng.standard_normal(R).astype(np.float32))
    h = _t((rng.random(R) * 0.25 + 0.01).astype(np.float32))
    kw = dict(max_depth=4, n_bins=B, reg_lambda=1.0, min_child_weight=1e-3,
              min_split_gain=0.0, grad_dtype=grad_dtype, quant_seed=7)
    on = grow.grow_tree(Xb, g, h, hist_subtraction=True, **kw)
    off = grow.grow_tree(Xb, g, h, hist_subtraction=False, **kw)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_error_bound_held_on_dequantized_histograms(grad_dtype):
    rng = np.random.default_rng(21)
    R, F, B, N = 4000, 6, 31, 4
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = (rng.random(R) * 0.25).astype(np.float32)
    ni = rng.integers(0, N, size=R).astype(np.int32)
    qg, qh, gs, hs = grad.quantize_gradients(
        _t(g), _t(h), grad_dtype=grad_dtype, tree_id=0, seed=3)
    hq = histogram.build_histograms(_t(Xb), qg, qh, _t(ni), N, B)
    deq = (hq.float() * torch.stack([gs, hs])).numpy().astype(np.float64)
    hf = np.zeros((N, F, B, 2), np.float64)
    for f in range(F):
        np.add.at(hf[:, f, :, 0], (ni, Xb[:, f]), g)
        np.add.at(hf[:, f, :, 1], (ni, Xb[:, f]), h)
    bg = grad.grad_quant_error_bound(grad_dtype, np.abs(g).max(),
                                     np.abs(g).sum(), R)
    bh = grad.grad_quant_error_bound(grad_dtype, np.abs(h).max(),
                                     np.abs(h).sum(), R)
    assert np.abs(deq[..., 0] - hf[..., 0]).max() <= bg
    assert np.abs(deq[..., 1] - hf[..., 1]).max() <= bh


def test_integer_leaf_sums():
    idx = torch.tensor([0, 1, 1, 3, 2, 0])
    active = torch.tensor([True, True, False, True, True, True])
    g = torch.tensor([5, -3, 100, 7, -127, 2], dtype=torch.int8)
    h = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int8)
    out = grad.leaf_gh_sums(idx, active, g, h, 4)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  [[7, 7], [-3, 2], [-127, 5], [7, 4]])


# --------------------------------------------------------------------- #
# trees: per round from the same g/h, then whole runs
# --------------------------------------------------------------------- #

def _per_round(grad_dtype, Xb, g, h, kw, rounds=1):
    """(reference trees, port trees) grown from the same numpy g/h by
    get_backend(...).grow_tree, one per round id."""
    jbe = jget_backend(JConfig(backend="tpu", grad_dtype=grad_dtype, **kw))
    pbe = get_backend(TrainConfig(device="cpu", grad_dtype=grad_dtype,
                                  **kw))
    jdata, pdata = jbe.upload(Xb), pbe.upload(Xb)
    out = []
    for rnd in range(rounds):
        jt = jbe.fetch_tree(jbe.grow_tree(jdata, jbe._put_rows(g),
                                          jbe._put_rows(h), tree_id=rnd)[0])
        pt = pbe.fetch_tree(pbe.grow_tree(pdata, _t(g), _t(h),
                                          tree_id=rnd)[0])
        out.append((jt, pt))
    return out


@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_exact_grid_trees_bitwise_equal_reference(grad_dtype):
    """Integer g/h with each channel's max pinned to qmax (scale exactly
    1) and total mass under 2^24: quantization and dequantization are
    exact, so structure and leaves are bitwise, against the reference and
    against the port's own f32 tree."""
    rng = np.random.default_rng(8)
    R, F, B = 1000, 6, 31
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    qmax = grad.GRAD_QMAX[grad_dtype]
    g = rng.integers(-64, 65, size=R).astype(np.float32)
    h = rng.integers(1, 65, size=R).astype(np.float32)
    g[0] = h[0] = qmax
    kw = dict(n_trees=1, max_depth=3, n_bins=B)
    for jt, pt in _per_round(grad_dtype, Xb, g, h, kw, rounds=2):
        for k in FIELDS + ("leaf_value", "split_gain"):
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    (_, pf), = _per_round("f32", Xb, g, h, kw)
    (_, pq), = _per_round(grad_dtype, Xb, g, h, kw)
    for k in FIELDS:
        np.testing.assert_array_equal(pq[k], pf[k], err_msg=k)
    np.testing.assert_allclose(pq["leaf_value"], pf["leaf_value"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grad_dtype", DTYPES)
def test_logloss_gradient_trees_match_reference(grad_dtype):
    """Real logloss gradients, several rounds' tree ids: the q's and the
    int32 histograms are exact on both sides; the gain scan is held to
    the tie-aware comparator."""
    X, y = synthetic_binary(3000, n_features=8, seed=3)
    Xb = fit_bin_mapper(X, n_bins=63).transform(X)
    p = np.float32(1.0) / (np.float32(1.0) + np.exp(
        -np.random.default_rng(0).standard_normal(3000).astype(np.float32)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    kw = dict(n_trees=1, max_depth=4, n_bins=63, min_split_gain=1e-3)
    pairs = _per_round(grad_dtype, Xb, g, h, kw, rounds=3)
    for jt, pt in pairs:
        for k in FIELDS:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
        np.testing.assert_allclose(pt["leaf_value"], jt["leaf_value"],
                                   rtol=1e-5, atol=1e-6)


def test_exact_grid_first_round_through_mse():
    """mse on y in {-1, +1} (mean 0): g = -/+1, h = 1, on the grid, so the
    int8 tree equals the f32 tree, structure and leaves bitwise."""
    rng = np.random.default_rng(12)
    R, F, B = 3000, 8, 63
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    y = np.tile([-1.0, 1.0], R // 2).astype(np.float32)
    cfg = TrainConfig(n_trees=1, max_depth=4, n_bins=B, loss="mse",
                      device="cpu")
    f = tapi.train(Xb, y, cfg, binned=True).ensemble
    q = tapi.train(Xb, y, cfg.replace(grad_dtype="int8"),
                   binned=True).ensemble
    for k in FIELDS + ("leaf_value",):
        np.testing.assert_array_equal(getattr(q, k), getattr(f, k))
    ref = japi.train(Xb, y, JConfig(n_trees=1, max_depth=4, n_bins=B,
                                    loss="mse", backend="tpu",
                                    grad_dtype="int8"), binned=True)
    for k in FIELDS + ("leaf_value",):
        np.testing.assert_array_equal(getattr(q, k),
                                      getattr(ref.ensemble, k))


@pytest.fixture(scope="module")
def data():
    return synthetic_binary(4000, seed=0)


@pytest.mark.parametrize("extra", [
    dict(grad_dtype="int8"),
    dict(grad_dtype="int16"),
    dict(subsample=0.7, seed=5),
    dict(colsample_bytree=0.6, seed=2),
    dict(grad_dtype="int16", subsample=0.8, colsample_bytree=0.8, seed=3),
], ids=["int8", "int16", "subsample", "colsample", "int16-bagged"])
def test_train_matches_reference(data, extra):
    X, y = data
    kw = dict(n_trees=8, max_depth=4, n_bins=63, min_split_gain=1e-3,
              **extra)
    ref = japi.train(X, y, JConfig(backend="tpu", **kw))
    port = tapi.train(X, y, TrainConfig(device="cpu", **kw))
    a, b = ref.ensemble, port.ensemble
    assert b.base_score == a.base_score
    assert_trees_match_mod_ties(a, b, kw["min_split_gain"])
    np.testing.assert_allclose(
        tapi.predict(b, X, mapper=port.mapper, raw=True, device="cpu"),
        a.predict_raw(X), rtol=1e-4, atol=1e-4)


def test_bagging_and_colsample_change_the_model_and_replay(data):
    X, y = data
    kw = dict(n_trees=4, max_depth=3, n_bins=63, device="cpu")
    base = tapi.train(X, y, **kw).ensemble
    bag = tapi.train(X, y, subsample=0.5, **kw).ensemble
    again = tapi.train(X, y, subsample=0.5, **kw).ensemble
    other = tapi.train(X, y, subsample=0.5, seed=1, **kw).ensemble
    col = tapi.train(X, y, colsample_bytree=0.3, seed=4, **kw).ensemble
    assert not np.array_equal(bag.leaf_value, base.leaf_value)
    np.testing.assert_array_equal(bag.leaf_value, again.leaf_value)
    assert not np.array_equal(bag.leaf_value, other.leaf_value)
    for t in range(4):
        used = col.feature[t][col.feature[t] >= 0]
        assert sampling.colsample_mask(4, t, 0, X.shape[1], 0.3)[used].all()


def test_split_agreement_higgs_shape_port():
    """The reference's acceptance bar on the port alone: int8 trees grown
    per round from the same f32 boosting state as their f32 twins agree
    on >= 98.5% of node slots (28 features, 255 bins, depth 6)."""
    X, y = synthetic_binary(100_000, n_features=28, seed=42)
    Xb = fit_bin_mapper(X, n_bins=255, seed=42).transform(X)
    cfg = TrainConfig(n_trees=3, max_depth=6, n_bins=255, device="cpu")
    be_f = get_backend(cfg)
    be_q = get_backend(cfg.replace(grad_dtype="int8"))
    data = be_f.upload(Xb)
    yh = be_f.upload_labels(y)
    pred = be_f.init_pred(yh, float(np.log(y.mean() / (1 - y.mean()))))
    same = tot = 0
    for rnd in range(cfg.n_trees):
        g, h = be_f.grad_hess(pred, yh)
        hf, delta = be_f.grow_tree(data, g, h, tree_id=rnd)
        hq, _ = be_q.grow_tree(data, g, h, tree_id=rnd)
        tf, tq = be_f.fetch_tree(hf), be_q.fetch_tree(hq)
        same += int((tf["feature"] == tq["feature"]).sum())
        tot += tf["feature"].size
        pred = be_f.apply_delta(pred, delta, 0)
    assert same / tot >= 0.985


# --------------------------------------------------------------------- #
# backend surface and cache key
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("flag,integer,device,want", [
    ("auto", True, "cpu", True), ("auto", False, "cpu", False),
    ("off", True, "cpu", False), ("auto", False, "cuda", True),
])
def test_resolve_hist_subtraction_integer_on_everywhere(flag, integer,
                                                        device, want):
    assert grow.resolve_hist_subtraction(flag, device,
                                         integer_hists=integer) is want
    be = get_backend(TrainConfig(device="cpu", grad_dtype="int8"))
    assert be.hist_subtraction is True


@pytest.mark.parametrize("live", [dict(grad_dtype="int8"),
                                  dict(subsample=0.5),
                                  dict(grad_dtype="int16", subsample=0.9)])
def test_get_backend_keys_on_a_live_seed(live):
    a = get_backend(TrainConfig(device="cpu", seed=0, **live))
    b = get_backend(TrainConfig(device="cpu", seed=1, **live))
    assert a is not b
    assert (a.cfg.seed, b.cfg.seed) == (0, 1)
    assert get_backend(TrainConfig(device="cpu", seed=1, **live)) is b


@pytest.mark.parametrize("dead", [dict(), dict(colsample_bytree=0.5)])
def test_get_backend_shares_when_the_seed_is_dead(dead):
    a = get_backend(TrainConfig(device="cpu", seed=0, **dead))
    b = get_backend(TrainConfig(device="cpu", seed=1, n_trees=7, **dead))
    assert a is b


def test_apply_row_mask_and_granular_int_histograms():
    be = get_backend(TrainConfig(device="cpu", n_bins=16))
    g, h = torch.tensor([1.0, -2.0, 3.0]), torch.tensor([0.5, 0.5, 0.5])
    mg, mh = be.apply_row_mask(g, h, np.array([True, False, True]))
    np.testing.assert_array_equal(mg.numpy(), [1.0, 0.0, 3.0])
    np.testing.assert_array_equal(mh.numpy(), [0.5, 0.0, 0.5])
    Xb = np.array([[1], [2], [1]], np.uint8)
    hq = be.build_histograms(be.upload(Xb), np.array([3, -4, 5], np.int8),
                             np.array([1, 1, 2], np.int8),
                             np.zeros(3, np.int32), 1)
    assert hq.dtype == torch.int32
    np.testing.assert_array_equal(hq[0, 0, 1].numpy(), [8, 3])
    np.testing.assert_array_equal(hq[0, 0, 2].numpy(), [-4, 1])
