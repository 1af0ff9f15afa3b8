"""The port's gradient and split ops against ddt_tpu's on the CPU.

grad_hess / mean_loss / leaf_gh_sums agree to f32 tolerance (sigmoid and
summation order may differ by ULPs: rtol 1e-6 elementwise, 1e-5 on sums).
Split choice is held bitwise on (feature, bin, default_left, gain) for
histograms whose cumulative sums are exact (small integers), which makes
the gains bit-identical and leaves many exact ties for the
first-flattened-index rule to break.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.ops import grad as jgrad
from ddt_tpu.ops import split as jsplit
from ddt_tpu.reference import numpy_trainer as oracle
from ddt_tpu_torch.ops import grad as tgrad
from ddt_tpu_torch.ops import grow as tgrow
from ddt_tpu_torch.ops import split as tsplit


def _pred_y(R=2000, seed=0):
    rng = np.random.default_rng(seed)
    pred = (3 * rng.standard_normal(R)).astype(np.float32)
    y = (rng.random(R) < 0.4).astype(np.int32)
    return pred, y


@pytest.mark.parametrize("loss", ["logloss", "mse"])
def test_grad_hess_matches_reference(loss):
    pred, y = _pred_y()
    gj, hj = jgrad.grad_hess(jnp.asarray(pred), jnp.asarray(y), loss)
    gt, ht = tgrad.grad_hess(torch.from_numpy(pred), torch.from_numpy(y),
                             loss)
    assert gt.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("loss", ["logloss", "mse"])
def test_mean_loss_and_base_score_match_reference(loss):
    pred, y = _pred_y(seed=1)
    want = float(jgrad.mean_loss(jnp.asarray(pred), jnp.asarray(y),
                                 jnp.ones(len(y), jnp.float32), loss))
    got = float(tgrad.mean_loss(torch.from_numpy(pred), torch.from_numpy(y),
                                loss))
    assert got == pytest.approx(want, rel=1e-5)
    assert tgrad.base_score_np(y, loss) == oracle.base_score(y, loss)
    assert float(tgrad.base_score(torch.from_numpy(y), loss)) == \
        pytest.approx(float(jgrad.base_score(jnp.asarray(y), loss)),
                      rel=1e-6)


def test_leaf_gh_sums_matches_reference():
    rng = np.random.default_rng(2)
    R, n = 3000, 16
    idx = rng.integers(0, n, R).astype(np.int32)
    active = rng.random(R) < 0.8
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    want = np.asarray(jgrad.leaf_gh_sums(jnp.asarray(idx),
                                         jnp.asarray(active),
                                         jnp.asarray(g), jnp.asarray(h), n))
    got = tgrad.leaf_gh_sums(torch.from_numpy(idx), torch.from_numpy(active),
                             torch.from_numpy(g), torch.from_numpy(h), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _tie_hist(n=6, F=5, B=17, seed=0, empty_nodes=True):
    """Small-integer histograms: exact cumsums, exact gains, many ties
    (duplicated features and mirrored bins), empty and one-bin nodes."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-3, 4, size=(n, F, B)).astype(np.float32)
    h = rng.integers(0, 3, size=(n, F, B)).astype(np.float32)
    g[:, 1], h[:, 1] = g[:, 0], h[:, 0]            # feature 1 == feature 0
    g[:, 3], h[:, 3] = g[:, 2, ::-1], h[:, 2, ::-1]   # mirrored bins
    if empty_nodes:
        g[0], h[0] = 0.0, 0.0                      # empty node
        g[1, :, 1:], h[1, :, 1:] = 0.0, 0.0        # all mass in bin 0
    # Every feature of a node must sum the same rows: rebalance each
    # feature's totals onto its last bin so node totals agree.
    for k in range(F):
        g[:, k, -1] += g[:, 0].sum(-1) - g[:, k].sum(-1)
        h[:, k, -1] += h[:, 0].sum(-1) - h[:, k].sum(-1)
    h = np.abs(h)
    return np.stack([g, h], -1)


_SPLIT_CASES = [
    dict(),
    dict(reg_lambda=0.0, min_child_weight=0.0),
    dict(missing_bin=True),
    dict(cat=(2,)),
    dict(cat=(0, 4), missing_bin=True),
    dict(fmask=(True, False, True, True, False)),
    dict(fmask=(False, True, True, True, True), missing_bin=True,
         cat=(3,)),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", _SPLIT_CASES)
def test_best_splits_bitwise_on_ties(case, seed):
    hist = _tie_hist(seed=seed)
    F = hist.shape[1]
    lam = case.get("reg_lambda", 1.0)
    mcw = case.get("min_child_weight", 1.0)
    cat = case.get("cat")
    fm = case.get("fmask")
    cat_j = None if cat is None else jsplit.cat_feature_vec(cat, F)
    cat_t = None if cat is None else torch.from_numpy(np.array(cat_j))
    fm_j = None if fm is None else jnp.asarray(fm)
    fm_t = None if fm is None else torch.tensor(fm)
    want = jsplit.best_splits_impl(
        jnp.asarray(hist), lam, mcw, fm_j,
        missing_bin=case.get("missing_bin", False), cat_mask=cat_j)
    got = tsplit.best_splits_impl(
        torch.from_numpy(hist), lam, mcw, fm_t,
        missing_bin=case.get("missing_bin", False), cat_mask=cat_t)
    for w, t, name in zip(want, got, ("gain", "feature", "bin", "dl")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[1].dtype == got[2].dtype == torch.int32
    assert got[3].dtype == torch.bool


def test_best_splits_first_index_wins_exact_ties():
    """Engineered exact tie across features and bins: the first flattened
    candidate wins (torch.argmax's documented rule, the reference's too)."""
    hist = np.zeros((1, 3, 4, 2), np.float32)
    for f in range(3):
        hist[0, f, :, 0] = [1, -1, 1, -1]
        hist[0, f, :, 1] = [1, 1, 1, 1]
    gain, feat, b, _ = tsplit.best_splits_impl(torch.from_numpy(hist),
                                               1.0, 0.5)
    assert (int(feat[0]), int(b[0])) == (0, 0)
    want = jsplit.best_splits_impl(jnp.asarray(hist), 1.0, 0.5)
    assert (int(want[1][0]), int(want[2][0])) == (0, 0)
    assert float(gain[0]) == float(want[0][0])


def test_node_totals_matches_reference():
    hist = _tie_hist(empty_nodes=False)
    gj, hj = jsplit.node_totals(jnp.asarray(hist))
    gt, ht = tsplit.node_totals(torch.from_numpy(hist))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_resolve_hist_subtraction():
    assert tgrow.resolve_hist_subtraction("auto", "cuda") is True
    assert tgrow.resolve_hist_subtraction("auto", "cpu") is False
    assert tgrow.resolve_hist_subtraction("on", "cpu") is True
    assert tgrow.resolve_hist_subtraction("off", "cuda") is False
    with pytest.raises(ValueError):
        tgrow.resolve_hist_subtraction("maybe", "cpu")
