"""The plain reference on small cases it can be checked on by hand, and
beside the program's CPU path."""

import numpy as np
import torch

from benchmark.reference import gbdt as ref


def test_edges_and_bins():
    X = np.arange(12, dtype=np.float32).reshape(6, 2)   # columns 0..10, 1..11
    edges = ref.fit_edges(X, n_bins=3, seed=0)
    # Interior quantiles 1/3 and 2/3 of [0, 2, ..., 10].
    np.testing.assert_allclose(edges[0], [10 / 3, 20 / 3], rtol=1e-6)
    b = ref.bin_rows(np.array([[3.0, np.nan], [4.0, 100.0]], np.float32),
                     edges, "cpu")
    assert b.tolist() == [[0, 0], [1, 2]]
    cat = ref.fit_edges(X, n_bins=4, seed=0, cat_features=(1,))
    assert cat[1].tolist() == [0.0, 1.0, 2.0]


def _tree(feature, thr, leaf_value, depth):
    N = (1 << (depth + 1)) - 1
    f = np.full(N, -1, np.int32)
    t = np.zeros(N, np.int32)
    for i, (fi, ti) in enumerate(zip(feature, thr)):
        f[i], t[i] = fi, ti
    is_leaf = f < 0
    return ref.Tree(f, t, is_leaf, np.asarray(leaf_value, np.float32))


def test_check_tree_finds_the_one_good_split():
    # Feature 1 separates the gradients perfectly at bin 1; feature 0 is
    # noise.
    Xb = torch.tensor([[0, 0], [1, 1], [2, 2], [3, 3], [0, 2], [3, 0]],
                      dtype=torch.uint8)
    g = torch.tensor([-1.0, -1.0, 1.0, 1.0, 1.0, -1.0], dtype=torch.float64)
    h = torch.ones(6, dtype=torch.float64)
    good = _tree([1], [1], [0, 3 / 4, -3 / 4], depth=1)
    kw = dict(max_depth=1, n_bins=4, reg_lambda=1.0, min_child_weight=1e-3,
              min_split_gain=0.0, cat_mask=None)
    tc = ref.check_tree(Xb, g, h, good, **kw)
    assert (tc.nodes, tc.mismatches) == (1, 0)
    assert ref.leaf_gap(tc.leaves) < 1e-7
    assert tc.leaf_of_row.tolist() == [1, 1, 2, 2, 2, 1]
    assert [c.tolist() for c in tc.level_rows] == [[6], [3, 3]]
    bad = _tree([0], [1], [0, 0.5, -0.5], depth=1)
    tc = ref.check_tree(Xb, g, h, bad, **kw)
    assert tc.mismatches == 1 and ref.leaf_gap(tc.leaves) > 0.1


def test_categorical_split_sends_the_matched_bin_left():
    Xb = torch.tensor([[2], [0], [2], [1]], dtype=torch.uint8)
    tree = _tree([0], [2], [0, 1.0, -1.0], depth=1)
    mask = torch.tensor([True])
    assert ref.leaf_index(Xb, tree, 1, mask).tolist() == [1, 2, 1, 2]
    assert [c.tolist() for c in ref.level_counts(Xb, tree, 1, mask)] == \
        [[4], [2, 2]]


def test_score_raw_and_depths():
    X = torch.tensor([[0.5, -1.0], [2.0, 3.0]])
    feature = np.array([[0, -1, -1], [1, -1, -1]], np.int32)
    thr = np.array([[1.0, 0, 0], [0.0, 0, 0]], np.float32)
    leaf = np.array([[False, True, True]] * 2)
    val = np.array([[0, 1.0, 2.0], [0, 10.0, 20.0]], np.float32)
    m = ref.score_raw(X, feature, thr, leaf, val, max_depth=1,
                      learning_rate=0.5, base=1.0)
    # Row 0: left (1) and left (10); row 1: right (2) and right (20).
    assert m.tolist() == [1.0 + 0.5 * 11, 1.0 + 0.5 * 22]
    assert ref.leaf_depths(X, feature, thr, leaf, 1).tolist() == [2, 2]


def test_the_reference_matches_the_programs_cpu_training():
    """Small rows through the port on the CPU: the reference reads the
    same edges, splits and leaves."""
    import ddt_tpu_torch.api as api
    from ddt_tpu_torch.config import TrainConfig

    rng = np.random.default_rng(3)
    X = rng.standard_normal((3000, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 > 0.5).astype(np.int32)
    cfg = TrainConfig(n_trees=3, max_depth=3, n_bins=31, device="cpu",
                      seed=5)
    res = api.train(X, y, cfg)
    edges = ref.fit_edges(X, 31, 5)
    assert np.array_equal(edges, res.mapper.edges)
    Xb = ref.bin_rows(X, edges, "cpu")
    margin = torch.full((3000,), ref.base_score(y, "logloss"),
                        dtype=torch.float64)
    yt = torch.from_numpy(y)
    ens = res.ensemble
    for t in range(3):
        g, h = ref.grad_hess(margin, yt, "logloss")
        tree = ref.Tree(ens.feature[t], ens.threshold_bin[t],
                        ens.is_leaf[t], ens.leaf_value[t])
        tc = ref.check_tree(Xb, g, h, tree, max_depth=3, n_bins=31,
                            reg_lambda=1.0, min_child_weight=1e-3,
                            min_split_gain=0.0, cat_mask=None)
        assert tc.mismatches == 0 and ref.leaf_gap(tc.leaves) < 1e-5
        margin += 0.1 * torch.from_numpy(
            ens.leaf_value[t].astype(np.float64))[tc.leaf_of_row]
