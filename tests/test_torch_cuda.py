"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card every test here skips (the
fixture decides, never module import). On the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; this file imports nothing of JAX or ddt_tpu.)

Tolerances: the histogram kernel's exact mode (what f32 training runs:
int64 fixed-point sums) and its integer mode (int8/int16 g/h, int32 sums)
are exact and held bitwise; its f32 mode sums with float atomics in a
run-to-run order, so each (g, h) cell is held to 1e-5 * (sum of |g| or
|h| over the cell's own rows) + 1e-6. f32 training is held bitwise run to
run and across a resume. The traversal kernel (K3) and the
LUT kernels (K4, K5) are bitwise on exact-grid leaf values (every partial
sum is exact in f32, so the order cannot matter) and within 1e-5 *
(|p| + 1) on random leaves; the LUT kernels also stay within the tables'
max_abs_err of the f32 host oracle. All three equal their plain versions
bitwise on random leaves too (both sum tree by tree in one order) at
every batch size, in both of their mappings.
"""

import numpy as np
import pytest
import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import (grad, hist_cuda, histogram, predict,
                               predict_cuda, predict_lut, predict_lut_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hist_case(R, F, B, N, seed=0, frozen=0.1):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(0, N, size=R).astype(np.int32)
    ni[rng.random(R) < frozen] = -1
    return Xb, g, h, ni


def _hist_tol(Xb, g, h, ni, N, B):
    """[N, F, B, 2] per-cell bound: 1e-5 * sum|g| (|h|) over the cell's
    rows + 1e-6."""
    R, F = Xb.shape
    act = ni >= 0
    key = ((ni[act, None].astype(np.int64) * F + np.arange(F)) * B
           + Xb[act]).reshape(-1)
    out = []
    for w in (g, h):
        ww = np.repeat(np.abs(w[act]).astype(np.float64), F)
        out.append(np.bincount(key, weights=ww, minlength=N * F * B))
    return (1e-5 * np.stack(out, -1) + 1e-6).reshape(N, F, B, 2)


def test_kernels_build(dev):
    _build.build_all()
    for name in ("device", "hist", "lut"):
        assert _build.lib_path(name).exists()


@pytest.mark.parametrize("R,F,B,N", [
    (100_003, 28, 255, 1),
    (100_003, 28, 255, 2),
    (100_003, 28, 255, 32),
    (50_001, 28, 128, 16),
    (50_001, 28, 64, 32),
    (20_000, 120, 256, 4),    # feature slabs: one node's table > the card
    (5, 3, 16, 4),            # fewer rows than one block's threads
])
def test_hist_kernel_matches_plain(dev, R, F, B, N):
    Xb, g, h, ni = _hist_case(R, F, B, N)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    before = hist_cuda.launches
    got = hist_cuda.build_histograms_cuda(*args, N, B)
    assert hist_cuda.launches == before + 1
    want = histogram.build_histograms_segment(*args, N, B)
    torch.cuda.synchronize()
    err = (got - want).abs().cpu().numpy()
    assert got.shape == (N, F, B, 2)
    assert np.all(err <= _hist_tol(Xb, g, h, ni, N, B)), float(err.max())


def test_hist_all_frozen_is_zero(dev):
    Xb, g, h, ni = _hist_case(3000, 4, 255, 8)
    ni[:] = -1
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    assert torch.count_nonzero(
        hist_cuda.build_histograms_cuda(*args, 8, 255)) == 0


def test_hist_dispatch_goes_to_kernel(dev):
    Xb, g, h, ni = _hist_case(4096, 5, 31, 2)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    before = hist_cuda.launches
    histogram.build_histograms(*args, 2, 31)
    assert hist_cuda.launches == before + 1


def _int_hist_case(R, F, B, N, grad_dtype, seed=0):
    rng = np.random.default_rng(seed)
    npdt = np.int8 if grad_dtype == "int8" else np.int16
    qmax = 127 if grad_dtype == "int8" else 32767
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    qg = rng.integers(-qmax, qmax + 1, size=R).astype(npdt)
    qh = rng.integers(0, qmax + 1, size=R).astype(npdt)
    qg[rng.random(R) < 0.2] = 0
    ni = rng.integers(0, N, size=R).astype(np.int32)
    ni[rng.random(R) < 0.1] = -1
    return Xb, qg, qh, ni


@pytest.mark.parametrize("grad_dtype", ["int8", "int16"])
@pytest.mark.parametrize("R,F,B,N", [
    (100_003, 28, 255, 1),
    (100_003, 28, 255, 32),
    (50_001, 28, 128, 16),
    (50_001, 28, 64, 32),
    (20_000, 120, 256, 4),    # feature slabs
    (5, 3, 16, 4),
])
def test_int_hist_kernel_bitwise_equals_plain(dev, grad_dtype, R, F, B, N):
    Xb, qg, qh, ni = _int_hist_case(R, F, B, N, grad_dtype)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, qg, qh, ni)]
    before = (hist_cuda.launches, hist_cuda.launches_int)
    got = hist_cuda.build_histograms_cuda(*args, N, B)
    assert (hist_cuda.launches, hist_cuda.launches_int) == (
        before[0], before[1] + 1)
    want = histogram.build_histograms_segment(*args, N, B)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == (N, F, B, 2)
    assert torch.equal(got, want)
    assert torch.equal(hist_cuda.build_histograms_cuda(*args, N, B), got)


def test_int_hist_all_frozen_is_zero(dev):
    Xb, qg, qh, ni = _int_hist_case(3000, 4, 255, 8, "int8")
    ni[:] = -1
    args = [torch.from_numpy(a).to(dev) for a in (Xb, qg, qh, ni)]
    out = hist_cuda.build_histograms_cuda(*args, 8, 255)
    assert out.dtype == torch.int32 and torch.count_nonzero(out) == 0


def test_int_hist_dispatch_goes_to_kernel(dev):
    Xb, qg, qh, ni = _int_hist_case(4096, 5, 31, 2, "int8")
    args = [torch.from_numpy(a).to(dev) for a in (Xb, qg, qh, ni)]
    before = (hist_cuda.launches, hist_cuda.launches_int)
    out = histogram.build_histograms(*args, 2, 31)
    assert (hist_cuda.launches, hist_cuda.launches_int) == (
        before[0], before[1] + 1)
    assert out.dtype == torch.int32


def test_int_hist_refuses_mixed_dtypes(dev):
    Xb, qg, qh, ni = _int_hist_case(1000, 3, 31, 2, "int8")
    Xd, gd, hd, nd = [torch.from_numpy(a).to(dev) for a in (Xb, qg, qh, ni)]
    with pytest.raises(TypeError, match="h must be"):
        hist_cuda.build_histograms_cuda(Xd, gd, hd.to(torch.int16), nd, 2, 31)
    with pytest.raises(TypeError, match="h must be"):
        hist_cuda.build_histograms_cuda(Xd, gd.float(), hd, nd, 2, 31)
    with pytest.raises(TypeError, match="g must be"):
        hist_cuda.build_histograms_cuda(Xd, gd.to(torch.int32),
                                        hd.to(torch.int32), nd, 2, 31)


def test_quantized_grow_tree_on_card_launches_int_kernel(dev):
    """One quantized tree on the card: the integer mode runs, the f32 mode
    does not, and the tree equals the CPU plain path's bitwise (integer
    histograms; same f32 ops on both)."""
    from ddt_tpu_torch.ops import grow

    rng = np.random.default_rng(3)
    R, F, B = 20_000, 8, 63
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.integers(-64, 65, size=R).astype(np.float32)
    h = rng.integers(1, 65, size=R).astype(np.float32)
    g[0] = h[0] = 127          # exact grid: scale 1, exact dequantize
    kw = dict(max_depth=4, n_bins=B, reg_lambda=1.0, min_child_weight=1e-3,
              min_split_gain=0.0, hist_subtraction=True, grad_dtype="int8",
              quant_seed=5, quant_tree_id=2)
    before = (hist_cuda.launches, hist_cuda.launches_int)
    on_card = grow.grow_tree(*[torch.from_numpy(a).to(dev)
                               for a in (Xb, g, h)], **kw)
    torch.cuda.synchronize()
    assert hist_cuda.launches == before[0]
    assert hist_cuda.launches_int > before[1]
    on_cpu = grow.grow_tree(*[torch.from_numpy(a) for a in (Xb, g, h)], **kw)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


# Shapes at the kernel's edges: F not a multiple of 4 (rows not 4-byte
# aligned), fewer rows than one block has threads, a row count that is no
# multiple of them, one bin and 256, 64 nodes (16 node ranges).
HIST_EDGE_CASES = [
    (100_003, 3, 255, 4),
    (50_001, 27, 255, 8),
    (50_001, 29, 255, 16),      # 6 ranges of 3 nodes
    (700, 28, 255, 2),          # below one block's 1024 rows
    (3_077, 29, 63, 32),        # not a multiple of 1024 rows
    (20_000, 5, 1, 3),          # one bin
    (20_000, 28, 256, 64),      # 16 ranges
    (20_000, 28, 64, 64),
]


def _edge_case(R, F, B, N, mode, seed=0):
    if mode == "f32":
        return _hist_case(R, F, B, N, seed=seed)
    return _int_hist_case(R, F, B, N, mode, seed=seed)


def _check_hist(Xb, g, h, ni, N, B, got, dev):
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    want = histogram.build_histograms_segment(*args, N, B)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (N, Xb.shape[1], B, 2)
    assert got.dtype == want.dtype
    if got.dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().cpu().numpy()
        assert np.all(err <= _hist_tol(Xb, g, h, ni, N, B)), float(err.max())


@pytest.mark.parametrize("mode", ["f32", "int8", "int16"])
@pytest.mark.parametrize("R,F,B,N", HIST_EDGE_CASES)
def test_hist_kernel_edge_shapes(dev, mode, R, F, B, N):
    Xb, g, h, ni = _edge_case(R, F, B, N, mode)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    before = hist_cuda.launches + hist_cuda.launches_int
    got = hist_cuda.build_histograms_cuda(*args, N, B)
    assert hist_cuda.launches + hist_cuda.launches_int == before + 1
    _check_hist(Xb, g, h, ni, N, B, got, dev)


@pytest.mark.parametrize("mode", ["f32", "int8", "int16"])
def test_hist_kernel_unaligned_rows(dev, mode):
    # Xb a contiguous view one row into its storage: with F = 29 no row,
    # and not the first, starts on a 4-byte boundary.
    R, F, B, N = 30_001, 29, 255, 8
    Xb, g, h, ni = _edge_case(R + 1, F, B, N, mode, seed=4)
    Xd = torch.from_numpy(Xb).to(dev)[1:]
    assert Xd.is_contiguous() and Xd.data_ptr() % 4 != 0
    args = [torch.from_numpy(a[1:]).to(dev) for a in (g, h, ni)]
    got = hist_cuda.build_histograms_cuda(Xd, *args, N, B)
    _check_hist(Xb[1:], g[1:], h[1:], ni[1:], N, B, got, dev)


@pytest.mark.parametrize("mode", ["f32", "int8", "int16"])
@pytest.mark.parametrize("N", [1, 16, 32])
def test_hist_kernel_every_row_frozen(dev, mode, N):
    Xb, g, h, ni = _edge_case(50_000, 28, 255, N, mode)
    ni[:] = -1
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    out = hist_cuda.build_histograms_cuda(*args, N, 255)
    assert out.shape == (N, 28, 255, 2)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("grad_dtype,N", [("int8", 1), ("int16", 1),
                                          ("int16", 16)])
def test_int_hist_large_negative_g_beside_positive_h(dev, grad_dtype, N):
    # Large negative G beside positive H in the same cells: q at -qmax and
    # +qmax, 60,000 rows over 8 of 32 bins of every feature, so each cell
    # sums 7,500 / N rows (at int16 |G| ~ 1.8e8 and H ~ 2.2e8 for N = 1,
    # inside the quantizer's 2^31 cap).
    R, F, B = 60_000, 6, 32
    used = np.array([0, 1, 2, 3, 16, 17, 18, 19], np.uint8)
    qmax = 127 if grad_dtype == "int8" else 32767
    npdt = np.int8 if grad_dtype == "int8" else np.int16
    rng = np.random.default_rng(5)
    Xb = rng.choice(used, size=(R, F))
    qg = np.full(R, -qmax, npdt)
    qh = np.full(R, qmax, npdt)
    qg[::7] = qmax                      # a few positive g's in the mix
    qh[::11] = 0
    ni = rng.integers(0, N, size=R).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, qg, qh, ni)]
    got = hist_cuda.build_histograms_cuda(*args, N, B)
    want = histogram.build_histograms_segment(*args, N, B)
    assert torch.equal(got, want)
    assert int(want[..., 0].min()) < -qmax * R // (8 * N) // 2
    assert bool((want[:, :, used.astype(np.int64), 1] > 0).all())


def _rand_ens(T, depth, F, B, C=1, missing=False, cat=(), exact=True,
              seed=0):
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = empty_ensemble(T, depth, F, 0.125, 0.25,
                         "softmax" if C > 1 else "logloss",
                         n_classes=max(C, 2), missing_bin=missing, n_bins=B,
                         cat_features=tuple(cat))
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 1, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.2
    if exact:
        ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    else:
        ens.leaf_value[:] = rng.standard_normal((T, N))
    if missing:
        ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


def _score_both(ens, X, dev):
    ce = ens.compile(tree_chunk=64)
    ops = [torch.from_numpy(a).to(dev) for a in ce.arrays()]
    kw = dict(max_depth=ce.max_depth, learning_rate=ce.learning_rate,
              base=ce.base_score, tree_chunk=ce.tree_chunk,
              missing_bin_value=ce.missing_bin_value)
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    Xd = torch.from_numpy(X).to(dev)
    tables = predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                      eff_dl=dl, eff_cat=cat)
    got = predict_cuda.traverse_cuda(
        tables, Xd, learning_rate=ce.learning_rate, base=ce.base_score,
        tree_chunk=ce.tree_chunk, missing_bin_value=ce.missing_bin_value)
    want = predict.predict_effective_plain(ef, et, bv, coh, Xd, eff_dl=dl,
                                           eff_cat=cat, **kw)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.parametrize("T,depth,C,missing,cat,R", [
    (70, 6, 7, True, (3, 10), 20_011),
    (100, 6, 1, False, (), 50_000),
    (9, 3, 3, True, (1,), 1_000),
    (130, 2, 1, True, (), 257),
])
def test_traverse_kernel_bitwise_on_exact_grid(dev, T, depth, C, missing,
                                               cat, R):
    F, B = 28, 255
    ens = _rand_ens(T, depth, F, B, C=C, missing=missing, cat=cat)
    X = np.random.default_rng(1).integers(0, B, size=(R, F), dtype=np.uint8)
    got, want = _score_both(ens, X, dev)
    np.testing.assert_array_equal(got, want)
    # And the host oracle (exact-grid values: any summation order agrees).
    ref = ens.predict_raw(X, binned=True)
    np.testing.assert_array_equal(got if C > 1 else got[:, 0], ref)


def test_traverse_kernel_random_leaves_within_tolerance(dev):
    ens = _rand_ens(100, 6, 28, 255, exact=False)
    X = np.random.default_rng(2).integers(0, 255, size=(30_000, 28),
                                          dtype=np.uint8)
    got, want = _score_both(ens, X, dev)
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(want) + 1))


def test_traverse_dispatch_goes_to_kernel(dev):
    ens = _rand_ens(10, 4, 6, 31)
    ce = ens.compile()
    ops = [torch.from_numpy(a).to(dev) for a in ce.arrays()]
    X = torch.randint(0, 31, (1000, 6), dtype=torch.uint8, device=dev)
    before = predict_cuda.launches
    out = predict.predict_raw_effective(
        *ops, X, max_depth=ce.max_depth, learning_rate=ce.learning_rate,
        base=ce.base_score)
    assert predict_cuda.launches == before + 1
    assert out.shape == (1000,)


def _k3_plan(dev, R, T, depth, F, C):
    return predict_lut_cuda.plan_launch(
        R, T, depth, F, "float32", C, _build.smem_limit(dev),
        predict_lut_cuda.sm_count(dev))


def _crossover(dev) -> int:
    """The first batch the rows mapping takes at the Higgs shape: a block
    of 512 rows an SM (67,584 rows on an H100)."""
    return 512 * predict_lut_cuda.sm_count(dev)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("T,C,missing,cat", [(70, 7, True, (3, 10)),
                                             (100, 1, False, ())])
def test_traverse_kernel_bitwise_at_every_batch_size(dev, T, C, missing,
                                                     cat, exact):
    """Both mappings (pairs below the crossover, then two rows a thread),
    with the padded trees left out: bitwise equal to the plain version on
    any leaves (both sum tree by tree in the same order), and each row's
    score the same whatever batch it rides in."""
    F, B = 28, 255
    ens = _rand_ens(T, 6, F, B, C=C, missing=missing, cat=cat, exact=exact)
    cross = _crossover(dev)
    X = np.random.default_rng(4).integers(0, B, size=(cross + 1000, F),
                                          dtype=np.uint8)
    full, want = _score_both(ens, X, dev)
    np.testing.assert_array_equal(full, want)
    for R in (1, 16, 64, 256, 257, cross - 1, cross):
        assert _k3_plan(dev, R, T, 6, F, C).pairs == (R < cross)
        got, want = _score_both(ens, X[:R], dev)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[:R])


def test_traverse_kernel_bitwise_staging_pass_by_pass(dev):
    """1000 depth-6 trees: more records than a block holds, so the kernel
    stages them pass by pass (both mappings), across chunk boundaries
    inside and between passes. Bitwise equal to the plain version."""
    F, T = 28, 1000
    ens = _rand_ens(T, 6, F, 255, C=3, missing=True, cat=(5,), exact=False)
    X = np.random.default_rng(6).integers(0, 255, size=(100_000, F),
                                          dtype=np.uint8)
    for R in (1, 300, 100_000):
        p = _k3_plan(dev, R, T, 6, F, 3)
        assert p.sub < T and p.pairs == (R < _crossover(dev))
        got, want = _score_both(ens, X[:R], dev)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("missing", [False, True])
def test_traverse_kernel_bitwise_with_out_of_range_thresholds(dev, missing):
    """Real-node thresholds -7, -1, 255, 256 and 1000, categorical nodes
    included, over rows that reach bin 255: the records' clamped
    thresholds route every row as the int32 ones do. Bitwise equal to the
    plain version in both mappings, and to the host oracle on exact-grid
    leaves."""
    F, B = 28, 256
    ens = _rand_ens(40, 6, F, B, C=3, missing=missing, cat=(1, 3))
    rng = np.random.default_rng(8)
    odd = rng.random(ens.threshold_bin.shape) < 0.35
    ens.threshold_bin[:] = np.where(
        odd, rng.choice([-7, -1, 255, 256, 1000], size=odd.shape),
        ens.threshold_bin)
    X = rng.integers(0, B, size=(_crossover(dev) + 10, F), dtype=np.uint8)
    for R in (1, 256, X.shape[0]):
        got, want = _score_both(ens, X[:R], dev)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ens.predict_raw(X[:R],
                                                           binned=True))


def test_traverse_kernel_bitwise_with_one_row_a_thread(dev):
    """600 features: the rows mapping walks one row a thread (512 rows do
    not fit beside a tree); depth 5 takes the runtime-depth build."""
    F = 600
    ens = _rand_ens(40, 5, F, 255, C=3, missing=True, cat=(7,),
                    exact=False)
    X = np.random.default_rng(5).integers(0, 255, size=(40_000, F),
                                          dtype=np.uint8)
    p = _k3_plan(dev, 40_000, 40, 5, F, 3)
    assert not p.pairs and p.rows == 256
    full, _ = _score_both(ens, X, dev)
    for R in (1, 300, 40_000):
        got, want = _score_both(ens, X[:R], dev)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[:R])


# --------------------------------------------------------------------- #
# K4 / K5: the LUT kernels (csrc/lut.cu) against their plain versions.
# Exact-grid leaves sit on the 1/(qmax+1) grid with each tree's largest
# |leaf| pinned to qmax/(qmax+1), so the per-tree scale is exact
# (qmax 7 for int4, 127 for int8) and quantization lossless.
# --------------------------------------------------------------------- #

def _lut_ens(T, depth, F, B, C, missing, cat, leaf_dtype, exact=True,
             seed=0):
    ens = _rand_ens(T, depth, F, B, C=C, missing=missing, cat=cat,
                    exact=exact, seed=seed)
    if exact:
        qmax = 127 if leaf_dtype == "int8" else 7
        rng = np.random.default_rng(seed + 1)
        ens.leaf_value[:] = rng.integers(
            -qmax, qmax + 1, size=ens.leaf_value.shape) / (qmax + 1)
        ens.is_leaf[:, [(1 << d) - 1 for d in range(depth)]] = False
        ens.leaf_value[:, (1 << depth) - 1] = qmax / (qmax + 1)
    return ens


def _lut_both(tables, X, dev):
    if tables.leaf_dtype == "int4":
        p = tables.pack_int4()
        host, static = p.ops, p.static_kwargs()
        kernel = predict_lut_cuda.lut_int4_cuda
        plain = predict_lut.predict_effective_lut4_plain
    else:
        host = predict_lut.lut_device_operands(tables)
        static = predict_lut.lut_static_kwargs(tables)
        kernel = predict_lut_cuda.lut_int8_cuda
        plain = predict_lut.predict_effective_lut_plain
    ops = tuple(torch.from_numpy(a).to(dev) for a in host)
    Xd = torch.from_numpy(X).to(dev)
    got = kernel(ops, Xd, **static)
    want = plain(ops, Xd, **static)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


LUT_CASES = [
    ("float16", 255, 7, True, (3, 10), 70, 6, 20_011),
    ("int8", 255, 7, True, (3, 10), 70, 6, 20_011),
    ("int4", 13, 7, True, (3, 10), 70, 6, 20_011),     # nibble thresholds
    ("int4", 255, 1, False, (), 100, 6, 50_000),       # int8 thresholds
    ("int8", 31, 3, True, (1,), 9, 3, 1_000),
    ("int4", 13, 1, True, (), 130, 2, 257),
]


@pytest.mark.parametrize("leaf_dtype,B,C,missing,cat,T,depth,R", LUT_CASES)
def test_lut_kernels_bitwise_on_exact_grid(dev, leaf_dtype, B, C, missing,
                                           cat, T, depth, R):
    F = 28
    ens = _lut_ens(T, depth, F, B, C, missing, cat, leaf_dtype)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype)
    assert tables.max_abs_err == 0.0
    if leaf_dtype == "int4":
        assert tables.pack_int4().thr_packed == (B <= 15)
    X = np.random.default_rng(1).integers(0, B, size=(R, F),
                                          dtype=np.uint8)
    got, want = _lut_both(tables, X, dev)
    np.testing.assert_array_equal(got, want)
    ref = ens.predict_raw(X, binned=True)       # lossless grid: the oracle
    np.testing.assert_array_equal(got if C > 1 else got[:, 0], ref)


@pytest.mark.parametrize("leaf_dtype,B,C,missing,cat,T,depth,R",
                         LUT_CASES[::2])
def test_lut_kernels_random_leaves_within_tolerance(dev, leaf_dtype, B, C,
                                                    missing, cat, T, depth,
                                                    R):
    F = 28
    ens = _lut_ens(T, depth, F, B, C, missing, cat, leaf_dtype, exact=False)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype)
    X = np.random.default_rng(2).integers(0, B, size=(R, F),
                                          dtype=np.uint8)
    got, want = _lut_both(tables, X, dev)
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(want) + 1))
    f32 = ens.predict_raw(X, binned=True)
    f32 = f32 if C > 1 else f32[:, None]
    assert np.all(np.abs(got - f32) <= tables.max_abs_err * (1 + 1e-5)
                  + 1e-5 * (np.abs(f32) + 1))


@pytest.mark.parametrize("leaf_dtype,B", [("float16", 255), ("int8", 255),
                                          ("int4", 13), ("int4", 255)])
@pytest.mark.parametrize("T", [70, 100])
def test_lut_kernels_bitwise_at_every_batch_size(dev, leaf_dtype, B, T):
    """Both mappings (on an H100: pairs below 67,584 rows, then the rows
    mapping with two rows a thread), with padded trees left out: bitwise
    equal to the plain version on random leaves (both sum tree by tree in
    the same order), and each row's score the same whatever batch it
    rides in."""
    F, C = 28, 7
    ens = _lut_ens(T, 6, F, B, C, True, (3, 10), leaf_dtype, exact=False)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype)
    X = np.random.default_rng(4).integers(0, B, size=(300_000, F),
                                          dtype=np.uint8)
    _, full = _lut_both(tables, X, dev)
    for R in (1, 2, 31, 255, 256, 257, 1000, 50_000, 300_000):
        got, want = _lut_both(tables, X[:R], dev)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[:R])


@pytest.mark.parametrize("leaf_dtype,B", [("float16", 255), ("int4", 13)])
def test_lut_kernels_bitwise_with_one_row_a_thread(dev, leaf_dtype, B):
    """600 features: the rows mapping walks one row a thread (512 rows do
    not fit beside a tree); depth 5 takes the kernels' runtime-depth
    build. Bitwise equal to the plain version in both mappings."""
    F = 600
    ens = _lut_ens(40, 5, F, B, 3, True, (7,), leaf_dtype, exact=False)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype)
    X = np.random.default_rng(5).integers(0, B, size=(40_000, F),
                                          dtype=np.uint8)
    p = predict_lut_cuda.plan_launch(
        40_000, 40, 5, F, leaf_dtype, 3, _build.smem_limit(dev),
        predict_lut_cuda.sm_count(dev))
    assert not p.pairs and p.rows == 256
    _, full = _lut_both(tables, X, dev)
    for R in (1, 300, 40_000):
        got, want = _lut_both(tables, X[:R], dev)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full[:R])


@pytest.mark.parametrize("leaf_dtype,B", [("float16", 255), ("int4", 13)])
def test_lut_kernels_bitwise_staging_pass_by_pass(dev, leaf_dtype, B):
    """1000 depth-6 trees: more records than a block holds, so the kernel
    stages them pass by pass (both mappings), across chunk boundaries
    inside and between passes. Bitwise equal to the plain version."""
    F, T = 28, 1000
    ens = _lut_ens(T, 6, F, B, 1, True, (), leaf_dtype, exact=False)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype)
    X = np.random.default_rng(6).integers(0, B, size=(100_000, F),
                                          dtype=np.uint8)
    for R in (1, 300, 100_000):
        p = predict_lut_cuda.plan_launch(
            R, T, 6, F, leaf_dtype, 1, _build.smem_limit(dev),
            predict_lut_cuda.sm_count(dev))
        assert p.sub < T
        got, want = _lut_both(tables, X[:R], dev)
        np.testing.assert_array_equal(got, want)


def test_lut_kernel_refuses_rows_that_do_not_fit_shared_memory(dev):
    F = 240_000                 # one row beside one tree exceeds the card
    ens = _lut_ens(8, 3, F, 31, 1, False, (), "float16")
    tables = ens.compile(tree_chunk=8).quantize()
    assert not predict_lut.predict_lut_fits(
        8, 8, 3, F, 1, smem_limit=_build.smem_limit(dev))
    X = np.zeros((10, F), np.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        _lut_both(tables, X, dev)


def test_lut_dispatch_and_backend_tier_go_to_the_kernels(dev):
    from ddt_tpu_torch.backends.cuda import CUDADevice
    from ddt_tpu_torch.config import TrainConfig

    ens = _lut_ens(20, 4, 6, 13, 1, False, (), "int4")
    X = np.random.default_rng(3).integers(0, 13, (500, 6), dtype=np.uint8)
    ce = ens.compile()
    Xd = torch.from_numpy(X).to(dev)
    b8, b4 = predict_lut_cuda.launches_lut, predict_lut_cuda.launches_lut4
    out8 = predict_lut.predict_effective_lut(ce.quantize(), Xd)
    out4 = predict_lut.predict_effective_lut4(ce.quantize("int4"), Xd)
    assert predict_lut_cuda.launches_lut == b8 + 1
    assert predict_lut_cuda.launches_lut4 == b4 + 1
    assert out8.shape == out4.shape == (500,)
    be = CUDADevice(TrainConfig(n_bins=13, predict_impl="lut4"))
    got = be.predict_raw(ens, X)
    assert be.resolved_predict_impl(ce.token) == "lut4"
    assert predict_lut_cuda.launches_lut4 == b4 + 2
    np.testing.assert_array_equal(got, out4.cpu().numpy())


# --------------------------------------------------------------------- #
# binning on the card, the fused round as a CUDA graph
# --------------------------------------------------------------------- #

def _binning_case(R=30_000, F=7, seed=0):
    """Float rows with NaN, +/-inf, -0.0, a low-cardinality column (runs
    of duplicate edges) and an integer column fitted as identity."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((R, F)).astype(np.float32)
    X[:, 1] = rng.integers(0, 4, R)
    X[:, 2] = rng.integers(0, 40, R)
    for v, p in ((np.nan, 0.05), (np.inf, 0.01), (-np.inf, 0.01),
                 (-0.0, 0.01), (0.0, 0.01)):
        X[rng.random((R, F)) < p] = v
    return X


@pytest.mark.parametrize("missing_policy", ["zero", "learn"])
@pytest.mark.parametrize("row_block", [30_000, 10_000])
def test_transform_binned_on_card_equals_cpu(dev, missing_policy,
                                             row_block):
    from ddt_tpu_torch.data.quantizer import (feature_bincounts,
                                              fit_bin_mapper)
    from ddt_tpu_torch.ops import quantize

    X = _binning_case()
    m = fit_bin_mapper(X, n_bins=255, missing_policy=missing_policy,
                       cat_features=(2,))
    e = torch.from_numpy(m.edges)
    cpu = quantize.transform_binned(torch.from_numpy(X), e, 255,
                                    m.missing_bin, row_block=row_block)
    before = quantize.transforms
    card = quantize.transform_binned(torch.from_numpy(X).to(dev),
                                     e.to(dev), 255, m.missing_bin,
                                     row_block=row_block)
    assert quantize.transforms == before + 1
    assert card.device.type == "cuda" and card.is_contiguous()
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
    np.testing.assert_array_equal(card.cpu().numpy(), m.transform(X))
    np.testing.assert_array_equal(
        feature_bincounts(card, 255).cpu().numpy(),
        feature_bincounts(m.transform(X), 255))


def test_cuda_upload_of_a_device_tensor_copies_nothing_to_the_host(
        dev, monkeypatch):
    from ddt_tpu_torch.backends.cuda import CUDADevice
    from ddt_tpu_torch.config import TrainConfig

    be = CUDADevice(TrainConfig(n_bins=16))
    Xd = torch.randint(0, 16, (1000, 5), dtype=torch.uint8, device=dev)

    def refuse(*a, **k):
        raise AssertionError("the binned matrix went to the host")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    out = be.upload(Xd)
    assert out.data_ptr() == Xd.data_ptr()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="n_bins"):
        be.upload(torch.full((4, 2), 16, dtype=torch.uint8, device=dev))


def _fused_case(R=20_000, F=9, B=63, seed=1):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    logit = (Xb[:, 0].astype(np.float32) - B / 2) / 8 \
        + (Xb[:, 3] > B // 3) - 0.5
    y = (rng.random(R) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return Xb, y


@pytest.mark.parametrize("sampling", [{}, dict(subsample=0.8,
                                               colsample_bytree=0.8)])
@pytest.mark.parametrize("grad_dtype", ["int8", "int16"])
def test_captured_round_replays_equal_the_granular_loop(dev, grad_dtype,
                                                        sampling):
    """Integer histograms are exact, so the graph's trees equal the
    granular loop's bit for bit on the card, with bagging and colsample
    read from the round tensors."""
    from ddt_tpu_torch.backends.cuda import CUDADevice
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver
    from ddt_tpu_torch.models.tree import empty_ensemble
    from ddt_tpu_torch.ops.grad import base_score_np

    Xb, y = _fused_case()
    cfg = TrainConfig(n_trees=7, max_depth=5, n_bins=63, seed=3,
                      grad_dtype=grad_dtype, fused_block_rounds=3,
                      **sampling)
    be = CUDADevice(cfg)
    fused = Driver(be, cfg).fit(Xb, y)
    drv = Driver(be, cfg)
    bs = base_score_np(y, cfg.loss)
    yd = be.upload_labels(y)
    granular = drv._fit_granular(
        be.upload(Xb), yd, be.init_pred(yd, bs),
        empty_ensemble(7, 5, Xb.shape[1], cfg.learning_rate, bs, cfg.loss,
                       n_bins=63))
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value",
              "split_gain", "default_left"):
        np.testing.assert_array_equal(getattr(fused, k),
                                      getattr(granular, k))


def test_launch_counters_advance_per_replay(dev):
    from ddt_tpu_torch.backends import cuda as cuda_be
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.ops.grad import base_score_np

    Xb, y = _fused_case()
    cfg = TrainConfig(max_depth=4, n_bins=63, grad_dtype="int8")
    be = cuda_be.CUDADevice(cfg)
    data, yd = be.upload(Xb), be.upload_labels(y)
    pred = be.init_pred(yd, base_score_np(y, cfg.loss))
    l0, i0 = hist_cuda.launches, hist_cuda.launches_int
    c0, r0 = cuda_be.graph_captures, cuda_be.graph_replays
    trees, pred1, losses = be.grow_rounds(data, pred, yd, 5)
    torch.cuda.synchronize()
    # The warm-up round runs outside the graph and counts: 1 + 5 rounds of
    # 4 levels (one histogram launch a level with sibling subtraction).
    assert hist_cuda.launches_int - i0 == 6 * 4
    assert hist_cuda.launches == l0
    assert (cuda_be.graph_captures - c0, cuda_be.graph_replays - r0) \
        == (1, 5)
    assert trees.shape == (5, 6, 31) and losses.shape == (5,)
    assert bool(torch.isfinite(losses).all())
    # Same key: no recapture, every launch is a replay's.
    be.grow_rounds(data, pred1, yd, 3, first_round=5)
    torch.cuda.synchronize()
    assert hist_cuda.launches_int - i0 == 6 * 4 + 3 * 4
    assert (cuda_be.graph_captures - c0, cuda_be.graph_replays - r0) \
        == (1, 8)
    # The losses are the rounds' own: they fall as the trees add up.
    assert float(losses[-1]) < float(losses[0])


# --------------------------------------------------------------------- #
# the training matrix on the card: softmax, eval in the captured round,
# weights, learned missing values, categorical splits, resume
# --------------------------------------------------------------------- #

_FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value",
           "split_gain", "default_left")


def _granular_backend(cfg):
    from ddt_tpu_torch.backends.cuda import CUDADevice

    class Granular(CUDADevice):
        grow_rounds = None

    return Granular(cfg)


def _multiclass_case(R=20_000, F=12, C=4, B=63, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, B, size=(C, F))
    y = rng.integers(0, C, R)
    Xb = np.clip(centers[y] + rng.integers(-12, 13, size=(R, F)), 0, B - 1)
    return Xb.astype(np.uint8), y.astype(np.int32)


@pytest.mark.parametrize("metric", ["logloss", "accuracy"])
def test_captured_softmax_round_with_eval_equals_granular(dev, metric):
    """int8 histograms are exact: the captured softmax round with the eval
    step, weights, bagging and colsample equals the granular loop bit for
    bit, eval scores included."""
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver

    Xb, y = _multiclass_case()
    w = np.random.default_rng(4).integers(0, 3, len(y)).astype(np.float32)
    cfg = TrainConfig(n_trees=6, max_depth=5, n_bins=63, loss="softmax",
                      n_classes=4, grad_dtype="int8", subsample=0.8,
                      colsample_bytree=0.7, seed=3, fused_block_rounds=4)
    kw = dict(eval_set=(Xb[16_000:], y[16_000:]), eval_metric=metric,
              early_stopping_rounds=3, sample_weight=w[:16_000])
    fd, gd = Driver(get_backend(cfg), cfg), Driver(_granular_backend(cfg),
                                                   cfg)
    fused = fd.fit(Xb[:16_000], y[:16_000], **kw)
    gran = gd.fit(Xb[:16_000], y[:16_000], **kw)
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(fused, k), getattr(gran, k))
    key = f"valid_{metric}"
    assert [r[key] for r in fd.history] == [r[key] for r in gd.history]
    assert fd.best_round == gd.best_round


def test_eval_graph_key_recaptures_on_a_new_eval_set(dev):
    from ddt_tpu_torch.backends import cuda as cuda_be
    from ddt_tpu_torch.config import TrainConfig

    Xb, y = _multiclass_case(R=8_000)
    cfg = TrainConfig(max_depth=4, n_bins=63, loss="softmax", n_classes=4,
                      grad_dtype="int8")
    be = cuda_be.CUDADevice(cfg)
    data, yd = be.upload(Xb[:6000]), be.upload_labels(y[:6000])
    pred = be.init_pred(yd, 0.0)
    v1, vy1 = be.upload(Xb[6000:]), be.upload_labels(y[6000:])
    vp = torch.zeros((2000, 4), device=dev)
    c0 = cuda_be.graph_captures
    out = be.grow_rounds_eval(data, pred, yd, 3, v1, vp, vy1, "logloss")
    be.grow_rounds_eval(data, out[1], yd, 2, v1, out[3], vy1, "logloss",
                        first_round=3)
    assert cuda_be.graph_captures - c0 == 1
    v2 = be.upload(Xb[6000:].copy())           # same rows, new address
    again = be.grow_rounds_eval(data, pred, yd, 3, v2, vp, vy1, "logloss")
    assert cuda_be.graph_captures - c0 == 2
    assert torch.equal(again[4], out[4])       # same scores from rows
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["missing", "categorical"])
def test_missing_and_categorical_fused_equal_granular(dev, case):
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver

    rng = np.random.default_rng(7)
    R, F, B = 20_000, 8, 31
    Xb = rng.integers(0, B, size=(R, F)).astype(np.uint8)
    logit = (Xb[:, 0].astype(np.float32) - 14) / 5 + (Xb[:, 2] == 7) * 2.0
    if case == "missing":
        Xb[rng.random((R, F)) < 0.1] = B - 1
        logit += (Xb[:, 1] == B - 1) * 1.5
        kw = dict(missing_policy="learn")
    else:
        kw = dict(cat_features=(2, 5))
    y = (rng.random(R) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    cfg = TrainConfig(n_trees=5, max_depth=4, n_bins=B, grad_dtype="int8",
                      fused_block_rounds=2, **kw)
    fused = Driver(get_backend(cfg), cfg).fit(Xb, y)
    gran = Driver(_granular_backend(cfg), cfg).fit(Xb, y)
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(fused, k), getattr(gran, k))
    if case == "missing":
        assert fused.default_left.any()
    else:
        assert np.isin(fused.feature, (2, 5)).any()
    got, want = _score_both(fused, Xb, dev)
    np.testing.assert_array_equal(got, want)


def test_int8_resume_is_bitwise_on_card(dev, tmp_path):
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver

    Xb, y = _multiclass_case(R=12_000)
    cfg = TrainConfig(n_trees=6, max_depth=4, n_bins=63, loss="softmax",
                      n_classes=4, grad_dtype="int8")
    ev = dict(eval_set=(Xb[10_000:], y[10_000:]))
    whole = Driver(get_backend(cfg), cfg)
    full = whole.fit(Xb[:10_000], y[:10_000], **ev)
    ck = str(tmp_path / "ck")
    Driver(get_backend(cfg), cfg.replace(n_trees=3), checkpoint_dir=ck,
           checkpoint_every=2).fit(Xb[:10_000], y[:10_000], **ev)
    again = Driver(get_backend(cfg), cfg, checkpoint_dir=ck,
                   checkpoint_every=2)
    resumed = again.fit(Xb[:10_000], y[:10_000], **ev)
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))
    assert [r["valid_logloss"] for r in again.history] == \
        [r["valid_logloss"] for r in whole.history[3:]]


def test_hist_kernel_at_covertype_width(dev):
    """K1 at 54 features x 255 bins: a node's table is 110 KB, so two
    nodes share a range and 64 nodes run as 32 ranges."""
    R, F, B, N = 50_000, 54, 255, 64
    plan = hist_cuda.plan_tiles(N, F, B, _build.smem_limit(dev))
    assert (plan.nr, plan.n_ranges, plan.n_slabs) == (2, 32, 1)
    Xb, g, h, ni = _hist_case(R, F, B, N, seed=3)
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    got = hist_cuda.build_histograms_cuda(*args, N, B)
    want = histogram.build_histograms_segment(*args, N, B)
    tol = torch.from_numpy(_hist_tol(Xb, g, h, ni, N, B)).to(dev)
    assert bool(((got - want).abs() <= tol).all())


def test_traverse_depth8_seven_classes_many_trees(dev):
    """K3 at the trained Covertype model's shape class (depth 8, 7
    classes, trees staged pass by pass) equals its plain version bitwise
    at every batch size."""
    ens = _rand_ens(700, 8, 54, 255, C=7, exact=False, seed=4)
    X = np.random.default_rng(4).integers(0, 255, size=(5000, 54),
                                          dtype=np.uint8)
    for n in (1, 256, 5000):
        got, want = _score_both(ens, X[:n], dev)
        np.testing.assert_array_equal(got, want)


def _nccl_case():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((60_000, 12)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + rng.standard_normal(60_000) > 0).astype(np.float32)
    kw = dict(n_trees=6, max_depth=5, n_bins=63, grad_dtype="int8",
              subsample=0.8, seed=1, fused_block_rounds=3)
    return X, y, kw


def test_nccl_world_one_captured_round_equals_granular(dev):
    """One NCCL rank: the round's collectives are captured with it and
    replayed (the comms counters move per replay), and the int8 trees
    equal the granular loop's and the no-group run's bit for bit."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.parallel import spawn, tasks

    X, y, kw = _nccl_case()
    with spawn.Pool(1, backend="nccl", device="cuda") as pool:
        fused = pool.run(tasks.train, X, y, kw)[0]
        gran = pool.run(tasks.train, X, y, kw, None, "granular")[0]
    c = fused["counters"]
    assert c["cuda.graph_captures"] == 1 and c["cuda.graph_replays"] == 6
    # The warm-up round before the capture runs its collectives too.
    assert c["comms.modeled_bytes"] == 7 * fused["bytes_model"] > 0
    assert gran["counters"]["comms.calls"] > 0
    alone = api.train(X, y, TrainConfig(**kw)).ensemble
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(fused["ensemble"], k),
                                      getattr(gran["ensemble"], k))
        np.testing.assert_array_equal(getattr(fused["ensemble"], k),
                                      getattr(alone, k))


@pytest.mark.parametrize("split_comms", ["allreduce", "reduce_scatter"])
def test_two_nccl_ranks_int8_equal_one_card(dev, split_comms):
    """Two ranks on two cards grow the one card's int8 trees bit for
    bit."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.parallel import spawn, tasks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards (NCCL lets no two ranks share one); "
                    f"this machine has {torch.cuda.device_count()}")
    X, y, kw = _nccl_case()
    kw = dict(kw, split_comms=split_comms)
    outs = spawn.spawn(tasks.train, 2, "nccl", "cuda", X, y, kw)
    alone = api.train(X, y, TrainConfig(**kw)).ensemble
    for o in outs:
        assert o["split_comms"] == split_comms
        for k in _FIELDS:
            np.testing.assert_array_equal(getattr(o["ensemble"], k),
                                          getattr(alone, k))


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_hist_kernel_on_a_1024_column_slab(dev, mode):
    """K1 at BASELINE config 5's width: a 1024-column slab of a wider
    matrix (a view, row stride 2048) at 500k rows, against its plain
    version; ~10 feature slabs a node range inside the kernel."""
    R, F, B, N = 500_000, 1024, 255, 4
    rng = np.random.default_rng(11)
    wide = torch.from_numpy(rng.integers(0, B, size=(R, 2 * F),
                                         dtype=np.uint8)).to(dev)
    Xs = wide[:, F:]
    assert Xs.stride() == (2 * F, 1)
    ni = torch.from_numpy(rng.integers(-1, N, R).astype(np.int32)).to(dev)
    if mode == "int8":
        g = torch.from_numpy(rng.integers(-127, 128, R).astype(np.int8))
        h = torch.from_numpy(rng.integers(0, 128, R).astype(np.int8))
    else:
        g = torch.from_numpy(rng.standard_normal(R).astype(np.float32))
        h = torch.from_numpy(rng.random(R).astype(np.float32))
    g, h = g.to(dev), h.to(dev)
    plan = hist_cuda.plan_tiles(N, F, B, _build.smem_limit(dev))
    assert plan.n_slabs >= 9 and plan.nr == 1
    got = hist_cuda.build_histograms_cuda(Xs, g, h, ni, N, B)
    want = histogram.build_histograms_segment(Xs, g, h, ni, N, B)
    if mode == "int8":
        assert torch.equal(got, want)
        return
    tol = 1e-5 * histogram.build_histograms_segment(
        Xs, g.abs(), h.abs(), ni, N, B) + 1e-6
    assert bool(((got - want).abs() <= tol).all())


def test_hist_kernel_refuses_a_column_strided_view(dev):
    Xb = torch.zeros((64, 8), dtype=torch.uint8, device=dev)
    g = torch.zeros(8, dtype=torch.float32, device=dev)
    ni = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="row-major"):
        hist_cuda.build_histograms_cuda(Xb.t(), g, g, ni, 1, 16)


@pytest.mark.parametrize("layout", [
    dict(mesh_shape=(1, 2), hist_comms_slabs=2),
    dict(mesh_shape=(2, 2)),
    dict(host_partitions=2, n_partitions=2, hist_comms_slabs=4)],
    ids=["1x2_slabs2", "2x2", "2hx2_slabs4"])
def test_nccl_mesh_subgroups_captured_int8_equal_one_card(dev, layout):
    """The row, feature and world groups' communicators inside one
    captured round: one capture, a replay a round, the modeled bytes
    counted per replay, and int8 trees bitwise the one card's."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.parallel import spawn, tasks

    world = TrainConfig(**layout).world_size
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards (NCCL lets no two ranks share "
                    f"one); this machine has {torch.cuda.device_count()}")
    X, y, kw = _nccl_case()
    outs = spawn.spawn(tasks.train, world, "nccl", "cuda", X, y,
                       dict(kw, **layout))
    alone = api.train(X, y, TrainConfig(**kw)).ensemble
    for o in outs:
        c = o["counters"]
        assert c["cuda.graph_captures"] == 1
        assert c["cuda.graph_replays"] == kw["n_trees"]
        assert c["comms.modeled_bytes"] == \
            (kw["n_trees"] + 1) * o["bytes_model"] > 0
        for k in _FIELDS:
            np.testing.assert_array_equal(getattr(o["ensemble"], k),
                                          getattr(alone, k))


def test_traverse_kernel_at_config5_width(dev):
    """K3 at 1024 features x depth 6: a block of one row a thread does not
    fit shared memory, so every batch takes the pairs mapping; bitwise
    its plain version at serving and bulk sizes."""
    ens = _rand_ens(20, 6, 1024, 255, C=1, exact=False, seed=9)
    X = np.random.default_rng(9).integers(0, 255, size=(100_000, 1024),
                                          dtype=np.uint8)
    for n in (1, 256, 100_000):
        got, want = _score_both(ens, X[:n], dev)
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# exact f32 histograms (K1's fixed-point mode) and the 1024-feature LUT
# tiers
# --------------------------------------------------------------------- #

def _exact_both(Xd, g, h, ni, N, B, dev, out=None):
    """K1's exact mode and its plain version (on the card) on one input,
    scales from the data's max as training takes them."""
    scales = grad.fixed_scales(grad.abs_max2(g, h), Xd.shape[0])
    got = hist_cuda.build_histograms_cuda(Xd, g, h, ni, N, B, scales=scales,
                                          out=out)
    want = histogram.build_histograms_fixed_segment(Xd, g, h, ni, N, B,
                                                    scales)
    return got, want


@pytest.mark.parametrize("R,F,B,N", [
    (1_000_000, 28, 255, 1),      # Higgs
    (1_000_000, 28, 255, 32),
    (200_000, 54, 255, 64),       # covertype: one node a range
    (50_001, 28, 64, 32),
    (5, 3, 16, 4),
])
def test_exact_hist_kernel_bitwise_equals_plain(dev, R, F, B, N):
    Xb, g, h, ni = _hist_case(R, F, B, N, seed=5)
    g[::7] *= -1e-3                  # small values beside large ones
    args = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    before = hist_cuda.launches_exact, hist_cuda.launches
    got, want = _exact_both(*args, N, B, dev)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert (hist_cuda.launches_exact, hist_cuda.launches) == (
        before[0] + 1, before[1])
    plan = hist_cuda.plan_tiles(N, F, B, _build.smem_limit(dev),
                                hist_cuda.CELL_BYTES_EXACT)
    if F == 54:
        assert (plan.nr, plan.n_ranges) == (1, 64)
    # Twice more, accumulating: the same table summed three times.
    got3 = got.clone()
    _exact_both(*args, N, B, dev, out=got3)
    _exact_both(*args, N, B, dev, out=got3)
    assert torch.equal(got3, 3 * want)


def test_exact_hist_kernel_on_a_1024_column_slab(dev):
    """The exact mode at BASELINE config 5's width: a 1024-column slab of a
    wider matrix (row stride 2048), 19 feature slabs of 16-byte cells a
    node, bitwise its plain version; and chunked sums equal the whole."""
    R, F, B, N = 500_000, 1024, 255, 4
    rng = np.random.default_rng(12)
    wide = torch.from_numpy(rng.integers(0, B, size=(R, 2 * F),
                                         dtype=np.uint8)).to(dev)
    Xs = wide[:, F:]
    ni = torch.from_numpy(rng.integers(-1, N, R).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(R).astype(np.float32)).to(dev)
    plan = hist_cuda.plan_tiles(N, F, B, _build.smem_limit(dev),
                                hist_cuda.CELL_BYTES_EXACT)
    assert plan.n_slabs >= 18 and plan.nr == 1
    got, want = _exact_both(Xs, g, h, ni, N, B, dev)
    assert torch.equal(got, want)
    scales = grad.fixed_scales(grad.abs_max2(g, h), R)
    acc = torch.zeros_like(got)
    for lo in range(0, R, 131_072):
        sl = slice(lo, lo + 131_072)
        hist_cuda.build_histograms_cuda(Xs[sl], g[sl], h[sl], ni[sl], N, B,
                                        scales=scales, out=acc)
    assert torch.equal(acc, got)


def test_exact_hist_kernel_refuses_bad_operands(dev):
    Xd = torch.zeros((8, 3), dtype=torch.uint8, device=dev)
    g = torch.zeros(8, dtype=torch.float32, device=dev)
    ni = torch.zeros(8, dtype=torch.int32, device=dev)
    sc = torch.ones(2, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        hist_cuda.build_histograms_cuda(Xd, g.to(torch.int8),
                                        g.to(torch.int8), ni, 2, 16,
                                        scales=sc)
    with pytest.raises(ValueError, match="out must be"):
        hist_cuda.build_histograms_cuda(
            Xd, g, g, ni, 2, 16, scales=sc,
            out=torch.zeros((2, 3, 16, 2), dtype=torch.int32, device=dev))


def _covertype_shape(R=60_000, seed=6):
    """Covertype's shape class: 54 columns, 7 classes, 255 bins."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 255, size=(7, 54))
    y = rng.integers(0, 7, R)
    Xb = np.clip(centers[y] + rng.integers(-90, 91, size=(R, 54)), 0, 254)
    return Xb.astype(np.uint8), y.astype(np.int32)


def test_f32_covertype_shape_fit_twice_is_bitwise(dev):
    """The same f32 softmax model at covertype's shape, fitted twice on
    the card: every tree and leaf bitwise equal (the exact mode's sums do
    not depend on the order the card adds the rows in)."""
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver

    Xb, y = _covertype_shape()
    cfg = TrainConfig(n_trees=6, max_depth=8, n_bins=255, loss="softmax",
                      n_classes=7, fused_block_rounds=3)
    before = hist_cuda.launches_exact, hist_cuda.launches
    a = Driver(get_backend(cfg), cfg).fit(Xb, y)
    assert hist_cuda.launches_exact > before[0]
    assert hist_cuda.launches == before[1]     # no float atomics
    b = Driver(get_backend(cfg), cfg).fit(Xb, y)
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_f32_resume_is_bitwise_on_card(dev, tmp_path):
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver

    Xb, y = _covertype_shape(R=30_000, seed=7)
    cfg = TrainConfig(n_trees=6, max_depth=6, n_bins=255, loss="softmax",
                      n_classes=7)
    ev = dict(eval_set=(Xb[25_000:], y[25_000:]))
    whole = Driver(get_backend(cfg), cfg)
    full = whole.fit(Xb[:25_000], y[:25_000], **ev)
    ck = str(tmp_path / "ck")
    Driver(get_backend(cfg), cfg.replace(n_trees=3), checkpoint_dir=ck,
           checkpoint_every=2).fit(Xb[:25_000], y[:25_000], **ev)
    again = Driver(get_backend(cfg), cfg, checkpoint_dir=ck,
                   checkpoint_every=2)
    resumed = again.fit(Xb[:25_000], y[:25_000], **ev)
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(full, k), getattr(resumed, k))
    assert [r["valid_logloss"] for r in again.history] == \
        [r["valid_logloss"] for r in whole.history[3:]]


@pytest.mark.parametrize("leaf_dtype", ["float16", "int8", "int4"])
def test_lut_kernels_at_config5_width(dev, leaf_dtype):
    """K4 (fp16 and int8 leaves) and K5 at 1024 features x depth 6: the
    pairs mapping at every batch size, bitwise their plain versions; the
    backend serves the requested tier."""
    from ddt_tpu_torch.backends.cuda import CUDADevice
    from ddt_tpu_torch.config import TrainConfig

    ens = _lut_ens(64, 6, 1024, 255, 1, False, (), leaf_dtype, exact=False,
                   seed=13)
    tables = ens.compile(tree_chunk=64).quantize(leaf_dtype=leaf_dtype)
    X = np.random.default_rng(13).integers(0, 255, size=(100_000, 1024),
                                           dtype=np.uint8)
    for n in (1, 256, 100_000):
        plan = predict_lut_cuda.plan_launch(
            n, 64, 6, 1024, leaf_dtype, 1, _build.smem_limit(dev),
            predict_lut_cuda.sm_count(dev))
        assert plan.pairs
        got, want = _lut_both(tables, X[:n], dev)
        np.testing.assert_array_equal(got, want)
    impl = "lut4" if leaf_dtype == "int4" else "lut"
    if leaf_dtype != "int8":
        be = CUDADevice(TrainConfig(n_bins=255, predict_impl=impl))
        be.predict_raw(ens, X[:256])
        assert be.resolved_predict_impl(ens.cache_token()) == impl


# --------------------------------------------------------------------- #
# streamed training and scoring on the card (ddt_tpu_torch/streaming.py)
# --------------------------------------------------------------------- #

def _stream_case(R=64_000, F=40, B=255, seed=14):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    logit = (Xb[:, 0].astype(np.float32) - B / 2) / 32 \
        + (Xb[:, 5] > B // 3) - 0.5
    y = (rng.random(R) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return Xb, y


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_streamed_trees_equal_in_memory_on_card(dev, grad_dtype, cache):
    """Streamed over 5 ragged chunks (pinned staging, the exact or integer
    tables accumulated on the card) against the in-memory Driver on the
    same rows: every node array bitwise; each chunk transferred
    rounds x (depth + 1) times with the cache off, once with it on; and
    predict_streaming bitwise api.predict."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver
    from ddt_tpu_torch.streaming import fit_streaming, predict_streaming
    from ddt_tpu_torch.telemetry import counters as tele_counters

    Xb, y = _stream_case()
    bounds = [0, 9_000, 30_000, 41_111, 52_000, 64_000]
    pinned = torch.from_numpy(Xb).pin_memory()

    def chunk_fn(c):
        lo, hi = bounds[c], bounds[c + 1]
        # Chunks 0-1 pinned tensors, the rest pageable host arrays.
        return (pinned[lo:hi] if c < 2 else Xb[lo:hi]), y[lo:hi]

    cfg = TrainConfig(n_trees=3, max_depth=6, n_bins=255, subsample=0.9,
                      seed=2, grad_dtype=grad_dtype)
    full = Driver(get_backend(cfg), cfg).fit(Xb, y)
    c0 = tele_counters.snapshot()
    before = hist_cuda.launches_exact, hist_cuda.launches
    streamed = fit_streaming(chunk_fn, 5, cfg, device_chunk_cache=cache)
    torch.cuda.synchronize()
    assert tele_counters.delta(c0)["h2d_bytes"] == \
        Xb.nbytes * (1 if cache else 3 * 7)
    if grad_dtype == "f32":
        assert hist_cuda.launches_exact - before[0] == 5 * 3 * 6
    assert hist_cuda.launches == before[1]
    for k in _FIELDS:
        np.testing.assert_array_equal(getattr(full, k),
                                      getattr(streamed, k))
    got = predict_streaming(chunk_fn, 5, streamed)
    np.testing.assert_array_equal(
        got, api.predict(streamed, Xb, binned=True, raw=True))


def test_nccl_streamed_two_ranks_equal_one_card(dev):
    """Two NCCL ranks, each chunk row-sharded over them and each level's
    exact table all-reduced once, grow the one card's in-memory f32
    trees bitwise (and int8)."""
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.driver import Driver
    from ddt_tpu_torch.parallel import spawn, tasks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards (NCCL lets no two ranks share one); "
                    f"this machine has {torch.cuda.device_count()}")
    Xb, y = _stream_case(seed=15)
    bounds = np.array([0, 16_000, 40_000, 64_000])
    for grad_dtype in ("f32", "int8"):
        kw = dict(n_trees=3, max_depth=6, n_bins=255, grad_dtype=grad_dtype)
        alone = Driver(get_backend(TrainConfig(**kw)),
                       TrainConfig(**kw)).fit(Xb, y)
        outs = spawn.spawn(tasks.train_streaming, 2, "nccl", "cuda", Xb, y,
                           bounds, kw)
        for o in outs:
            for k in _FIELDS:
                np.testing.assert_array_equal(getattr(o["ensemble"], k),
                                              getattr(alone, k))


# --------------------------------------------------------------------- #
# the model's lifecycle: registry restores, multi-card scoring
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lifecycle_model():
    from ddt_tpu_torch import api
    from ddt_tpu_torch.data.datasets import synthetic_binary

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    X, y = synthetic_binary(50_000, n_features=28, seed=21)
    res = api.train(X, y, n_trees=20, max_depth=6, n_bins=255)
    return X, res


@pytest.mark.parametrize("quantize,impl", [(False, "auto"), ("int8", "lut"),
                                           ("int4", "lut4")])
def test_registry_restore_bitwise_api_predict_on_card(
        dev, lifecycle_model, tmp_path, quantize, impl):
    from ddt_tpu_torch import _build, api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.registry.loader import load_servable, push_servable

    X, res = lifecycle_model
    root = str(tmp_path / "reg")
    push_servable(root, api.ModelBundle(res.ensemble, res.mapper),
                  name="m", max_batch=64, quantize=quantize)
    builds = _build.builds
    rep = load_servable(root, "m")
    rep.model.warmup()
    def counters():
        return (predict_cuda.launches, predict_lut_cuda.launches_lut,
                predict_lut_cuda.launches_lut4)

    Xb = res.mapper.transform_device(X[:5000], dev)
    before = counters()
    got = rep.model.score_binned(Xb)
    moved = [a - b for a, b in zip(counters(), before)]
    want = api.predict(res.ensemble, X[:5000], mapper=res.mapper,
                       cfg=TrainConfig(predict_impl=impl))
    assert np.array_equal(got, want)
    assert _build.builds == builds          # nothing rebuilt to restore
    tier = {"auto": 0, "lut": 1, "lut4": 2}[impl]
    assert moved[tier] > 0 and sum(moved) == moved[tier], moved
    assert rep.model.predict_impl == {"auto": "f32"}.get(impl, impl)


def test_n_partitions_across_cards_bitwise_one_card(dev, lifecycle_model):
    from ddt_tpu_torch import api

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 cards for multi-card scoring; this machine "
                    f"has {n}")
    X, res = lifecycle_model
    want = api.predict(res.ensemble, X, mapper=res.mapper, raw=True)
    for k in range(2, min(4, n) + 1):
        before = predict_cuda.launches
        got = api.predict(res.ensemble, X, mapper=res.mapper, raw=True,
                          n_partitions=k)
        assert np.array_equal(got, want), k
        assert predict_cuda.launches - before == k
    with pytest.raises(ValueError, match="CUDA cards visible"):
        api.predict(res.ensemble, X[:10], mapper=res.mapper,
                    n_partitions=n + 1)


# --------------------------------------------------------------------- #
# the serving plane on the card: fleet, eviction, shadow, cli serve
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fleet_models(lifecycle_model, tmp_path_factory):
    """Three registry artifacts of the lifecycle model's data at f32,
    int8 and int4 (learning rates 0.1, 0.05, 0.2), and each one's offline
    api.predict on 2,000 rows at its tier."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.data.datasets import synthetic_binary
    from ddt_tpu_torch.registry.loader import push_servable

    X, res = lifecycle_model
    _, y = synthetic_binary(50_000, n_features=28, seed=21)
    root = str(tmp_path_factory.mktemp("card_fleet") / "reg")
    tiers = {"f32": (False, "auto", 0.1), "i8": ("int8", "lut", 0.05),
             "i4": ("int4", "lut4", 0.2)}
    want, bundles = {}, {}
    for name, (q, impl, lr) in tiers.items():
        r = res if lr == 0.1 else api.train(X, y, n_trees=20, max_depth=6,
                                            n_bins=255, learning_rate=lr)
        b = api.ModelBundle(r.ensemble, r.mapper)
        push_servable(root, b, name=name, max_batch=256, quantize=q)
        want[name] = api.predict(b, X[:2000],
                                 cfg=TrainConfig(predict_impl=impl))
        bundles[name] = b
    return dict(X=X[:2000], root=root, want=want, bundles=bundles)


def _card_fleet(fleet_models, **kw):
    from ddt_tpu_torch.serve.control import build_fleet, parse_models_arg

    return build_fleet(parse_models_arg("f32@1,i8@1,i4@1"),
                       registry=fleet_models["root"], max_wait_ms=1.0, **kw)


def test_fleet_storm_bitwise_each_tier_on_card(dev, fleet_models):
    """Concurrent traffic over three models at f32, int8 and int4 with
    max_resident 2: no failure, every response bitwise its artifact's
    offline answer at its tier, each tier's kernel launched."""
    import threading

    X, want = fleet_models["X"], fleet_models["want"]
    eng = _card_fleet(fleet_models, max_resident=2)
    before = (predict_cuda.launches, predict_lut_cuda.launches_lut,
              predict_lut_cuda.launches_lut4)
    errs, got = [], []
    lock = threading.Lock()

    def worker(t):
        rng = np.random.default_rng(t)
        for i in range(20):
            name = ("f32", "i8", "i4")[(t + i) % 3]
            s, c = int(rng.integers(0, 1900)), int(rng.integers(1, 65))
            try:
                out = eng.predict(X[s:s + c], model=name, timeout=120.0)
            except Exception as e:  # ddtlint: disable=broad-except — collected and asserted empty
                with lock:
                    errs.append(repr(e))
                continue
            with lock:
                got.append((name, s, c, out))

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:3]
        for name, s, c, out in got:
            assert np.array_equal(out, want[name][s:s + c]), (name, s, c)
        h = eng.health()
        assert h["evictions"] >= 1 and h["reloads"] >= 1
    finally:
        eng.close()
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip((predict_cuda.launches,
                                    predict_lut_cuda.launches_lut,
                                    predict_lut_cuda.launches_lut4), before)]
    assert all(m > 0 for m in moved), moved


def _operand_bytes(model) -> int:
    ops = model.operands().ops
    return sum(t.numel() * t.element_size() for t in ops.ops
               if isinstance(t, torch.Tensor))


def test_fleet_eviction_frees_card_memory(dev, fleet_models):
    """Evicting a model and collecting its last reference gives its
    operands' bytes back: with the bytes the incoming model adds measured
    apart (loading it alone), memory_allocated drops by at least the
    evicted model's operand bytes."""
    import gc

    from ddt_tpu_torch.serve.control import build_fleet, parse_models_arg

    X = fleet_models["X"]

    def allocated():
        torch.cuda.synchronize()
        gc.collect()
        return torch.cuda.memory_allocated(dev)

    m0 = allocated()
    alone = build_fleet(parse_models_arg("i4@1"),
                        registry=fleet_models["root"])
    alone.predict(X[:8], model="i4", timeout=60.0)
    added = allocated() - m0
    alone.close()
    del alone
    eng = _card_fleet(fleet_models, max_resident=2)
    try:
        eng.predict(X[:8], model="f32", timeout=60.0)
        eng.predict(X[:8], model="i8", timeout=60.0)
        held = _operand_bytes(eng._slots["i8"].model)
        assert held > 0
        before = allocated()
        eng.predict(X[:8], model="f32", timeout=60.0)   # i8 coldest
        eng.predict(X[:8], model="i4", timeout=60.0)    # evicts i8
        assert eng.health()["models"]["i8"]["resident"] is False
        after = allocated()
        assert before + added - after >= held, (before, added, after, held)
    finally:
        eng.close()


def test_shadow_on_its_own_stream_leaves_champion_bitwise(dev,
                                                          fleet_models):
    """A shadow challenger scoring the champion's batches on its own CUDA
    stream: the champion's responses are bitwise its offline answers and
    those of a shadow-less fleet; the challenger scored rows."""
    import time

    from ddt_tpu_torch.serve.control import FleetSpec, build_fleet

    X, want = fleet_models["X"], fleet_models["want"]
    eng = build_fleet(
        [FleetSpec(name="champ", ref="f32@1"),
         FleetSpec(name="chall", ref="i4@1", tier="int4",
                   shadow_of="champ")],
        registry=fleet_models["root"], max_wait_ms=1.0)
    try:
        for s in range(0, 1920, 64):
            out = eng.predict(X[s:s + 64], model="champ", timeout=60.0)
            assert np.array_equal(out, want["f32"][s:s + 64]), s
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            sh = eng.health()["models"]["champ"]["shadow"]
            if sh["rows"] + 64 * sh["dropped"] >= 1920:
                break
            time.sleep(0.01)
        assert sh["rows"] > 0 and sh["errors"] == 0, sh
        assert eng._slots["champ"].shadow._stream is not None
    finally:
        eng.close()


def test_cli_serve_device_defaults_to_the_card(dev, fleet_models, tmp_path):
    """`python -m ddt_tpu_torch.cli serve` with no --device serves on the
    card: the child says so, and its answers are bitwise api.predict."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "serve", "--registry",
         fleet_models["root"], "--model", "i8@1", "--quantized", "int8",
         "--port", str(port)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["device"] == "cuda"
        X = fleet_models["X"]
        deadline = time.monotonic() + 120
        while True:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict",
                    data=json.dumps({"rows": X[:16].tolist()}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=30) as r:
                    got = np.float32(json.loads(r.read())["scores"])
                break
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
        assert np.array_equal(got, fleet_models["want"]["i8"][:16])
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/shutdown", data=b"{}",
            method="POST"), timeout=30).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)


def test_fused_run_with_a_run_log_is_still_graph_replays(dev, tmp_path):
    """A run log keeps the fused loop: the rounds are replays of one
    captured round, the trees those of a run without telemetry bitwise,
    and the log's hist cost events count the warm-up round's launches and
    one set a replay (not one set for the capture)."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import cuda as cuda_be
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.telemetry.events import RunLog

    rng = np.random.default_rng(3)
    Xb = rng.integers(0, 63, size=(20_000, 12), dtype=np.uint8)
    y = (Xb[:, 0] > 31).astype(np.float32)
    cfg = TrainConfig(n_trees=9, max_depth=4, n_bins=63)
    plain = api.train(Xb, y, cfg, binned=True)
    r0, c0 = cuda_be.graph_replays, cuda_be.graph_captures
    launches0 = hist_cuda.launches_exact
    rl = RunLog(str(tmp_path / "run.jsonl"))
    res = api.train(Xb, y, cfg, binned=True, run_log=rl)
    rl.close()
    # A fit at the same addresses replays the graph the untelemetered
    # fit captured as it is; a new one captures once, after one warm-up
    # round. The run log counts every replay either way.
    assert cuda_be.graph_replays - r0 == 9
    warm = cuda_be.graph_captures - c0
    assert warm in (0, 1)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value",
              "split_gain", "default_left"):
        np.testing.assert_array_equal(getattr(res.ensemble, k),
                                      getattr(plain.ensemble, k))
    hist = [e for e in rl.events("cost_analysis") if e["op"] == "hist"]
    assert sum(e["calls"] for e in hist) == 4 * (9 + warm) \
        == hist_cuda.launches_exact - launches0
    assert all(e["platform"] == torch.cuda.get_device_name(dev)
               for e in hist)
    c = rl.events("counters")[-1]
    assert c["jit_compiles"] == warm and c["device_peak_bytes"] > 0
    phases = {p["phase"] for p in rl.events("phase_timings")[-1]["phases"]}
    assert phases == {"grow_block", "fetch_tree"}


def test_costed_counts_replays_not_the_capture(dev):
    """A costed dispatcher met once at capture counts once a replay."""
    from ddt_tpu_torch.telemetry import costmodel
    from ddt_tpu_torch.utils import launches

    X = torch.randint(0, 16, (4096, 8), dtype=torch.uint8, device=dev)
    g = torch.randn(4096, device=dev)
    h = torch.rand(4096, device=dev)
    ni = torch.zeros(4096, dtype=torch.int32, device=dev)
    col = costmodel.activate()
    try:
        histogram.build_histograms(X, g, h, ni, 1, 16)        # warm-up
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as rec, torch.cuda.graph(graph):
            histogram.build_histograms(X, g, h, ni, 1, 16)
        (calls,) = [r["calls"] for r in col.records.values()]
        assert calls == 1                  # the capture ran nothing
        for _ in range(5):
            graph.replay()
            rec.replayed()
        (calls,) = [r["calls"] for r in col.records.values()]
        assert calls == 6
    finally:
        costmodel.deactivate(col)


def test_replay_counts_into_the_collector_active_at_replay(dev):
    """A round captured with no collector active, replayed under one,
    counts its costed calls once a replay in that collector."""
    from ddt_tpu_torch.telemetry import costmodel
    from ddt_tpu_torch.utils import launches

    X = torch.randint(0, 16, (4096, 8), dtype=torch.uint8, device=dev)
    g = torch.randn(4096, device=dev)
    h = torch.rand(4096, device=dev)
    ni = torch.zeros(4096, dtype=torch.int32, device=dev)
    assert costmodel._active is None
    histogram.build_histograms(X, g, h, ni, 1, 16)            # warm-up
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with launches.recording() as rec, torch.cuda.graph(graph):
        histogram.build_histograms(X, g, h, ni, 1, 16)
    col = costmodel.activate()
    try:
        for _ in range(4):
            graph.replay()
            rec.replayed()
        (ev,) = col.events()
    finally:
        costmodel.deactivate(col)
    assert ev["op"] == "hist" and ev["calls"] == 4
    assert ev["platform"] == torch.cuda.get_device_name(dev)


def test_phase_timer_on_the_card_reads_events_once(dev, monkeypatch):
    """Phases on the card are CUDA-event pairs read at the end: no
    synchronize while phases open and close."""
    from ddt_tpu_torch.utils.profiling import PhaseTimer

    t = PhaseTimer(dev)
    x = torch.randn(1 << 20, device=dev)
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a) or real(*a))
    for _ in range(10):
        with t.phase("outer"):
            with t.phase("inner"):
                x = x * 1.0001
    assert calls == []
    got = {r["phase"]: r for r in t.as_json()}
    assert got["inner"]["calls"] == 10 and got["outer"]["calls"] == 10
    assert got["inner"]["ms_total"] > 0


# ---------------------------------------------------------------------- #
# robustness on the card: the histogram OOM ladder, the allocation
# failure's classification, injected faults absorbed bitwise
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_hist_oom_ladder_rungs_bitwise_on_card(dev, mode):
    """The node slabs a level step builds at each rung (ops/histogram.
    build_table over [lo, lo + slab_nodes(rung, 16)), K1 given its first
    node and writing a table of its slab only, one launch each) are
    bitwise the matching slices of the whole level's table on the card:
    exact int64 and int32 sums are order-free."""
    Xb, g, h, ni = _hist_case(200_000, 28, 255, 16, seed=11)
    X = torch.from_numpy(Xb).to(dev)
    n = torch.from_numpy(ni).to(dev)
    if mode == "exact":
        gt = torch.from_numpy(g).to(dev)
        ht = torch.from_numpy(h).to(dev)
        scales = grad.fixed_scales(grad.abs_max2(gt, ht), Xb.shape[0])
    else:
        gt = torch.from_numpy((g * 40).clip(-127, 127).astype(np.int8)
                              ).to(dev)
        ht = torch.from_numpy((h * 127).astype(np.int8)).to(dev)
        scales = None
    ladder = histogram.HistLadder(carry=True)
    top = histogram.build_table(X, gt, ht, n, 16, 255, scales)
    for rung in ladder.rungs[1:]:
        per = histogram.slab_nodes(rung, 16)
        before = (hist_cuda.launches_exact + hist_cuda.launches_int)
        parts = [histogram.build_table(X, gt, ht, n, per, 255, scales,
                                       node_lo=lo)
                 for lo in range(0, 16, per)]
        launched = (hist_cuda.launches_exact + hist_cuda.launches_int
                    - before)
        assert launched == 16 // per, rung
        assert all(p.shape[0] == per for p in parts), rung
        assert torch.equal(torch.cat(parts), top), rung
    for lo, hi in ((0, 4), (3, 9), (15, 16)):
        part = hist_cuda.build_histograms_cuda(X, gt, ht, n, hi - lo, 255,
                                               scales=scales, node_lo=lo)
        assert torch.equal(part, top[lo:hi]), (lo, hi)


def _level_peaks(dev, R, F, grad_dtype, depth=6, seed=0):
    """Peak card memory of the last histogram level (2^(depth-1) nodes)
    of one depth-`depth` tree at each rung: chip_smoke.level_peaks."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.integers(0, 255, size=(R, F),
                                      dtype=np.uint8)).to(dev)
    g = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random(R, dtype=np.float32) + 0.1).to(dev)
    return chip_smoke.level_peaks(X, g, h, depth, grad_dtype)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_hist_ladder_peak_falls_per_rung_on_card(dev, grad_dtype):
    """At 65,536 rows x 1024 features and 32 nodes every rung's level
    peak (build, subtraction and split search, the carried parent table
    counted) is strictly below the rung above it."""
    peaks = _level_peaks(dev, 65_536, 1024, grad_dtype)
    rungs = sorted(peaks)
    assert rungs == [0, 1, 2, 3]
    for a, b in zip(rungs, rungs[1:]):
        assert peaks[b]["peak"] < peaks[a]["peak"], peaks


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_capped_fit_survives_a_real_out_of_memory(dev, grad_dtype):
    """With set_per_process_memory_fraction between rung 0's level peak
    and rung 1's, a granular fit takes a real torch.cuda.OutOfMemoryError
    at rung 0, steps its backend down and ends with the undisturbed fit's
    trees bit for bit (chip_smoke.real_oom_fit)."""
    import chip_smoke

    got = chip_smoke.real_oom_fit(grad_dtype, n_trees=2)
    assert got["bitwise"] and got["rung"] > 0 and got["degrades"] >= 1, got
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
@pytest.mark.parametrize("when", ["warmup", "capture"])
def test_hist_fault_in_the_fused_loop_bitwise_on_card(dev, grad_dtype,
                                                      when):
    """A planned hist.build fault in the fused loop's warm-up round or
    inside its graph capture: the level step runs again one rung lower
    (inside the capture the ladder steps and re-raises, and the round is
    captured again at the new rung, so the graph holds no launch of the
    abandoned attempt: K1's launches equal a fit held at that rung from
    the start), the backend keeps the rung, and every replay grows the
    granular loop's trees bit for bit."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import CUDADevice
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.parallel import tasks
    from ddt_tpu_torch.robustness import faultplan

    rng = np.random.default_rng(5)
    Xb = rng.integers(0, 63, size=(30_000, 10), dtype=np.uint8)
    y = (Xb[:, 0] + rng.integers(0, 20, 30_000) > 40).astype(np.float32)
    depth = 5
    cfg = TrainConfig(n_trees=6, max_depth=depth, n_bins=63, seed=3,
                      grad_dtype=grad_dtype)
    ref = api.train(Xb, y, cfg, binned=True,
                    backend=tasks.Granular(cfg)).ensemble
    # The warm-up round builds levels 1..depth, the capture the next.
    after = 2 if when == "warmup" else depth + 2

    def k1():
        return hist_cuda.launches_exact + hist_cuda.launches_int

    be = CUDADevice(cfg)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "hist.build", "after_calls": after}]}))
    k0 = k1()
    try:
        got = api.train(Xb, y, cfg, binned=True, backend=be).ensemble
    finally:
        faultplan.deactivate(prev)
    faulted = k1() - k0
    assert be.hist_ladder.rung == be.hist_ladder.rungs[1]
    held = CUDADevice(cfg)
    held.hist_ladder.rung = held.hist_ladder.rungs[1]
    k0 = k1()
    api.train(Xb, y, cfg, binned=True, backend=held)
    assert faulted == k1() - k0
    for k in ("feature", "threshold_bin", "leaf_value", "split_gain"):
        np.testing.assert_array_equal(getattr(ref, k), getattr(got, k))


def test_real_out_of_memory_is_resource_exhausted(dev):
    """The caching allocator's own failure (torch.cuda.OutOfMemoryError)
    is what the ladder steps down on, and it is not transient."""
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.utils import retry

    free, total = torch.cuda.mem_get_info(dev)
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        torch.empty(int(total) * 4, dtype=torch.uint8, device=dev)
    assert faultplan.is_resource_exhausted(info.value)
    assert not retry.is_transient(info.value)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_injected_faults_bitwise_on_card(dev, tmp_path, grad_dtype):
    """fetch_tree, ckpt.save.write and a hist.build rung step, each
    injected into a granular fit on the card: the ensemble is the
    undisturbed run's bit for bit; the streamed fit under
    stream.chunk_read likewise."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import CUDADevice
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.streaming import fit_streaming

    rng = np.random.default_rng(3)
    Xb = rng.integers(0, 63, size=(20_000, 12), dtype=np.uint8)
    y = (Xb[:, 0] + rng.integers(0, 20, 20_000) > 40).astype(np.float32)
    cfg = TrainConfig(n_trees=6, max_depth=5, n_bins=63, seed=1,
                      grad_dtype=grad_dtype)
    ref = api.train(Xb, y, cfg, binned=True, profile=True).ensemble
    plan = {"faults": [{"site": "fetch_tree", "times": 2},
                       {"site": "ckpt.save.write", "round": 2},
                       {"site": "hist.build", "after_calls": 7}]}
    be = CUDADevice(cfg)
    prev = faultplan.activate(faultplan.load_plan(plan))
    try:
        got = api.train(Xb, y, cfg, binned=True, profile=True,
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2, backend=be).ensemble
        assert be.hist_ladder.rung == 1
    finally:
        faultplan.deactivate(prev)
    for k in ("feature", "threshold_bin", "leaf_value", "split_gain"):
        np.testing.assert_array_equal(getattr(ref, k), getattr(got, k))

    def chunks(c):
        return Xb[c * 5000:(c + 1) * 5000], y[c * 5000:(c + 1) * 5000]

    clean = fit_streaming(chunks, 4, cfg, device_chunk_cache=False)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "stream.chunk_read", "chunk": 2,
                     "times": 2}]}))
    try:
        chaos = fit_streaming(chunks, 4, cfg, device_chunk_cache=False)
    finally:
        faultplan.deactivate(prev)
    for k in ("feature", "threshold_bin", "leaf_value", "split_gain"):
        np.testing.assert_array_equal(getattr(clean, k), getattr(chaos, k))


# ------------------------------------------------------------------ #
# the bench library (ddt_tpu_torch/bench.py) on the card
# ------------------------------------------------------------------ #

def _card_stamp_ok(rec):
    from ddt_tpu_torch.utils import card

    assert rec["device"]["name"] == torch.cuda.get_device_name(0)
    assert rec["device"] == card.parse_line(card.smi_line(0))


def test_bench_histogram_on_card(dev):
    from ddt_tpu_torch import bench

    rec = bench.run_bench("histogram", rows=200_000, features=28, bins=255,
                          iters=4, reps=2)
    _card_stamp_ok(rec)
    assert rec["impl"] == "k1-exact"
    # One K1 launch a build, no capture, in the timed window.
    assert rec["launches"] == {"hist": 4 * 2}
    assert rec["graph_captures"] == 0
    for k in ("hist_roofline_flops_util", "hist_roofline_hbm_util"):
        assert 0 < rec[k] <= 1.05
    assert rec["mrows_per_sec_per_chip"] > 0


def test_bench_train_on_card(dev):
    from ddt_tpu_torch import bench

    rec = bench.run_bench("train", rows=100_000, features=28, bins=255,
                          trees=10, depth=6)
    _card_stamp_ok(rec)
    # The timed fit's new labels recapture its round once; K1 launches
    # depth times in the round before the capture and in each replay.
    assert rec["graph_captures"] == 1
    assert rec["launches"] == {"hist": 6 * (10 + 1)}
    assert 0 < rec["final_train_loss"] < 0.6931


def test_profiled_counts_no_span_as_device_work(dev, monkeypatch):
    """breakdown.profiled over api.predict, whose `ddt:` spans are live
    under its profiler: the ranges the profiler draws on the device's
    timeline are no device work, so the launches equal a profile with
    every span site silent, no row is a span, and the busy share stays
    at most 1."""
    from ddt_tpu_torch import api, breakdown
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.telemetry import annotations

    rng = np.random.default_rng(4)
    X = rng.normal(size=(200_000, 28)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    res = api.train(X, y, TrainConfig(n_trees=20, max_depth=6))

    def score():
        return api.predict(res.ensemble, X, mapper=res.mapper, raw=True)

    score()
    annotations.reset_spans()
    live = breakdown.profiled(score)
    assert annotations.span_totals()["ddt:score"]["count"] == 1
    monkeypatch.setattr(
        annotations, "_scope",
        lambda name, timer: (annotations._NULL if timer is None
                             else timer.phase(name)))
    annotations.reset_spans()
    silent = breakdown.profiled(score)
    assert annotations.span_totals() == {}
    assert live["device_launches"] == silent["device_launches"] > 0
    assert not any(r["name"].startswith(annotations.PREFIX)
                   for r in live["top"])
    assert 0 < live["busy_share"] <= 1.0


# K1's warp compaction (csrc/hist.cu, design point 1) at deep-level shapes,
# where a level runs more than one node range: every mode against its plain
# version, the exact and integer tables bitwise. Each case's node indices
# hold frozen rows, rows of nodes outside the launch and nodes with no row
# (a whole range of them where a range holds up to 4 nodes); 10% of the
# rows are bagged out (g = h = 0) and some exact-mode rows round to 0.
# (name, R, F, N, node_lo, slab): R a multiple of neither 32 nor a block's
# chunk; `slab` reads Xb as 28 columns from column 17 of a 64-column
# matrix (row stride 64, no row 4-byte aligned).
COMPACT_CASES = [
    ("N8", 300_007, 28, 8, 0, False),
    ("N16", 300_007, 28, 16, 0, False),
    ("N32", 300_007, 28, 32, 0, False),
    ("F39_N16", 200_003, 39, 16, 0, False),
    ("F54_N16", 200_003, 54, 16, 0, False),
    ("node_lo", 300_007, 28, 16, 5, False),
    ("slab_node_lo", 200_003, 28, 16, 3, True),
]


def _compact_case(R, F, N, node_lo, slab, mode, seed=21):
    rng = np.random.default_rng(seed)
    B = 255
    Xb = rng.integers(0, B, size=(R, 64 if slab else F), dtype=np.uint8)
    ni = rng.integers(node_lo - 2, node_lo + N + 2, size=R)
    ni[(ni >= node_lo + 4) & (ni < node_lo + 8)] = node_lo   # empty nodes
    ni[rng.random(R) < 0.5] = -1             # right children and frozen
    ni = np.maximum(ni, -1).astype(np.int32)
    if mode in ("exact", "f32"):
        g = rng.standard_normal(R).astype(np.float32)
        h = rng.random(R).astype(np.float32)
        tiny = rng.random(R) < 0.05            # both round to 0 in exact
        g[tiny] *= 1e-12
        h[tiny] *= 1e-12
    else:
        g, h, _ = _int_hist_case(R, 1, B, 1, mode, seed=seed)[1:]
    bag = rng.random(R) < 0.1
    g[bag] = 0
    h[bag] = 0
    return Xb, g, h, ni


@pytest.mark.parametrize("mode", ["exact", "int8", "int16", "f32"])
@pytest.mark.parametrize("name,R,F,N,node_lo,slab", COMPACT_CASES,
                         ids=[c[0] for c in COMPACT_CASES])
def test_hist_compacted_deep_levels_equal_plain(dev, mode, name, R, F, N,
                                                node_lo, slab):
    Xb, g, h, ni = _compact_case(R, F, N, node_lo, slab, mode)
    Xd, gd, hd, nd = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    if slab:
        Xd = Xd[:, 17:17 + F]
        assert Xd.stride(0) == 64 > F
    B = 255
    kw = dict(node_lo=node_lo)
    if mode == "exact":
        sc = grad.fixed_scales(grad.abs_max2(gd, hd), R)
        got = hist_cuda.build_histograms_cuda(Xd, gd, hd, nd, N, B,
                                              scales=sc, **kw)
        want = histogram.build_histograms_fixed_segment(Xd, gd, hd, nd, N,
                                                        B, sc, **kw)
    else:
        got = hist_cuda.build_histograms_cuda(Xd, gd, hd, nd, N, B, **kw)
        want = histogram.build_histograms_segment(Xd, gd, hd, nd, N, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (N, F, B, 2)
    assert got.dtype == want.dtype
    assert bool((want[4:8] == 0).all()) and bool(want.any())
    if mode == "f32":
        tol = 1e-5 * histogram.build_histograms_segment(
            Xd, gd.abs(), hd.abs(), nd, N, B, **kw) + 1e-6
        assert bool(((got - want).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


def _lane_passes(ni_in: np.ndarray, blocks_x: int) -> int:
    """Warp add_row passes of one grid row (a node range of one feature
    slab) whose rows in the range are `ni_in`, by the kernel's walk: block
    b takes rows [b * rpb, (b + 1) * rpb), warp w its 32-row strips w,
    w + 32, ...; a strip with 28 or more rows in the range (csrc/hist.cu's
    kRunAt) is one pass, and each warp's other in-range rows run 32 at a
    time, the last < 32 in one more."""
    R = ni_in.size
    rpb = -(-R // blocks_x)
    r = np.arange(R)
    blk, off = r // rpb, r % rpb
    strip = blk * (-(-rpb // 32)) + off // 32            # strip id, global
    warp = blk * 32 + (off // 32) % 32
    n_strips = int(strip.max()) + 1
    in_strip = np.bincount(strip, weights=ni_in, minlength=n_strips)
    full = in_strip >= 28
    strip_warp = np.zeros(n_strips, np.int64)
    strip_warp[strip] = warp
    n_warps = int(warp.max()) + 1
    n_full = np.bincount(strip_warp, weights=full, minlength=n_warps)
    part = np.bincount(strip_warp, weights=np.where(full, 0, in_strip),
                       minlength=n_warps)
    return int(n_full.sum() + np.ceil(part / 32).sum())


@pytest.mark.parametrize("level", ["N16", "root"])
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_lane_stats_count_rows_and_passes(dev, mode, level):
    """The lane counters at Higgs' train shape: rows added are the rows of
    the launch's nodes whose g or h is (rounds to) non-zero, and the
    passes are the kernel's walk's. Random left-child indices at 16 nodes
    keep the lanes >= 95% busy; a root level only loses each warp's last
    partial pass."""
    R, F, B = 10_500_001, 28, 255
    N = 16 if level == "N16" else 1
    rng = np.random.default_rng(8)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    if level == "N16":
        ni = rng.integers(0, N, size=R).astype(np.int32)
        ni[rng.random(R) < 0.5] = -1
    else:
        ni = np.zeros(R, np.int32)
    if mode == "exact":
        g = rng.standard_normal(R).astype(np.float32)
        h = rng.random(R).astype(np.float32)
    else:
        _, g, h, _ = _int_hist_case(R, 1, B, 1, "int8", seed=8)
    Xd, gd, hd, nd = [torch.from_numpy(a).to(dev) for a in (Xb, g, h, ni)]
    kw = {}
    if mode == "exact":
        kw["scales"] = grad.fixed_scales(grad.abs_max2(gd, hd), R)
        qg = grad.to_fixed(gd, kw["scales"][0]).cpu().numpy()
        qh = grad.to_fixed(hd, kw["scales"][1]).cpu().numpy()
        nonzero = (qg != 0) | (qh != 0)
    else:
        nonzero = (g != 0) | (h != 0)
    hist_cuda.build_histograms_cuda(Xd, gd, hd, nd, N, B, **kw)
    hist_cuda.reset_lane_stats(dev)
    hist_cuda.build_histograms_cuda(Xd, gd, hd, nd, N, B, **kw)
    st = hist_cuda.lane_stats(dev)
    cells = (hist_cuda.CELL_BYTES_EXACT if mode == "exact"
             else hist_cuda.CELL_BYTES)
    plan = hist_cuda.plan_tiles(N, F, B, _build.smem_limit(dev), cells)
    active = hist_cuda.max_active_blocks(dev, 3 if mode == "exact" else 1,
                                         plan.smem_bytes)
    blocks_x = hist_cuda.grid_blocks(R, plan.tiles, active)
    passes = sum(_lane_passes((ni >= lo) & (ni < lo + plan.nr), blocks_x)
                 for lo in range(0, N, plan.nr))
    assert st["rows"] == int(((ni >= 0) & nonzero).sum())
    assert st["passes"] == passes
    assert st["occupancy"] == st["rows"] / (32 * passes)
    assert st["occupancy"] >= (0.95 if level == "N16" else 0.99)
