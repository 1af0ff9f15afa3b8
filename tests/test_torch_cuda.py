"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card every test here skips (the
fixture decides, never module import). On the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; this file imports nothing of JAX or ddt_tpu.)

Tolerances: the histogram kernel sums f32 g/h with float atomics in a
run-to-run order, so each (g, h) cell is held to 1e-5 * (sum of |g| or
|h| over the cell's own rows) + 1e-6; its integer mode (int8/int16 g/h,
int32 sums) is exact and held bitwise. The traversal kernel and the LUT
kernels (K4, K5) are bitwise on exact-grid leaf values (every partial sum
is exact in f32, so the order cannot matter) and within 1e-5 * (|p| + 1)
on random leaves; the LUT kernels also stay within the tables'
max_abs_err of the f32 host oracle.
"""

import numpy as np
import pytest
import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import (hist_cuda, histogram, predict, predict_cuda,
                               predict_lut, predict_lut_cuda)

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
    for name in ("hist", "traverse", "lut"):
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


def test_lut_kernel_refuses_rows_that_do_not_fit_shared_memory(dev):
    F = 1000                    # 256 KB of staged rows per block
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
