"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: on a machine without a card every test here skips (the
fixture decides, never module import). On the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; this file imports nothing of JAX or ddt_tpu.)

Tolerances: the histogram kernel sums with float atomics in a run-to-run
order, so each (g, h) cell is held to 1e-5 * (sum of |g| or |h| over the
cell's own rows) + 1e-6. The traversal kernel and the LUT kernels (K4,
K5) are bitwise on exact-grid leaf values (every partial sum is exact in
f32, so the order cannot matter) and within 1e-5 * (|p| + 1) on random
leaves; the LUT kernels also stay within the tables' max_abs_err of the
f32 host oracle.
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
