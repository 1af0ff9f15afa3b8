"""Binning on the device (ddt_tpu_torch/ops/quantize.py) against the
reference, on the CPU.

ops/quantize.transform_binned equals ddt_tpu.ops.quantize.transform_binned
on JAX-CPU and BinMapper.transform bit for bit: binning is exact, so no
tolerance. The cases mirror tests/test_quantizer.py
::test_device_transform_bit_identical: NaN, +/-inf, -0.0, exact edge
hits, duplicate-edge runs, identity (categorical) columns, the reserved
NaN bin on and off, and one and three row blocks. Then the device
feature_bincounts against the numpy form, and api.train / api.predict on
float rows (binned on the device) against the same calls on host-binned
rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.data.quantizer import fit_bin_mapper as j_fit_bin_mapper
from ddt_tpu.ops.quantize import transform_binned as j_transform_binned
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import (BinMapper, feature_bincounts,
                                          fit_bin_mapper)
from ddt_tpu_torch.ops import quantize


def _rows(R=1500, F=6, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((R, F)).astype(np.float32)
    X[:, 2] = np.round(np.abs(X[:, 2]) * 3)         # few distinct values
    X[:, 4] = rng.integers(0, 20, R)                # identity column
    for v, p in ((np.nan, 0.05), (np.inf, 0.01), (-np.inf, 0.01),
                 (-0.0, 0.02), (0.0, 0.02)):
        X[rng.random(X.shape) < p] = v
    return X


def _mapper(X, n_bins, policy):
    m = fit_bin_mapper(X, n_bins=n_bins, missing_policy=policy,
                       cat_features=(4,))
    X[5, 1] = m.edges[1, m.n_value_bins // 2 - 1]   # exact edge hits
    X[6, 0] = m.edges[0, 0]
    return m


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("n_bins", [255, 31, 3])
@pytest.mark.parametrize("policy", ["zero", "learn"])
def test_transform_binned_equals_reference_and_host(policy, n_bins,
                                                    n_blocks):
    X = _rows()
    # The port's mapper is the reference's (tests/test_torch_quantizer.py).
    want_edges = j_fit_bin_mapper(X, n_bins=n_bins, missing_policy=policy,
                                  cat_features=(4,)).edges
    m = _mapper(X, n_bins, policy)
    np.testing.assert_array_equal(m.edges, want_edges)
    block = -(-X.shape[0] // n_blocks)
    got = quantize.transform_binned(torch.from_numpy(X),
                                    torch.from_numpy(m.edges), n_bins,
                                    m.missing_bin, row_block=block)
    assert got.dtype == torch.uint8 and got.shape == X.shape
    want_ref = np.asarray(j_transform_binned(
        jnp.asarray(X), jnp.asarray(m.edges), n_bins=n_bins,
        missing_bin=m.missing_bin, row_block=block))
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), m.transform(X))
    if policy == "learn":
        assert (got.numpy()[np.isnan(X)] == n_bins - 1).all()
    else:
        assert (got.numpy()[np.isnan(X)] == 0).all()


def test_one_value_bin_has_no_edges():
    """n_bins 2 with the reserved NaN bin leaves one value bin and no
    edge column to search: every value is bin 0, NaN bin 1."""
    X = _rows(200)
    m = fit_bin_mapper(X, n_bins=3, missing_policy="learn")
    m1 = BinMapper(edges=m.edges[:, :1], n_bins=2, missing_bin=True)
    got = quantize.transform_binned(torch.from_numpy(X),
                                    torch.from_numpy(m1.edges), 2, True)
    np.testing.assert_array_equal(got.numpy(), m1.transform(X))
    np.testing.assert_array_equal(got.numpy(), np.isnan(X))


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32])
def test_transform_device_casts_as_transform_does(dtype):
    """Host rows of any dtype are cast to f32 exactly as transform casts
    them (an int64 above 2^24 rounds once), then binned on the device."""
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((400, 4)) * 3e7).astype(dtype)
    m = fit_bin_mapper(np.asarray(X, np.float32), n_bins=63)
    got = m.transform_device(X, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), m.transform(X))
    with pytest.raises(ValueError, match="rows"):
        m.transform_device(X[:, :3], device="cpu")


def test_transform_counts_only_card_calls():
    X = _rows(100, 6)
    m = _mapper(X, 31, "zero")
    before = quantize.transforms
    m.transform_device(X, device="cpu")
    assert quantize.transforms == before


@pytest.mark.parametrize("n_bins", [255, 16])
def test_device_feature_bincounts_equal_numpy(n_bins):
    rng = np.random.default_rng(4)
    Xb = rng.integers(0, n_bins, size=(5000, 7), dtype=np.uint8)
    Xb[:, 3] = 0                                   # a constant column
    got = feature_bincounts(torch.from_numpy(Xb), n_bins)
    assert got.dtype == torch.int64 and got.shape == (7, n_bins)
    np.testing.assert_array_equal(got.numpy(),
                                  feature_bincounts(Xb, n_bins))
    with pytest.raises(TypeError):
        feature_bincounts(torch.zeros((3, 2), dtype=torch.int32), n_bins)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_api_on_float_rows_equals_host_binned_rows(grad_dtype):
    """api.train / api.predict on float rows bin on the device; the same
    calls on host-binned rows give the same ensemble, scores and
    reference bin counts."""
    X, y = synthetic_binary(3000, seed=1)
    X[::97, 3] = np.nan
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=63, device="cpu",
                      grad_dtype=grad_dtype)
    res = api.train(X, y, cfg)
    Xb = res.mapper.transform(X)
    np.testing.assert_array_equal(res.mapper.ref_counts,
                                  feature_bincounts(Xb, 63))
    host = api.train(Xb, y, cfg, binned=True)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value",
              "split_gain", "default_left"):
        np.testing.assert_array_equal(getattr(res.ensemble, k),
                                      getattr(host.ensemble, k))
    got = api.predict(res.ensemble, X, mapper=res.mapper, device="cpu")
    np.testing.assert_array_equal(
        got, api.predict(host.ensemble, Xb, binned=True, device="cpu"))
    # A binned tensor is scored where it lies.
    np.testing.assert_array_equal(
        got, api.predict(host.ensemble, torch.from_numpy(Xb), binned=True,
                         device="cpu"))
