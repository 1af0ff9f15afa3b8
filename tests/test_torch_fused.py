"""The fused boosting loop (CUDADevice.grow_rounds / grow_rounds_masked,
Driver._fit_fused) against the granular loop and the reference, on the
CPU.

On "cpu" the round function that the card captures as a CUDA graph runs
eagerly, so its trees must equal the granular loop's bit for bit in f32,
int8 and int16, with bagging, colsample and both: the same operations in
the same order, with the round read from a tensor. Block boundaries must
not change a tree (mirroring tests/test_backends.py
::test_fused_block_cap_multi_block_identity and tests/test_sampling.py
::test_bagging_rides_fused_path / ::test_colsample_rides_fused_path).
Against the reference's own fused path (ddt_tpu.api.train with
backend="tpu" on JAX-CPU): trees equal except at provable bf16-boundary
ties (tests/tree_compare), predictions within 1e-5.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.ops.grad import base_score_np
from tree_compare import assert_trees_match_mod_ties

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")
SAMPLING = {"none": {}, "bagging": dict(subsample=0.7),
            "colsample": dict(colsample_bytree=0.5),
            "both": dict(subsample=0.8, colsample_bytree=0.6)}


@pytest.fixture(scope="module")
def data():
    X, y = synthetic_binary(3000, n_features=10, seed=3)
    Xb, _ = quantize(X, n_bins=31, seed=3)
    return X, Xb, y


def _granular(cfg, Xb, y):
    be = get_backend(cfg)
    bs = base_score_np(y, cfg.loss)
    yd = be.upload_labels(y)
    ens = empty_ensemble(cfg.n_trees, cfg.max_depth, Xb.shape[1],
                         cfg.learning_rate, bs, cfg.loss, n_bins=cfg.n_bins)
    return Driver(be, cfg)._fit_granular(be.upload(Xb), yd,
                                         be.init_pred(yd, bs), ens)


def _assert_same(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


@pytest.mark.parametrize("sampling_kw", list(SAMPLING), ids=list(SAMPLING))
@pytest.mark.parametrize("grad_dtype", ["f32", "int8", "int16"])
def test_fused_equals_granular_bitwise(data, grad_dtype, sampling_kw):
    _, Xb, y = data
    cfg = TrainConfig(n_trees=6, max_depth=4, n_bins=31, device="cpu",
                      seed=11, grad_dtype=grad_dtype,
                      **SAMPLING[sampling_kw])
    be = get_backend(cfg)
    calls = {"rounds": 0, "masked": 0}
    orig = be.grow_rounds, be.grow_rounds_masked

    def spy(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    be.grow_rounds = spy("rounds", orig[0])
    be.grow_rounds_masked = spy("masked", orig[1])
    try:
        fused = Driver(be, cfg).fit(Xb, y)
    finally:
        del be.grow_rounds, be.grow_rounds_masked
    masked = cfg.colsample_bytree < 1.0
    assert calls == {"rounds": 0 if masked else 1,
                     "masked": 1 if masked else 0}
    _assert_same(fused, _granular(cfg, Xb, y))


@pytest.mark.parametrize("block_rounds", [1, 3, 4])
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_block_cap_does_not_change_a_tree(data, grad_dtype, block_rounds):
    _, Xb, y = data
    cfg = TrainConfig(n_trees=10, max_depth=3, n_bins=31, device="cpu",
                      seed=5, subsample=0.8, colsample_bytree=0.7,
                      grad_dtype=grad_dtype)
    one = Driver(get_backend(cfg), cfg).fit(Xb, y)
    cfg_k = cfg.replace(fused_block_rounds=block_rounds)
    be = get_backend(cfg_k)
    assert be is get_backend(cfg)          # the cap does not key a backend
    _assert_same(Driver(be, cfg_k).fit(Xb, y), one)


def test_grow_rounds_contract(data):
    """grow_rounds leaves its pred alone and returns the packed trees, the
    new pred and the loss after each round, as the granular steps give
    them."""
    _, Xb, y = data
    cfg = TrainConfig(max_depth=3, n_bins=31, device="cpu")
    be = get_backend(cfg)
    data_d, yd = be.upload(Xb), be.upload_labels(y)
    pred0 = be.init_pred(yd, base_score_np(y, cfg.loss))
    keep = pred0.clone()
    trees, pred, losses = be.grow_rounds(data_d, pred0, yd, 3,
                                         first_round=4)
    assert torch.equal(pred0, keep)
    assert trees.shape == (3, 6, 15) and losses.shape == (3,)
    p = pred0
    for k in range(3):
        g, h = be.grad_hess(p, yd)
        handle, delta = be.grow_tree(data_d, g, h, tree_id=4 + k)
        assert torch.equal(handle, trees[k])
        p = be.apply_delta(p, delta, 0)
        assert float(losses[k]) == be.loss_value(p, yd)
    assert torch.equal(p, pred)
    host_trees, host_losses = be.fetch_rounds(trees, losses)
    np.testing.assert_array_equal(host_trees, trees.numpy())
    np.testing.assert_array_equal(host_losses, losses.numpy())
    with pytest.raises(ValueError, match="fmasks"):
        be.grow_rounds_masked(data_d, pred0, yd, 3,
                              np.ones((2, Xb.shape[1]), bool))
    with pytest.raises(ValueError, match="n_rounds"):
        be.grow_rounds(data_d, pred0, yd, 0)


def test_driver_takes_the_granular_loop_without_grow_rounds(data):
    _, Xb, y = data

    class Granular(CUDADevice):
        grow_rounds = None

    cfg = TrainConfig(n_trees=3, max_depth=3, n_bins=31, device="cpu",
                      subsample=0.8, seed=2)
    ens = Driver(Granular(cfg), cfg).fit(Xb, y)
    _assert_same(ens, Driver(get_backend(cfg), cfg).fit(Xb, y))


@pytest.mark.parametrize("sampling_kw", ["none", "both"])
def test_fused_train_matches_the_reference_fused_path(data, sampling_kw):
    """The port's api.train (fused on every backend now) against the
    reference's fused path on JAX-CPU, to the parity contract."""
    X, _, y = data
    kw = dict(n_trees=8, max_depth=4, n_bins=31, min_split_gain=1e-3,
              seed=4, **SAMPLING[sampling_kw])
    ref = japi.train(X, y, JConfig(backend="tpu", **kw))
    port = api.train(X, y, TrainConfig(device="cpu", **kw))
    assert_trees_match_mod_ties(ref.ensemble, port.ensemble,
                                kw["min_split_gain"])
    np.testing.assert_allclose(
        api.predict(port.ensemble, X, mapper=port.mapper, raw=True,
                    device="cpu"),
        ref.ensemble.predict_raw(X), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7, 2**35 + 1])
@pytest.mark.parametrize("rnd", [0, 3, 2**31 + 9, 2**32 + 1])
@pytest.mark.parametrize("start", [0, 2**32 - 5])
def test_tensor_round_key_and_uniform_equal_host(seed, rnd, start):
    r = torch.tensor(rnd, dtype=torch.int64)
    assert int(sampling.round_key_t(seed, r)) == sampling.round_key(seed,
                                                                    rnd)
    got = sampling.uniform(seed, r, start, 64).numpy()
    want = sampling.uniform_np(seed, rnd, start, 64)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        sampling.row_keep(seed, r, start, 64, 0.6).numpy(),
        sampling.row_keep_np(seed, rnd, start, 64, 0.6))


def test_config_validates_the_block_cap():
    with pytest.raises(ValueError, match="fused_block_rounds"):
        TrainConfig(fused_block_rounds=0)
    assert TrainConfig().fused_block_rounds == 100
