"""The port's plain traversal against ddt_tpu's scorers on the CPU.

Held bitwise on exact-grid leaf values (multiples of 1/8, the method of
tests/test_predict_lut4.py): every partial sum is then exact in f32, so
the leaf CHOICE is all that is compared, against the reference's Pallas
traversal kernel in interpret mode and against its one-hot path, with
missing-value routing, categorical one-vs-rest nodes and 3 classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.models import tree as jtree
from ddt_tpu.ops import predict as jpred
from ddt_tpu.ops import predict_pallas as jpp
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models import tree as ttree
from ddt_tpu_torch.ops import predict as tpred
from ddt_tpu_torch.ops import predict_cuda


def _exact_ens(T=9, depth=3, F=4, B=31, C=1, missing=False, cat=(),
               seed=0):
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = jtree.empty_ensemble(
        T, depth, F, 0.125, 0.25, "softmax" if C > 1 else "logloss",
        n_classes=max(C, 2), missing_bin=missing, n_bins=B,
        cat_features=tuple(cat))
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 1, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.25
    ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    if missing:
        ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


def _X(R, F=4, B=31, seed=1):
    return np.random.default_rng(seed).integers(0, B, (R, F), dtype=np.uint8)


def _port_plain(ens_j, X, tree_chunk=64):
    ce = ttree.TreeEnsemble.from_dict(ens_j.to_dict()).compile(tree_chunk)
    ops = [torch.from_numpy(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    return tpred.predict_raw_effective(
        ef, et, bv, coh, torch.from_numpy(X), max_depth=ce.max_depth,
        learning_rate=ce.learning_rate, base=ce.base_score,
        tree_chunk=tree_chunk, eff_dl=dl,
        missing_bin_value=ce.missing_bin_value, eff_cat=cat).numpy()


def _ref_kwargs(ens):
    use_missing = ens.missing_bin and ens.default_left is not None
    kw = dict(max_depth=ens.max_depth, learning_rate=ens.learning_rate,
              base=ens.base_score,
              n_classes=ens.n_classes if ens.loss == "softmax" else 1,
              missing_bin_value=ens.n_bins - 1 if use_missing else -1)
    if use_missing:
        kw["default_left"] = jnp.asarray(ens.default_left)
    if ens.has_cat_splits:
        kw["cat_node"] = jnp.asarray(np.isin(ens.feature, ens.cat_features))
    return kw


@pytest.mark.parametrize("kw", [
    dict(), dict(C=3, missing=True, cat=(1,)), dict(T=70, depth=2),
])
def test_plain_matches_reference_pallas_bitwise(kw):
    ens = _exact_ens(**kw)
    X = _X(300)
    want = np.asarray(jpp.predict_raw_pallas(
        jnp.asarray(ens.feature), jnp.asarray(ens.threshold_bin),
        jnp.asarray(ens.is_leaf), jnp.asarray(ens.leaf_value),
        jnp.asarray(X), tree_chunk=32, interpret=True, **_ref_kwargs(ens)))
    np.testing.assert_array_equal(_port_plain(ens, X, tree_chunk=32), want)


@pytest.mark.parametrize("kw", [
    dict(C=3, missing=True, cat=(0, 2)), dict(missing=True),
    dict(cat=(3,)), dict(C=3, T=130, depth=4),
])
def test_plain_matches_reference_onehot_bitwise(kw):
    ens = _exact_ens(**kw)
    X = _X(1000, seed=2)
    X[::7, 1] = 30                       # reserved missing bin rows
    ce = ens.compile(tree_chunk=64)
    ops = [jnp.asarray(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    want = np.asarray(jpred.predict_raw_effective(
        ef, et, bv, coh, jnp.asarray(X), max_depth=ce.max_depth,
        learning_rate=ce.learning_rate, base=ce.base_score,
        n_classes=ce.n_classes_out, tree_chunk=64, eff_dl=dl,
        missing_bin_value=ce.missing_bin_value, eff_cat=cat,
        use_pallas=False))
    got = _port_plain(ens, X)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ens.predict_raw(X, binned=True))


def test_plain_random_leaves_close_to_host_oracle():
    ens = _exact_ens(T=40, depth=4, missing=True, cat=(2,))
    ens.leaf_value[:] = np.random.default_rng(3).standard_normal(
        ens.leaf_value.shape)
    X = _X(500, seed=4)
    np.testing.assert_allclose(_port_plain(ens, X),
                               ens.predict_raw(X, binned=True),
                               rtol=1e-5, atol=1e-5)


def test_empty_batch():
    ens = _exact_ens()
    out = _port_plain(ens, _X(0))
    assert out.shape == (0,)


def test_backend_predict_on_cpu_uses_plain_and_caches():
    ens = ttree.TreeEnsemble.from_dict(_exact_ens(T=20).to_dict())
    be = CUDADevice(TrainConfig(device="cpu"))
    X = _X(700, seed=5)
    before = predict_cuda.launches
    got = be.predict_raw(ens, X)
    assert predict_cuda.launches == before
    np.testing.assert_array_equal(got, ens.predict_raw(X, binned=True))
    assert len(be._predict_cache) == 1
    (_, ops), = be._predict_cache.values()
    assert isinstance(ops, tpred.PlainOperands)  # prepared once per model
    be.predict_raw(ens, X[:10])
    assert len(be._predict_cache) == 1           # cache hit, no rebuild
    assert next(iter(be._predict_cache.values()))[1] is ops
    ens.leaf_value[0, 0] += 1.0                  # in-place edit: new token
    be.predict_raw(ens, X[:10])
    assert len(be._predict_cache) == 2


def test_kernel_wrapper_refuses_cpu_tensors():
    ens = ttree.TreeEnsemble.from_dict(_exact_ens(missing=True,
                                                  cat=(1,)).to_dict())
    ce = ens.compile()
    ef, et, bv, coh, dl, cat = (torch.from_numpy(a) for a in ce.arrays())
    tables = predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                      eff_dl=dl, eff_cat=cat)
    # Flags: bit 0 = default_left, bit 1 = categorical on real splits only.
    n_int = 2 ** ce.max_depth - 1
    want = (dl[:, :n_int].to(torch.uint8)
            | ((cat[:, :n_int] & (ef[:, :n_int] >= 0)).to(torch.uint8) << 1))
    assert torch.equal(tables.flags, want)
    assert torch.equal(tables.nodes[..., 0], ef[:, :n_int])
    assert tables.cls.tolist() == [0] * ce.n_trees_padded
    assert tables.max_feature == int(ef[:, :n_int].max())
    with pytest.raises(TypeError, match="prepared on the CPU"):
        tpred.predict_prepared(tables, torch.from_numpy(_X(10)),
                               learning_rate=0.1, base=0.0)
    with pytest.raises(TypeError, match="CUDA tensor"):
        predict_cuda.traverse_cuda(tables, torch.from_numpy(_X(10)),
                                   learning_rate=0.1, base=0.0)


@pytest.mark.parametrize("depth,F,sub", [(6, 28, 64), (3, 4, 64),
                                          (9, 28, 32)])
def test_stage_width_fits_h100(depth, F, sub):
    limit = 232_448
    assert predict_cuda.stage_width(64, depth, F, limit) == sub
    assert predict_cuda.smem_bytes(sub, depth, F) <= limit


def test_stage_width_raises_when_one_tree_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        predict_cuda.stage_width(64, 15, 28, 232_448)
