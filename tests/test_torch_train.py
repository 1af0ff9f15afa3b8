"""The port's whole slice against ddt_tpu on the CPU: api.train -> Driver ->
CUDADevice(device="cpu") -> grow_tree, and api.predict, against
ddt_tpu.api.train(backend="tpu") on JAX-CPU.

Trees must match except at provable bf16-boundary ties
(tests/tree_compare.assert_trees_match_mod_ties; the port and the
reference sum the same f32 terms in different orders), leaves to that
comparator's tolerance, raw predictions to 1e-5.
"""

import numpy as np
import pytest
import torch

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data.datasets import synthetic_binary
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch import api as tapi
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import hist_cuda, predict_cuda
from tree_compare import assert_trees_match_mod_ties


@pytest.fixture(scope="module")
def data():
    return synthetic_binary(4000, seed=0)


@pytest.mark.parametrize("loss", ["logloss", "mse"])
@pytest.mark.parametrize("hist_subtraction", ["off", "on"])
def test_train_matches_reference(data, hist_subtraction, loss):
    X, y = data
    kw = dict(n_trees=10, max_depth=4, n_bins=255, min_split_gain=1e-3,
              hist_subtraction=hist_subtraction, loss=loss)
    ref = japi.train(X, y, JConfig(backend="tpu", **kw))
    port = tapi.train(X, y, TrainConfig(device="cpu", **kw))
    a, b = ref.ensemble, port.ensemble
    assert b.base_score == a.base_score
    assert_trees_match_mod_ties(a, b, kw["min_split_gain"])
    np.testing.assert_array_equal(port.mapper.edges, ref.mapper.edges)
    want = a.predict_raw(X)
    got = tapi.predict(b, X, mapper=port.mapper, raw=True, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Raw thresholds were filled from the mapper: float scoring agrees.
    np.testing.assert_array_equal(b.threshold_raw, a.threshold_raw)


def test_binned_train_and_probabilities(data):
    X, y = data
    port = tapi.train(X, y, n_trees=5, max_depth=3, device="cpu")
    Xb = port.mapper.transform(X)
    again = tapi.train(Xb, y, n_trees=5, max_depth=3, device="cpu",
                       binned=True)
    assert again.mapper is None
    np.testing.assert_array_equal(again.ensemble.feature,
                                  port.ensemble.feature)
    p = tapi.predict(again.ensemble, Xb, binned=True, device="cpu")
    np.testing.assert_allclose(p, again.ensemble.predict(Xb, binned=True),
                               rtol=1e-6, atol=1e-6)
    assert p.min() > 0 and p.max() < 1


def test_trained_model_cross_loads(tmp_path, data):
    X, y = data
    port = tapi.train(X, y, n_trees=4, max_depth=3, device="cpu")
    port.ensemble.save(str(tmp_path / "m.npz"))
    ref = JEnsemble.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(ref.predict_raw(X),
                                  port.ensemble.predict_raw(X))
    back = TreeEnsemble.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(back.predict_raw(X),
                                  port.ensemble.predict_raw(X))


def test_cpu_training_launches_no_kernel(data):
    X, y = data
    h0, p0 = hist_cuda.launches, predict_cuda.launches
    res = tapi.train(X[:500], y[:500], n_trees=2, max_depth=2, device="cpu")
    tapi.predict(res.ensemble, X[:500], mapper=res.mapper, device="cpu")
    assert (hist_cuda.launches, predict_cuda.launches) == (h0, p0)


def test_granular_backend_surface(data):
    """build_histograms + best_splits at the root reproduce the grown
    tree's root split."""
    X, y = data
    cfg = TrainConfig(n_trees=1, max_depth=1, device="cpu")
    res = tapi.train(X, y, cfg)
    Xb = res.mapper.transform(X)
    be = get_backend(cfg)
    yd = be.upload_labels(y)
    g, h = be.grad_hess(be.init_pred(yd, res.ensemble.base_score), yd)
    hist = be.build_histograms(be.upload(Xb), g, h,
                               np.zeros(len(y), np.int32), 1)
    gain, feat, b = be.best_splits(hist)
    assert (int(feat[0]), int(b[0])) == (int(res.ensemble.feature[0, 0]),
                                         int(res.ensemble.threshold_bin[0, 0]))
    assert float(gain[0]) == float(res.ensemble.split_gain[0, 0])


def test_driver_fetch_pipeline_stores_every_tree(data):
    X, y = data
    cfg = TrainConfig(n_trees=3, max_depth=2, device="cpu")
    Xb = fit_bin_mapper(X, 255).transform(X)
    ens = Driver(get_backend(cfg), cfg).fit(Xb, y)
    assert ens.n_trees == 3
    assert (ens.feature[:, 0] >= 0).all() and ens.is_leaf[:, 3:].all()


@pytest.mark.parametrize("bad", [
    dict(loss="softmax", n_classes=1), dict(device="tpu"), dict(n_bins=0),
    dict(n_bins=257), dict(max_depth=0), dict(hist_subtraction="maybe"),
    dict(grad_dtype="int4"), dict(grad_dtype="bf16"), dict(subsample=0.0),
    dict(subsample=1.5), dict(colsample_bytree=0.0),
    dict(colsample_bytree=1.01),
])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        TrainConfig(**bad)


@pytest.mark.parametrize("unported", ["matmul_input_dtype", "hist_impl"])
def test_unported_fields_are_absent(unported):
    with pytest.raises(TypeError):
        TrainConfig(**{unported: 1})


@pytest.mark.parametrize("field,default,bad", [
    ("backend", "cuda", "tpu"),
    ("fault_plan", None, None),
    ("straggler_repartition", False, None),
    ("straggler_skew_threshold", 2.0, 1.0),
])
def test_ported_robustness_fields(field, default, bad):
    """Each field ported with the robustness slice exists with the
    reference's default ("tpu" reads as the port's "cuda") and its
    validation."""
    from ddt_tpu.config import TrainConfig as RefConfig

    assert getattr(TrainConfig(), field) == default
    ref_default = getattr(RefConfig(), field)
    assert ref_default == ("tpu" if field == "backend" else default)
    if bad is not None:
        with pytest.raises(ValueError, match=field):
            TrainConfig(**{field: bad})
        if field != "backend":
            with pytest.raises(ValueError, match=field):
                RefConfig(**{field: bad})


def test_cuda_device_without_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    X, y = data
    assert TrainConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.train(X[:100], y[:100], n_trees=1)
    ens = empty_ensemble(1, 2, X.shape[1], 0.1, 0.0, "logloss")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.predict(ens, np.zeros((3, X.shape[1]), np.uint8), binned=True)


def test_upload_refuses_bins_past_n_bins():
    be = get_backend(TrainConfig(device="cpu", n_bins=16))
    with pytest.raises(ValueError, match="n_bins"):
        be.upload(np.full((4, 2), 16, np.uint8))
    with pytest.raises(TypeError):
        be.upload(np.zeros((4, 2), np.int32))
