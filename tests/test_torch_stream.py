"""The port's streamed trainer and scorer (ddt_tpu_torch/streaming.py) on
the CPU: the mirrors of tests/test_streaming.py's device cases.

Every streamed run is held two ways:
- against the port's in-memory Driver on the same rows, BITWISE (every
  node array, leaf values and gains included): the level tables are
  exact (int64 fixed point for f32 gradients, int32 for int8 ones), so
  chunked sums equal whole ones;
- against ddt_tpu.streaming.fit_streaming on JAX-CPU (backend "tpu", the
  reference's device loop) with tests/tree_compare.py's tie-aware
  comparator (the reference's f32 sums differ from exact ones by f32
  rounding; int8 trees are compared the same way).
Partitioned runs use gloo ranks (parallel/spawn, two or four processes)
and are held bitwise to the one-device in-memory run. Also: the folded
pass count (each chunk read rounds x classes x (max_depth + 1) times
with the cache off, once with it on) and h2d_bytes exactly that many
chunk bytes, the cache budget, the refusals, and predict_streaming equal
to api.predict and to the reference's predict_streaming.
"""

import numpy as np
import pytest

from ddt_tpu.backends import get_backend as j_get_backend
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu.streaming import fit_streaming as j_fit_streaming
from ddt_tpu.streaming import predict_streaming as j_predict_streaming
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import fit_bin_mapper, quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.streaming import fit_streaming, predict_streaming
from ddt_tpu_torch.telemetry import counters as tele_counters
from tree_compare import assert_trees_match_mod_ties

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = spawn.Pool(world, backend="gloo", device="cpu",
                                     timeout_s=120.0)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _chunked(Xb, y, chunk_rows):
    def chunk_fn(c):
        s = c * chunk_rows
        return Xb[s:s + chunk_rows], y[s:s + chunk_rows]
    return chunk_fn, Xb.shape[0] // chunk_rows


def _chunked_all(Xb, y, n_chunks):
    bounds = np.linspace(0, len(y), n_chunks + 1).astype(np.int64)

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]
    return chunk_fn, n_chunks


def _cfg(**kw):
    return TrainConfig(device="cpu", **kw)


def _jcfg(cfg: TrainConfig) -> JConfig:
    kw = dict(n_trees=cfg.n_trees, max_depth=cfg.max_depth,
              n_bins=cfg.n_bins, learning_rate=cfg.learning_rate,
              loss=cfg.loss, n_classes=cfg.n_classes, seed=cfg.seed,
              subsample=cfg.subsample,
              colsample_bytree=cfg.colsample_bytree,
              missing_policy=cfg.missing_policy,
              min_split_gain=cfg.min_split_gain, grad_dtype=cfg.grad_dtype,
              cat_features=cfg.cat_features)
    return JConfig(backend="tpu", **kw)


def _inmemory(Xb, y, cfg):
    return Driver(get_backend(cfg), cfg).fit(Xb, y)


def _bitwise(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def _vs_reference(ens, chunk_fn, n_chunks, cfg, **kw):
    ref = j_fit_streaming(chunk_fn, n_chunks, _jcfg(cfg), **kw)
    assert ref.n_trees == ens.n_trees
    assert_trees_match_mod_ties(ref, ens, cfg.min_split_gain)
    return ref


def _binary(n=4096, F=10, bins=31, seed=21):
    X, y = datasets.synthetic_binary(n, n_features=F, seed=seed)
    return quantize(X, n_bins=bins, seed=seed)[0], y


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_stream_matches_inmemory(grad_dtype):
    Xb, y = _binary()
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=31, grad_dtype=grad_dtype)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    assert n_chunks == 8
    streamed = fit_streaming(chunk_fn, n_chunks, cfg)
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    _vs_reference(streamed, chunk_fn, n_chunks, cfg)


def test_stream_stress_generator_runs():
    """The 10B-row config's generator, miniaturised: streamed chunks of
    already-binned uint8 rows."""
    cfg = _cfg(n_trees=2, max_depth=3, n_bins=255)

    def chunk_fn(c):
        return datasets.stress_binned_chunk(c, chunk_rows=256,
                                            n_features=64, seed=9)

    ens = fit_streaming(chunk_fn, 4, cfg)
    assert ens.n_trees == 2
    Xb, y = datasets.stress_binned_chunk(0, 256, n_features=64, seed=9)
    p = ens.predict(Xb, binned=True)
    assert p[y == 1].mean() > p[y == 0].mean()


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_stream_sampling_matches_inmemory(grad_dtype):
    Xb, y = _binary()
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=31, subsample=0.7,
               colsample_bytree=0.6, seed=11, grad_dtype=grad_dtype)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg)
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    _vs_reference(streamed, chunk_fn, n_chunks, cfg)


def test_stream_sampling_softmax_partitioned(pools):
    """Sampling x softmax x row shards x streaming: two gloo ranks, each
    chunk row-sharded over them, equal the one-device in-memory run."""
    X, y = datasets.synthetic_multiclass(3072, n_features=8, n_classes=3,
                                         seed=9)
    Xb, _ = quantize(X, n_bins=31, seed=9)
    kw = dict(n_trees=3, max_depth=3, n_bins=31, loss="softmax",
              n_classes=3, subsample=0.8, colsample_bytree=0.7, seed=4)
    full = _inmemory(Xb, y, _cfg(**kw))
    bounds = np.arange(0, 3073, 768)
    outs = pools(2).run(tasks.train_streaming, Xb, y, bounds,
                        dict(kw, n_partitions=2))
    for o in outs:
        _bitwise(full, o["ensemble"])


def test_stream_empty_chunk_rejected():
    cfg = _cfg(n_trees=2, max_depth=2)
    with pytest.raises(ValueError, match="empty"):
        fit_streaming(
            lambda c: (np.zeros((0, 3), np.uint8), np.zeros(0)), 2, cfg)


def test_stream_early_stop_nan_metric_raises():
    X, y = datasets.synthetic_binary(512, n_features=6, seed=3)
    Xb, _ = quantize(X, n_bins=15, seed=3)
    cfg = _cfg(n_trees=5, max_depth=2, n_bins=15, loss="mse")
    yv = np.full(128, np.nan)     # NaN labels: NaN rmse every round
    chunk_fn, n = _chunked_all(Xb, y.astype(np.float32), 2)
    with pytest.raises(ValueError, match="NaN since round 1"):
        fit_streaming(chunk_fn, n, cfg,
                      valid_chunk_fn=lambda c: (Xb[:128], yv),
                      n_valid_chunks=1, eval_metric="rmse",
                      early_stopping_rounds=2)


@pytest.mark.parametrize("layout", [dict(n_partitions=2),
                                    dict(host_partitions=2,
                                         n_partitions=2)],
                         ids=["2", "2hx2"])
def test_stream_partitioned_matches_inmemory(pools, layout):
    """Each chunk row-sharded over the ranks, the level tables reduced
    once a level (exact), equals the one-device in-memory run bitwise;
    the device chunk cache (an explicit budget) changes nothing."""
    Xb, y = _binary(seed=23)
    kw = dict(n_trees=4, max_depth=4, n_bins=31)
    full = _inmemory(Xb, y, _cfg(**kw))
    bounds = np.arange(0, 4097, 512)
    world = TrainConfig(**layout).world_size
    for fit_kw in ({}, dict(device_chunk_cache=1 << 30)):
        outs = pools(world).run(tasks.train_streaming, Xb, y, bounds,
                                dict(kw, **layout), fit_kw)
        for o in outs:
            _bitwise(full, o["ensemble"])


def test_stream_early_leaves_match_inmemory():
    """3 bins, depth 6: most rows freeze at early leaves; their leaf slots
    must keep them there through the pred update."""
    Xb, y = _binary(n=2048, F=6, bins=3, seed=9)
    cfg = _cfg(n_trees=5, max_depth=6, n_bins=3)
    full = _inmemory(Xb, y, cfg)
    chunk_fn, n = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n, cfg)
    assert full.is_leaf[:, : 2 ** 6 - 1].any()
    _bitwise(full, streamed)
    _vs_reference(streamed, chunk_fn, n, cfg)


def test_stream_depth_15_leaf_slots_match_inmemory():
    """A chain of splits past depth 14: leaf heap ids reach 2^15 - 1 and
    beyond (past int16), and the resident leaf slots must carry them into
    the next round's pred update unchanged."""
    from ddt_tpu_torch.streaming import _leaf_slot

    rng = np.random.default_rng(15)
    n, D = 2048, 15
    # Squared loss on noise, few rows a node from min_child_weight: the
    # splits chase single rows down to the last level.
    Xb = rng.integers(0, 63, (n, 2)).astype(np.uint8)
    y = rng.standard_normal(n).astype(np.float32)
    cfg = _cfg(n_trees=3, max_depth=D, n_bins=63, loss="mse",
               learning_rate=0.5)
    full = _inmemory(Xb, y, cfg)
    slots = _leaf_slot(Xb, full.feature[0], full.threshold_bin[0],
                       full.is_leaf[0], D)
    assert slots.max() >= 2 ** D - 1
    chunk_fn, nc = _chunked(Xb, y, 512)
    _bitwise(full, fit_streaming(chunk_fn, nc, cfg))


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_stream_softmax_matches_inmemory(grad_dtype):
    X, y = datasets.synthetic_multiclass(2048, n_features=8, n_classes=3,
                                         seed=5)
    Xb, _ = quantize(X, n_bins=31, seed=5)
    cfg = _cfg(n_trees=3, max_depth=3, n_bins=31, loss="softmax",
               n_classes=3, grad_dtype=grad_dtype)
    chunk_fn, n = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n, cfg)
    assert streamed.n_trees == 9
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    _vs_reference(streamed, chunk_fn, n, cfg)


def test_stream_missing_matches_inmemory():
    rng = np.random.default_rng(3)
    X, y = datasets.synthetic_binary(4096, n_features=10, seed=21)
    X[rng.random(X.shape) < 0.15] = np.nan
    m = fit_bin_mapper(X, n_bins=31, missing_policy="learn")
    Xb = m.transform(X)
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=31, missing_policy="learn")
    chunk_fn, n = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n, cfg)
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    assert streamed.missing_bin
    assert streamed.default_left[~streamed.is_leaf].any()
    _vs_reference(streamed, chunk_fn, n, cfg)


def test_stream_categorical_matches_inmemory():
    rng = np.random.default_rng(4)
    Xb, y = _binary(n=3000, F=6, bins=31, seed=4)
    Xb[:, 2] = rng.integers(0, 12, 3000)
    y = ((Xb[:, 2] % 3 == 0) ^ (rng.random(3000) < 0.1)).astype(np.int32)
    cfg = _cfg(n_trees=3, max_depth=3, n_bins=31, cat_features=(2,))
    chunk_fn, n = _chunked_all(Xb, y, 3)
    streamed = fit_streaming(chunk_fn, n, cfg)
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    assert (streamed.feature == 2).any()


def test_stream_ragged_chunks_match_inmemory():
    Xb, y = _binary(n=4000, F=8, seed=9)
    cfg = _cfg(n_trees=3, max_depth=4, n_bins=31)
    bounds = [0, 1337, 2674, 4000]

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    streamed = fit_streaming(chunk_fn, 3, cfg)
    _bitwise(_inmemory(Xb, y, cfg), streamed)
    _vs_reference(streamed, chunk_fn, 3, cfg)


@pytest.mark.parametrize("grad_dtype,loss", [
    ("f32", "logloss"), ("f32", "softmax"), ("int8", "logloss")])
def test_stream_checkpoint_resume_bit_exact(tmp_path, grad_dtype, loss):
    if loss == "softmax":
        X, y = datasets.synthetic_multiclass(2048, n_features=8,
                                             n_classes=3, seed=5)
        extra = dict(loss="softmax", n_classes=3)
    else:
        X, y = datasets.synthetic_binary(2048, n_features=8, seed=5)
        extra = {}
    Xb, _ = quantize(X, n_bins=31, seed=5)
    cfg = _cfg(n_trees=5, max_depth=3, n_bins=31, grad_dtype=grad_dtype,
               subsample=0.8, **extra)
    chunk_fn, n = _chunked(Xb, y, 512)
    plain = fit_streaming(chunk_fn, n, cfg)
    ck = str(tmp_path / "ck")
    fit_streaming(chunk_fn, n, cfg.replace(n_trees=2), checkpoint_dir=ck,
                  checkpoint_every=1)
    resumed = fit_streaming(chunk_fn, n, cfg, checkpoint_dir=ck,
                            checkpoint_every=2)
    _bitwise(plain, resumed)
    # The streamed checkpoint's model loads in ddt_tpu.
    j = JEnsemble.load(str(tmp_path / "ck" / "ensemble.npz"))
    np.testing.assert_array_equal(j.leaf_value, resumed.leaf_value)


def _val_split(Xb, y, frac=0.25, seed=7):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    k = int(len(y) * frac)
    va, tr = idx[:k], idx[k:]
    return Xb[tr], y[tr], Xb[va], y[va]


def test_stream_validation_history_matches_driver():
    X, y = datasets.synthetic_binary(4096, n_features=10, seed=13)
    Xb, _ = quantize(X, n_bins=31, seed=13)
    Xt, yt, Xv, yv = _val_split(Xb, y)
    cfg = _cfg(n_trees=5, max_depth=3, n_bins=31)
    drv = Driver(get_backend(cfg), cfg)
    full = drv.fit(Xt, yt, eval_set=(Xv, yv), eval_metric="auc")
    want = [r["valid_auc"] for r in drv.history]
    chunk_fn, n = _chunked_all(Xt, yt, 6)
    vfn, n_valid = _chunked_all(Xv, yv, 2)
    history = []
    streamed = fit_streaming(chunk_fn, n, cfg, valid_chunk_fn=vfn,
                             n_valid_chunks=n_valid, eval_metric="auc",
                             history=history)
    got = [r["valid_auc"] for r in history]
    assert len(got) == 5 and streamed.n_trees == 5
    _bitwise(full, streamed)
    # The Driver's device metric is f32, the streamed one host f64.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    ref_hist = []
    _vs_reference(streamed, chunk_fn, n, cfg, valid_chunk_fn=vfn,
                  n_valid_chunks=n_valid, eval_metric="auc",
                  history=ref_hist)
    np.testing.assert_allclose(got, [r["valid_auc"] for r in ref_hist],
                               rtol=1e-4)


def test_stream_early_stop_truncates_like_driver():
    X, y = datasets.synthetic_binary(3072, n_features=8, seed=17)
    Xb, _ = quantize(X, n_bins=31, seed=17)
    Xt, yt, Xv, yv = _val_split(Xb, y)
    cfg = _cfg(n_trees=30, max_depth=4, n_bins=31, learning_rate=0.9,
               min_split_gain=1e-3)
    drv = Driver(get_backend(cfg), cfg)
    full = drv.fit(Xt, yt, eval_set=(Xv, yv), eval_metric="logloss",
                   early_stopping_rounds=3)
    assert full.n_trees < 30
    chunk_fn, n = _chunked_all(Xt, yt, 4)
    vfn, n_valid = _chunked_all(Xv, yv, 2)
    streamed = fit_streaming(chunk_fn, n, cfg, valid_chunk_fn=vfn,
                             n_valid_chunks=n_valid, eval_metric="logloss",
                             early_stopping_rounds=3)
    assert streamed.n_trees == full.n_trees
    _bitwise(full, streamed)


def test_stream_early_stopping_requires_validation():
    cfg = _cfg(n_trees=2, max_depth=2)
    with pytest.raises(ValueError, match="valid_chunk_fn"):
        fit_streaming(lambda c: (np.zeros((4, 3), np.uint8), np.zeros(4)),
                      1, cfg, early_stopping_rounds=2)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_stream_folded_pass_count(grad_dtype):
    """A T-round depth-D binary run reads each chunk exactly T (D + 1)
    times (D histogram passes and the leaf pass; the round start reads
    none) and moves exactly that many chunk bytes to the device with the
    cache off; with it on each chunk is read and moved once."""
    X, y = datasets.synthetic_binary(2048, n_features=8, seed=3)
    Xb, _ = quantize(X, n_bins=31, seed=3)
    calls = {"n": 0}

    def chunk_fn(c):
        calls["n"] += 1
        return Xb[c * 512:(c + 1) * 512], y[c * 512:(c + 1) * 512]

    chunk_fn.labels = lambda c: y[c * 512:(c + 1) * 512]
    chunk_fn.n_features = 8
    cfg = _cfg(n_trees=3, max_depth=4, n_bins=31, grad_dtype=grad_dtype)
    c0 = tele_counters.snapshot()
    streamed = fit_streaming(chunk_fn, 4, cfg, device_chunk_cache=False)
    assert calls["n"] == 4 * 3 * (4 + 1)
    assert tele_counters.delta(c0)["h2d_bytes"] == \
        512 * 8 * 4 * 3 * (4 + 1)
    _bitwise(_inmemory(Xb, y, cfg), streamed)

    calls["n"] = 0
    c0 = tele_counters.snapshot()
    cached = fit_streaming(chunk_fn, 4, cfg, device_chunk_cache=1 << 30)
    assert calls["n"] == 4
    assert tele_counters.delta(c0)["h2d_bytes"] == 512 * 8 * 4
    _bitwise(streamed, cached)

    # The default (True) caches nothing on the CPU, where the "device" is
    # host memory.
    calls["n"] = 0
    fit_streaming(chunk_fn, 4, cfg, device_chunk_cache=True)
    assert calls["n"] == 4 * 3 * (4 + 1)


def test_stream_cache_budget():
    X, y = datasets.synthetic_binary(2048, n_features=8, seed=9)
    Xb, _ = quantize(X, n_bins=31, seed=9)
    calls = {"n": 0}

    def chunk_fn(c):
        calls["n"] += 1
        return Xb[c * 512:(c + 1) * 512], y[c * 512:(c + 1) * 512]

    chunk_fn.labels = lambda c: y[c * 512:(c + 1) * 512]
    chunk_fn.n_features = 8
    cfg = _cfg(n_trees=2, max_depth=3, n_bins=31)
    part = fit_streaming(chunk_fn, 4, cfg, device_chunk_cache=2 * 512 * 8)
    passes = 2 * (3 + 1)
    assert calls["n"] == 2 + 2 * passes
    full = fit_streaming(chunk_fn, 4, cfg, device_chunk_cache=False)
    _bitwise(part, full)


def test_stream_refuses_out_of_range_bins():
    Xb, y = _binary(n=1024, F=6, bins=31)
    Xb[700, 2] = 40
    chunk_fn, n = _chunked(Xb, y, 512)
    with pytest.raises(ValueError, match="n_bins"):
        fit_streaming(chunk_fn, n, _cfg(n_trees=1, max_depth=2, n_bins=31))


@pytest.mark.parametrize("impl", ["auto", "lut", "lut4"])
def test_predict_streaming_equals_api_predict(impl):
    X, y = datasets.synthetic_multiclass(3000, n_features=8, n_classes=3,
                                         seed=2)
    Xb, _ = quantize(X, n_bins=31, seed=2)
    cfg = _cfg(n_trees=4, max_depth=4, n_bins=31, loss="softmax",
               n_classes=3)
    chunk_fn, n = _chunked_all(Xb, y, 4)
    ens = fit_streaming(chunk_fn, n, cfg)
    be = get_backend(_cfg(n_bins=31, predict_impl=impl))
    want = api.predict(ens, Xb, binned=True, raw=True, backend=be)
    got = predict_streaming(chunk_fn, n, ens, backend=be)
    np.testing.assert_array_equal(got, want)
    proba = predict_streaming(chunk_fn, n, ens, backend=be, raw=False)
    np.testing.assert_array_equal(
        proba, api.predict(ens, Xb, binned=True, backend=be))
    seen = {}
    assert predict_streaming(chunk_fn, n, ens, backend=be,
                             sink=lambda c, s: seen.__setitem__(c, s)) \
        == len(y)
    np.testing.assert_array_equal(np.concatenate([seen[c] for c in
                                                  range(n)]), want)
    if impl == "auto":
        # The reference's predict_streaming on the same ensemble (loaded
        # there from the port's npz fields).
        j = JEnsemble.from_dict(ens.to_dict())
        ref = j_predict_streaming(chunk_fn, n, j,
                                  backend=j_get_backend(JConfig(
                                      backend="tpu", n_bins=31)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_reference_streamed_ensemble_loads_in_the_port(tmp_path):
    Xb, y = _binary(n=2048, F=6)
    chunk_fn, n = _chunked(Xb, y, 512)
    jens = j_fit_streaming(chunk_fn, n, JConfig(n_trees=3, max_depth=3,
                                                n_bins=31, backend="tpu"))
    path = str(tmp_path / "m.npz")
    jens.save(path)
    ens = TreeEnsemble.load(path)
    got = predict_streaming(chunk_fn, n, ens, device="cpu")
    np.testing.assert_array_equal(
        got, api.predict(ens, Xb[:4 * 512], binned=True, raw=True,
                         device="cpu"))
    np.testing.assert_allclose(
        got, jens.predict_raw(Xb[:4 * 512], binned=True), rtol=1e-5,
        atol=1e-6)


def test_leaf_slot_and_rescore_equal_reference():
    """The host helpers (`_leaf_slot`, `_rescore`) against the
    reference's, and `_leaf_slot` against the device routing
    (ops/stream.route) the streamed trainer takes, on a learned-missing
    model."""
    import torch

    from ddt_tpu.streaming import _leaf_slot as j_leaf_slot
    from ddt_tpu.streaming import _rescore as j_rescore
    from ddt_tpu_torch.ops.stream import route
    from ddt_tpu_torch.streaming import _leaf_slot, _rescore

    rng = np.random.default_rng(8)
    X, y = datasets.synthetic_binary(2048, n_features=8, seed=8)
    X[rng.random(X.shape) < 0.1] = np.nan
    Xb = fit_bin_mapper(X, n_bins=31, missing_policy="learn").transform(X)
    cfg = _cfg(n_trees=3, max_depth=4, n_bins=31, missing_policy="learn")
    chunk_fn, n = _chunked(Xb, y, 512)
    ens = fit_streaming(chunk_fn, n, cfg)
    jens = JEnsemble.from_dict(ens.to_dict())
    for t in range(ens.n_trees):
        args = (ens.feature[t], ens.threshold_bin[t], ens.is_leaf[t], 4)
        kw = dict(default_left=ens.default_left[t], missing_bin_value=30)
        got = _leaf_slot(Xb, *args, **kw)
        np.testing.assert_array_equal(got, j_leaf_slot(Xb, *args, **kw))
        dev = route(torch.from_numpy(Xb), *(torch.from_numpy(a)
                                            for a in args[:3]), 4,
                    torch.from_numpy(ens.default_left[t]), 30)
        np.testing.assert_array_equal(got, dev.numpy())
    for k in (0, 2):
        np.testing.assert_allclose(_rescore(ens, k, Xb, ens.base_score),
                                   j_rescore(jens, k, Xb, jens.base_score),
                                   rtol=1e-6, atol=1e-6)


def test_binned_chunks_from_raw_chunks():
    """Raw float chunks through a streamed-fit mapper (binned_chunks,
    fit_bin_mapper_streaming) train what the pre-binned chunks train;
    the mapper<->config guards refuse a mismatched mapper."""
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper_streaming
    from ddt_tpu_torch.streaming import binned_chunks

    X, y = datasets.synthetic_binary(2048, n_features=6, seed=12)

    def raw(c):
        return X[c * 512:(c + 1) * 512], y[c * 512:(c + 1) * 512]

    mapper = fit_bin_mapper_streaming(raw, 4, n_bins=31, seed=1)
    cfg = _cfg(n_trees=3, max_depth=3, n_bins=31)
    src = binned_chunks(raw, mapper, cfg)
    assert src.n_features == 6
    np.testing.assert_array_equal(src.labels(1), y[512:1024])
    Xb = mapper.transform(X)
    pre, n = _chunked(Xb, y, 512)
    _bitwise(fit_streaming(pre, n, cfg), fit_streaming(src, 4, cfg))
    with pytest.raises(ValueError, match="n_bins"):
        binned_chunks(raw, mapper, cfg.replace(n_bins=63))
    with pytest.raises(ValueError, match="missing_bin"):
        binned_chunks(raw, mapper, cfg.replace(missing_policy="learn"))


# --------------------------------------------------------------------- #
# The host loop: fit_streaming over the CPU oracle (backend="cpu"),
# the twins of tests/test_streaming.py's backend="cpu" cases, each held to
# the port's in-memory oracle fit as the reference holds its own (trees
# equal, leaves to 2e-4) and to the reference's host loop on the same
# chunks with tests/tree_compare.py's comparator.
# --------------------------------------------------------------------- #
def _host(**kw):
    return TrainConfig(backend="cpu", **kw)


def _vs_reference_host(ens, chunk_fn, n_chunks, cfg, **kw):
    jcfg = _jcfg(cfg).replace(backend="cpu")
    ref = j_fit_streaming(chunk_fn, n_chunks, jcfg, **kw)
    assert ref.n_trees == ens.n_trees
    assert_trees_match_mod_ties(ref, ens, cfg.min_split_gain)
    return ref


def _like_inmemory(full, streamed, default_left=False):
    np.testing.assert_array_equal(full.feature, streamed.feature)
    np.testing.assert_array_equal(full.threshold_bin, streamed.threshold_bin)
    np.testing.assert_array_equal(full.is_leaf, streamed.is_leaf)
    if default_left:
        np.testing.assert_array_equal(full.default_left,
                                      streamed.default_left)
    np.testing.assert_allclose(full.leaf_value, streamed.leaf_value,
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_matches_inmemory(cache):
    Xb, y = _binary()
    cfg = _host(n_trees=4, max_depth=4, n_bins=31)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, cache_preds=cache)
    _like_inmemory(_inmemory(Xb, y, cfg), streamed)
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, cache_preds=cache)


def test_stream_host_stress_generator_runs():
    cfg = _host(n_trees=2, max_depth=3, n_bins=255)

    def chunk_fn(c):
        return datasets.stress_binned_chunk(c, chunk_rows=256,
                                            n_features=64, seed=9)

    ens = fit_streaming(chunk_fn, 4, cfg)
    assert ens.n_trees == 2
    Xb, y = datasets.stress_binned_chunk(0, 256, n_features=64, seed=9)
    p = ens.predict(Xb, binned=True)
    assert p[y == 1].mean() > p[y == 0].mean()
    _vs_reference_host(ens, chunk_fn, 4, cfg)


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_softmax_matches_inmemory(cache):
    X, y = datasets.synthetic_multiclass(2048, n_features=8, n_classes=3,
                                         seed=5)
    Xb = quantize(X, n_bins=31, seed=5)[0]
    cfg = _host(n_trees=3, max_depth=3, n_bins=31, loss="softmax",
                n_classes=3)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, cache_preds=cache)
    assert streamed.n_trees == 9
    _like_inmemory(_inmemory(Xb, y, cfg), streamed)
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, cache_preds=cache)


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_sampling_matches_inmemory(cache):
    Xb, y = _binary()
    cfg = _host(n_trees=4, max_depth=4, n_bins=31, subsample=0.7,
                colsample_bytree=0.6, seed=11)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, cache_preds=cache)
    _like_inmemory(_inmemory(Xb, y, cfg), streamed)
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, cache_preds=cache)


def test_stream_host_empty_chunk_rejected():
    with pytest.raises(ValueError, match="empty"):
        fit_streaming(lambda c: (np.zeros((0, 3), np.uint8), np.zeros(0)), 2,
                      _host(n_trees=2, max_depth=2))


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_missing_matches_inmemory(cache):
    rng = np.random.default_rng(3)
    X, y = datasets.synthetic_binary(4096, n_features=10, seed=21)
    X[rng.random(X.shape) < 0.15] = np.nan
    Xb = fit_bin_mapper(X, n_bins=31, missing_policy="learn").transform(X)
    cfg = _host(n_trees=4, max_depth=4, n_bins=31, missing_policy="learn")
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, cache_preds=cache)
    _like_inmemory(_inmemory(Xb, y, cfg), streamed, default_left=True)
    assert streamed.missing_bin
    assert streamed.default_left[~streamed.is_leaf].any()
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, cache_preds=cache)


def test_stream_host_categorical_matches_inmemory():
    rng = np.random.default_rng(4)
    Xb, y = _binary(n=3000, F=6, bins=31, seed=4)
    Xb[:, 2] = rng.integers(0, 12, 3000)
    y = ((Xb[:, 2] % 3 == 0) ^ (rng.random(3000) < 0.1)).astype(np.int32)
    cfg = _host(n_trees=3, max_depth=3, n_bins=31, cat_features=(2,))
    chunk_fn, n = _chunked_all(Xb, y, 3)
    streamed = fit_streaming(chunk_fn, n, cfg)
    _like_inmemory(_inmemory(Xb, y, cfg), streamed)
    assert (streamed.feature == 2).any()
    _vs_reference_host(streamed, chunk_fn, n, cfg)


def test_stream_host_ragged_chunks_match_inmemory():
    X, y = datasets.synthetic_binary(4000, n_features=8, seed=9)
    Xb = quantize(X, n_bins=31, seed=9)[0]
    cfg = _host(n_trees=3, max_depth=4, n_bins=31)
    bounds = [0, 1337, 2674, 4000]

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    streamed = fit_streaming(chunk_fn, 3, cfg)
    full = _inmemory(Xb, y, cfg)
    np.testing.assert_array_equal(full.feature, streamed.feature)
    np.testing.assert_array_equal(full.threshold_bin, streamed.threshold_bin)
    _vs_reference_host(streamed, chunk_fn, 3, cfg)


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_checkpoint_resume_bit_exact(tmp_path, cache):
    X, y = datasets.synthetic_binary(2048, n_features=8, seed=5)
    Xb = quantize(X, n_bins=31, seed=5)[0]
    cfg = _host(n_trees=5, max_depth=3, n_bins=31)
    chunk_fn, n_chunks = _chunked(Xb, y, 512)
    plain = fit_streaming(chunk_fn, n_chunks, cfg, cache_preds=cache)
    ck = str(tmp_path / "ck")
    fit_streaming(chunk_fn, n_chunks, cfg.replace(n_trees=2),
                  checkpoint_dir=ck, checkpoint_every=1, cache_preds=cache)
    resumed = fit_streaming(chunk_fn, n_chunks, cfg, checkpoint_dir=ck,
                            checkpoint_every=2, cache_preds=cache)
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(getattr(plain, k), getattr(resumed, k))


def test_stream_host_validation_history_matches_driver():
    X, y = datasets.synthetic_binary(4096, n_features=10, seed=13)
    Xb = quantize(X, n_bins=31, seed=13)[0]
    Xt, yt, Xv, yv = _val_split(Xb, y)
    cfg = _host(n_trees=5, max_depth=3, n_bins=31)
    drv = Driver(get_backend(cfg), cfg, log_every=10**9)
    drv.fit(Xt, yt, eval_set=(Xv, yv), eval_metric="auc")
    want = [r["valid_auc"] for r in drv.history]
    chunk_fn, n_chunks = _chunked_all(Xt, yt, 6)
    vfn, n_valid = _chunked_all(Xv, yv, 2)
    history, jhistory = [], []
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, valid_chunk_fn=vfn,
                             n_valid_chunks=n_valid, eval_metric="auc",
                             history=history)
    got = [r["valid_auc"] for r in history]
    assert len(got) == 5 and streamed.n_trees == 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, valid_chunk_fn=vfn,
                       n_valid_chunks=n_valid, eval_metric="auc",
                       history=jhistory)
    np.testing.assert_allclose(got, [r["valid_auc"] for r in jhistory],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cache", [True, False])
def test_stream_host_early_stop_truncates_like_driver(cache):
    X, y = datasets.synthetic_binary(3072, n_features=8, seed=17)
    Xb = quantize(X, n_bins=31, seed=17)[0]
    Xt, yt, Xv, yv = _val_split(Xb, y)
    cfg = _host(n_trees=30, max_depth=4, n_bins=31, learning_rate=0.9,
                min_split_gain=1e-3)
    drv = Driver(get_backend(cfg), cfg, log_every=10**9)
    full = drv.fit(Xt, yt, eval_set=(Xv, yv), eval_metric="logloss",
                   early_stopping_rounds=3)
    assert full.n_trees < 30
    chunk_fn, n_chunks = _chunked_all(Xt, yt, 4)
    vfn, n_valid = _chunked_all(Xv, yv, 2)
    kw = dict(valid_chunk_fn=vfn, n_valid_chunks=n_valid,
              eval_metric="logloss", early_stopping_rounds=3,
              cache_preds=cache)
    streamed = fit_streaming(chunk_fn, n_chunks, cfg, **kw)
    assert streamed.n_trees == full.n_trees
    np.testing.assert_array_equal(full.feature, streamed.feature)
    np.testing.assert_array_equal(full.threshold_bin, streamed.threshold_bin)
    np.testing.assert_allclose(full.leaf_value, streamed.leaf_value,
                               rtol=2e-4, atol=2e-5)
    _vs_reference_host(streamed, chunk_fn, n_chunks, cfg, **kw)
    # The device loop (CUDADevice on the CPU) stops at the same round.
    dev = fit_streaming(chunk_fn, n_chunks, cfg.replace(backend="cuda",
                                                        device="cpu"),
                        **{k: v for k, v in kw.items()
                           if k != "cache_preds"})
    assert dev.n_trees == streamed.n_trees
    np.testing.assert_array_equal(dev.feature, streamed.feature)


def test_stream_host_early_stop_requires_validation():
    with pytest.raises(ValueError, match="valid_chunk_fn"):
        fit_streaming(lambda c: (np.zeros((4, 3), np.uint8), np.zeros(4)),
                      1, _host(n_trees=2, max_depth=2),
                      early_stopping_rounds=2)


@pytest.mark.parametrize("grad_dtype", ["int8", "int16"])
def test_stream_host_refuses_quantized_gradients(grad_dtype):
    """The host loop has no integer histogram, as in the reference: a
    quantized config is refused (by the oracle backend, or by the loop
    when a backend is handed in)."""
    from ddt_tpu_torch.backends.cpu import CPUDevice

    Xb, y = _binary(512)
    chunk_fn, n_chunks = _chunked(Xb, y, 256)
    cfg = _host(n_trees=1, max_depth=2, n_bins=31, grad_dtype=grad_dtype)
    with pytest.raises(NotImplementedError, match="grad_dtype"):
        fit_streaming(chunk_fn, n_chunks, cfg)
    with pytest.raises(NotImplementedError, match="host loop"):
        fit_streaming(chunk_fn, n_chunks, cfg,
                      backend=CPUDevice(cfg.replace(grad_dtype="f32")))
    jcfg = _jcfg(cfg).replace(backend="cpu")
    with pytest.raises(NotImplementedError, match="grad_dtype"):
        j_fit_streaming(chunk_fn, n_chunks, jcfg,
                        backend=j_get_backend(jcfg.replace(
                            grad_dtype="f32")))


def test_stream_host_run_log_names_the_host_trainer(tmp_path):
    from ddt_tpu_torch.telemetry.events import RunLog

    Xb, y = _binary(1024)
    chunk_fn, n_chunks = _chunked(Xb, y, 256)
    log = RunLog()
    fit_streaming(chunk_fn, n_chunks, _host(n_trees=2, max_depth=2,
                                            n_bins=31), run_log=log)
    man = log.events("run_manifest")[0]
    assert man["trainer"] == "streaming_host" and man["backend"] == "cpu"
    assert len(log.events("round")) == 2
