"""The port's 2D rows x features mesh, its hosts axis and slab-pipelined
histogram collectives on four gloo ranks on the CPU, against the
reference's tests/test_mesh2d.py contracts: ddt_tpu on JAX-CPU on one
device and on its own (2, 2) mesh (the conftest's 8 virtual devices), and
the port's own single device.

The ranks (one module-scoped pool, parallel/spawn.py) run
parallel/tasks.py: every rank calls api.train with the same full rows,
bins its row block at full width and keeps its column slab. Held:

- f32: trees structure-identical to the reference's single-device and
  (2, 2) trees except at bf16 ties (tests/tree_compare.py), leaves
  within rtol 2e-4 / atol 2e-5, at (1, 1), (2, 2), (1, 4) and 2 hosts x 2
  rows; with F = 9 columns that do not divide (zero padding never wins),
  softmax, learned missing directions, categorical splits with bagging
  and colsample, and the duplicate-column exact tie won by feature 0;
- int8: bitwise equal to the port's single device at every mesh shape
  and slab count; f32 slabs within the tolerance above;
- every rank's ensemble bitwise equal, fused equal to granular, and the
  counted modeled bytes equal to the payload model a tree;
- the config's mesh_shape normalisation and conflicts, the payload model
  equal to the reference's over a grid, the layout rules, and the
  config-5 generator bitwise equal to the reference's.
"""

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data import datasets as jdatasets
from ddt_tpu.parallel import comms as jcomms
from ddt_tpu.telemetry import counters as jcounters
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import (stress_binned_chunk,
                                         synthetic_binary,
                                         synthetic_multiclass)
from ddt_tpu_torch.ops import grow
from ddt_tpu_torch.parallel import comms, mesh, spawn, tasks
from tree_compare import assert_trees_match_mod_ties

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")
BASE = dict(n_trees=3, max_depth=4, n_bins=31, min_split_gain=1e-3)
#: Layouts of four ranks (and the one-rank mesh), by test id.
LAYOUTS = {"1x1": dict(mesh_shape=(1, 1)), "2x2": dict(mesh_shape=(2, 2)),
           "1x4": dict(mesh_shape=(1, 4)),
           "2hx2": dict(host_partitions=2, n_partitions=2)}


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


def _world(layout: dict) -> int:
    return TrainConfig(**layout).world_size


def _run(pools, X, y, kw, fit_kw=None, loop="fused"):
    """The ranks' results, after holding every rank's ensemble bitwise
    equal to rank 0's and the counted modeled bytes to the model."""
    outs = pools(_world(kw)).run(tasks.train, X, y, kw, fit_kw, loop)
    for o in outs[1:]:
        _bitwise(o["ensemble"], outs[0]["ensemble"])
    c = outs[0]["counters"]
    C = kw.get("n_classes", 1) if kw.get("loss") == "softmax" else 1
    rounds = len(outs[0]["history"])
    for o in outs:
        assert o["counters"]["comms.modeled_bytes"] == \
            rounds * C * o["bytes_model"]
    assert c["comms.calls"] > 0
    return outs


def _bitwise(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def _match(ref_ens, port_ens, kw):
    assert_trees_match_mod_ties(ref_ens, port_ens, kw["min_split_gain"],
                                leaf_rtol=2e-4, leaf_atol=2e-5)


def _ref(X, y, kw, **layout):
    return japi.train(X, y, JConfig(backend="tpu", **kw, **layout)
                      ).ensemble


def _single(X, y, kw, **fit_kw):
    return api.train(X, y, TrainConfig(device="cpu", **kw),
                     **fit_kw).ensemble


@pytest.fixture(scope="module")
def binary():
    return synthetic_binary(4096, n_features=10, seed=11)


@pytest.fixture(scope="module")
def ref_binary(binary):
    """The reference's single-device and (2, 2) ensembles of `binary`."""
    X, y = binary
    return _ref(X, y, BASE), _ref(X, y, BASE, mesh_shape=(2, 2))


@pytest.mark.parametrize("layout", LAYOUTS, ids=list(LAYOUTS))
def test_structure_identity(pools, binary, ref_binary, layout):
    X, y = binary
    kw = dict(BASE, **LAYOUTS[layout])
    outs = _run(pools, X, y, kw)
    cfg = TrainConfig(**kw)
    # Any mesh with a row wire scatters (test_mesh2d's rule).
    want = "reduce_scatter" if cfg.row_shards > 1 else "allreduce"
    assert outs[0]["split_comms"] == want
    port = outs[0]["ensemble"]
    for ref_ens in ref_binary:
        _match(ref_ens, port, BASE)
    _match(_single(X, y, BASE), port, BASE)


@pytest.mark.parametrize("layout", ["2x2", "1x4"])
def test_ragged_features(pools, layout):
    """F = 9 does not divide Pf: zero columns pad the last slab (at 1 x 4
    the last shard holds only padding), and padding never wins."""
    X, y = synthetic_binary(2048, n_features=9, seed=23)
    kw = dict(BASE, **LAYOUTS[layout])
    port = _run(pools, X, y, kw)[0]["ensemble"]
    assert port.n_features == 9 and port.feature.max() < 9
    _match(_ref(X, y, BASE), port, BASE)
    _match(_single(X, y, BASE), port, BASE)


def test_softmax(pools):
    X, y = synthetic_multiclass(1500, n_features=12, n_classes=4, seed=3)
    kw = dict(BASE, loss="softmax", n_classes=4)
    outs = _run(pools, X, y, dict(kw, mesh_shape=(2, 2)))
    assert outs[0]["split_comms"] == "reduce_scatter"
    port = outs[0]["ensemble"]
    assert port.n_trees == 3 * 4
    _match(_ref(X, y, kw), port, kw)


def test_missing_learn(pools):
    """The direction-block tie-break (right before left) survives the
    winner combine over both axes."""
    X, y = synthetic_binary(3000, n_features=10, seed=7)
    X = X.copy()
    X[::7, 3] = np.nan
    X[::11, 6] = np.nan
    kw = dict(BASE, missing_policy="learn")
    port = _run(pools, X, y, dict(kw, mesh_shape=(2, 2)))[0]["ensemble"]
    ref_ens = _ref(X, y, kw)
    _match(ref_ens, port, kw)
    np.testing.assert_array_equal(ref_ens.default_left, port.default_left)
    assert port.default_left.any()


@pytest.mark.parametrize("layout", ["2x2", "2hx2"])
def test_categorical_and_sampling(pools, binary, layout):
    """One-vs-rest columns on two feature shards, bagging keyed by the
    global row id and the colsample mask drawn over the global columns."""
    X, y = binary
    X = X.copy()
    for f in (1, 6):
        X[:, f] = np.floor(np.abs(X[:, f]) * 3) % 7
    kw = dict(BASE, cat_features=(1, 6), subsample=0.7,
              colsample_bytree=0.6, seed=4)
    port = _run(pools, X, y, dict(kw, **LAYOUTS[layout]))[0]["ensemble"]
    used = port.feature[~port.is_leaf & (port.feature >= 0)]
    assert np.isin(used, (1, 6)).any()
    _match(_ref(X, y, kw), port, kw)
    _match(_single(X, y, kw), port, kw)


def test_duplicate_column_tie_break(pools):
    """Column 7 is a byte-for-byte copy of column 0, so their candidates
    tie exactly; on (2, 2) the copies live on different feature shards.
    The winner is the single device's: the smaller global id."""
    Xb, y = stress_binned_chunk(0, 2048, n_features=8, n_bins=31, seed=13)
    Xb = Xb.copy()
    Xb[:, 7] = Xb[:, 0]
    kw = dict(BASE, mesh_shape=(2, 2), split_comms="reduce_scatter")
    fit = dict(binned=True)
    port = _run(pools, Xb, y, kw, fit)[0]["ensemble"]
    single = _single(Xb, y, BASE, binned=True)
    _match(single, port, BASE)
    split_feats = port.feature[~port.is_leaf & (port.feature >= 0)]
    assert 0 in split_feats and 7 not in split_feats


@pytest.mark.parametrize("slabs", [1, 2, 4])
@pytest.mark.parametrize("layout", ["2x2", "1x4", "2hx2"])
def test_int8_bitwise(pools, layout, slabs):
    X, y = synthetic_binary(4001, n_features=10, seed=7)
    kw = dict(BASE, grad_dtype="int8", subsample=0.8, seed=5)
    outs = _run(pools, X, y,
                dict(kw, hist_comms_slabs=slabs, **LAYOUTS[layout]))
    assert outs[0]["comms_slabs"] == slabs
    _bitwise(outs[0]["ensemble"], _single(X, y, kw))


@pytest.mark.parametrize("slabs", [2, 4])
def test_f32_slabs_within_tolerance(pools, binary, ref_binary, slabs):
    X, y = binary
    outs = _run(pools, X, y, dict(BASE, mesh_shape=(2, 2),
                                  hist_comms_slabs=slabs))
    one = _run(pools, X, y, dict(BASE, mesh_shape=(2, 2)))
    _match(one[0]["ensemble"], outs[0]["ensemble"], BASE)
    _match(ref_binary[0], outs[0]["ensemble"], BASE)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_fused_equals_granular(pools, binary, grad_dtype):
    X, y = binary
    Xv, yv = synthetic_binary(500, n_features=10, seed=12)
    kw = dict(BASE, mesh_shape=(2, 2), grad_dtype=grad_dtype,
              hist_comms_slabs=2)
    fit = dict(eval_set=(Xv, yv), eval_metric="auc")
    fused = _run(pools, X, y, kw, fit)
    gran = _run(pools, X, y, kw, fit, loop="granular")
    _bitwise(fused[0]["ensemble"], gran[0]["ensemble"])
    scores = [[r["valid_auc"] for r in o["history"]] for o in fused + gran]
    assert all(s == scores[0] for s in scores)


def test_world_size_mismatch_names_the_mesh(pools, binary):
    X, y = binary
    with pytest.raises(RuntimeError, match="1 x 2 x 4 = 8 but the process "
                                           "group has 4 ranks"):
        pools(4).run(tasks.train, X, y, dict(BASE, mesh_shape=(2, 4)))


# ------------------------------------------------------------------ #
# config, layout and payload model (no ranks)
# ------------------------------------------------------------------ #

def test_mesh_shape_config_normalizes_and_conflicts():
    cfg = TrainConfig(mesh_shape=(4, 2))
    assert cfg.n_partitions == 4 and cfg.feature_partitions == 2
    assert cfg.mesh_shape is None
    assert cfg == TrainConfig(n_partitions=4, feature_partitions=2)
    assert cfg.replace(n_partitions=4) == cfg
    assert cfg.world_size == 8 and cfg.row_shards == 4
    TrainConfig(mesh_shape=(4, 2), n_partitions=4, feature_partitions=2)
    with pytest.raises(ValueError, match="conflicts"):
        TrainConfig(mesh_shape=(4, 2), n_partitions=2)
    with pytest.raises(ValueError, match="conflicts"):
        TrainConfig(mesh_shape=(4, 2), feature_partitions=4)
    with pytest.raises(ValueError, match="mesh_shape"):
        TrainConfig(mesh_shape=(4,))
    with pytest.raises(ValueError, match="mesh_shape"):
        TrainConfig(mesh_shape=(0, 2))
    for name in ("feature_partitions", "host_partitions"):
        with pytest.raises(ValueError, match=name):
            TrainConfig(**{name: 0})
    with pytest.raises(ValueError, match="hist_comms_slabs"):
        TrainConfig(hist_comms_slabs=-1)
    hosts = TrainConfig(host_partitions=2, n_partitions=2,
                        feature_partitions=2)
    assert hosts.row_shards == 4 and hosts.world_size == 8


def test_layout_rules():
    # hosts outermost, features innermost (make_mesh_2d's order)
    got = [mesh.coordinates(r, 2, 2) for r in range(8)]
    assert got == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                   (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
    assert [mesh.column_slab(9, 4, f) for f in range(4)] == \
        [(0, 3, 3), (3, 6, 3), (6, 9, 3), (9, 9, 3)]
    assert mesh.column_slab(10, 2, 1) == (5, 10, 5)
    assert comms.resolve_split_comms("auto", row_shards=1) == "allreduce"
    assert comms.resolve_split_comms("auto", row_shards=4) == \
        "reduce_scatter"
    assert comms.resolve_split_comms("reduce_scatter", row_shards=1) == \
        "allreduce"
    for dt in ("cuda", "cpu"):
        assert comms.resolve_comms_slabs(0, distributed=False,
                                         device_type=dt) == 1
        assert comms.resolve_comms_slabs(0, distributed=True,
                                         device_type=dt) == \
            comms.AUTO_COMMS_SLABS[dt]
        assert comms.resolve_comms_slabs(3, distributed=False,
                                         device_type=dt) == 3


@pytest.mark.parametrize("F,slabs,shards", [
    (10, 1, 2), (10, 4, 2), (1024, 4, 1), (1024, 4, 2), (5, 4, 2),
    (512, 4, 2), (9, 2, 4), (3, 8, 1)])
def test_slab_widths_equal_reference(F, slabs, shards):
    from ddt_tpu.ops.grow import _slab_widths

    assert grow.slab_widths(F, slabs, shards) == \
        _slab_widths(F, slabs, shards)


@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("subtraction", [False, True])
def test_payload_model_equals_reference(mode, dtype, subtraction):
    comms_dtype = "bf16" if dtype == "bf16" else "f32"
    grad_dtype = "int8" if dtype == "int8" else "f32"
    for pr, pf in [(1, 1), (2, 1), (1, 4), (2, 2), (4, 2), (2, 4), (3, 3)]:
        for F in (9, 28, 1024):
            kw = dict(partitions=pr, feature_partitions=pf, mode=mode,
                      subtraction=subtraction, comms_dtype=comms_dtype,
                      grad_dtype=grad_dtype)
            assert comms.hist_allreduce_bytes(6, F, 255, **kw) == \
                jcounters.hist_allreduce_bytes(6, F, 255, **kw)
            assert comms.hist_allreduce_bytes_by_level(4, F, 31, **kw) == \
                jcounters.hist_allreduce_bytes_by_level(4, F, 31, **kw)
    assert jcomms.COMMS_DTYPE_BYTES == comms.COMMS_DTYPE_BYTES


def test_config5_payloads():
    """The payload table at BASELINE config 5's width (depth 6, 1024
    features, 255 bins, subtraction): bytes a tree a rank."""
    def model(pr, pf, mode):
        return comms.hist_allreduce_bytes(
            6, 1024, 255, partitions=pr, feature_partitions=pf, mode=mode,
            subtraction=True)

    assert model(4, 1, "allreduce") == 66_847_232
    assert model(4, 1, "reduce_scatter") == 16_716_224
    assert model(2, 2, "reduce_scatter") == 16_716_224
    assert model(1, 4, "allreduce") == 16_716_224
    assert model(2, 2, "allreduce") == 33_425_888


@pytest.mark.parametrize("start,rows,F,B,seed", [
    (0, 1000, 1024, 255, 0), (123_456, 257, 16, 31, 3),
    (10 ** 9, 64, 8, 255, 7)])
def test_stress_chunk_equals_reference(start, rows, F, B, seed):
    got = stress_binned_chunk(start, rows, n_features=F, n_bins=B,
                              seed=seed)
    want = jdatasets.stress_binned_chunk(start, rows, n_features=F,
                                         n_bins=B, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
