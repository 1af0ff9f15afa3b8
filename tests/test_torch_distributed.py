"""Row-partitioned training in the port on P gloo ranks on the CPU
(P = 2, 4), against the reference's n_partitions=P run on JAX-CPU (the
conftest's 8 host devices) and against the port's own single device.

The ranks (one module-scoped pool per P, parallel/spawn.py) run
parallel/tasks.py: every rank calls api.train with the same full rows,
bins its block and grows the replicated trees. Held, as the reference's
tests/test_distributed.py and tests/test_comms.py hold its mesh:

- f32: structure identical to the reference's except at bf16 ties
  (tests/tree_compare.py), leaves within rtol 2e-4 / atol 2e-5; in both
  split_comms modes, rows that do not divide, softmax, bagging and
  colsample, missing_policy="learn", weights and the BASELINE config-3
  miniature (one-vs-rest splits chosen);
- int8: bitwise equal to the reference's and to the port's single-device
  trees;
- every rank's ensemble bitwise equal; fused equal to granular; the
  collectives' modeled bytes equal to the payload model a tree; the
  granular distributed histogram equal to the numpy oracle's on all rows;
- checkpoints on a mesh: written by global rank 0 alone, resumed on the
  same mesh or on one process with no group, bitwise (int8);
- the refusals: no group, a world-size mismatch, ranks that fitted other
  edges, ranks that would resume different checkpoints.
"""

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.reference import numpy_trainer as ref
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import categorical as tcat
from ddt_tpu_torch.data.datasets import (synthetic_binary, synthetic_ctr,
                                         synthetic_missing,
                                         synthetic_multiclass)
from ddt_tpu_torch.parallel import spawn, tasks
from tree_compare import assert_trees_match_mod_ties

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")
BASE = dict(n_trees=4, max_depth=4, n_bins=31, min_split_gain=1e-3)


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


def _run(pools, P, X, y, kw, fit_kw=None, loop="fused"):
    """The P ranks' results, after holding every rank's ensemble (and
    history, times aside) bitwise equal to rank 0's and the modeled bytes
    to the payload model a tree."""
    outs = pools(P).run(tasks.train, X, y, kw, fit_kw, loop)

    def hist(o):
        return [{k: v for k, v in r.items() if k != "ms"}
                for r in o["history"]]

    for o in outs[1:]:
        _bitwise(o["ensemble"], outs[0]["ensemble"])
        assert hist(o) == hist(outs[0])
    c = outs[0]["counters"]
    rounds = len(outs[0]["history"])
    C = kw.get("n_classes", 1) if kw.get("loss") == "softmax" else 1
    assert c["comms.modeled_bytes"] == rounds * C * outs[0]["bytes_model"]
    return outs


def _ref(X, y, kw, P, **fit_kw):
    return japi.train(X, y, JConfig(backend="tpu", n_partitions=P, **kw),
                      **fit_kw).ensemble


def _match(ref_ens, port_ens, kw):
    assert_trees_match_mod_ties(ref_ens, port_ens, kw["min_split_gain"],
                                leaf_rtol=2e-4, leaf_atol=2e-5)


def _bitwise(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


@pytest.fixture(scope="module")
def binary():
    return synthetic_binary(4096, n_features=10, seed=11)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("split_comms", ["allreduce", "reduce_scatter"])
def test_partitioned_equals_reference(pools, binary, P, split_comms):
    X, y = binary
    kw = dict(BASE, split_comms=split_comms)
    outs = _run(pools, P, X, y, kw)
    assert outs[0]["split_comms"] == split_comms
    port = outs[0]["ensemble"]
    _match(_ref(X, y, kw, P), port, kw)
    single = api.train(X, y, TrainConfig(device="cpu", **kw)).ensemble
    _match(single, port, kw)
    assert port.base_score == single.base_score


def test_rows_not_divisible(pools):
    X, y = synthetic_binary(4001, n_features=8, seed=5)
    outs = _run(pools, 4, X, y, BASE)
    _match(_ref(X, y, BASE, 4), outs[0]["ensemble"], BASE)


def test_softmax(pools):
    X, y = synthetic_multiclass(2000, n_features=12, seed=3)
    kw = dict(BASE, loss="softmax", n_classes=7)
    outs = _run(pools, 4, X, y, kw)
    assert outs[0]["ensemble"].n_trees == 4 * 7
    _match(_ref(X, y, kw, 4), outs[0]["ensemble"], kw)


def test_bagging_and_colsample(pools, binary):
    X, y = binary
    kw = dict(BASE, subsample=0.8, colsample_bytree=0.8, seed=3)
    outs = _run(pools, 4, X, y, kw)
    _match(_ref(X, y, kw, 4), outs[0]["ensemble"], kw)


def test_missing_learn(pools):
    X, y = synthetic_missing(3000, seed=3)
    kw = dict(BASE, missing_policy="learn")
    outs = _run(pools, 2, X, y, kw)
    port = outs[0]["ensemble"]
    assert port.default_left.any()
    _match(_ref(X, y, kw, 2), port, kw)


def test_weights(pools, binary):
    X, y = binary
    w = np.random.default_rng(2).integers(0, 4, len(y)).astype(np.float32)
    outs = _run(pools, 4, X, y, BASE, dict(sample_weight=w))
    _match(_ref(X, y, BASE, 4, sample_weight=w), outs[0]["ensemble"], BASE)


def test_config3_miniature(pools):
    """BASELINE config 3 at the reference's e2e miniature
    (tests/test_configs_e2e.py:95): Criteo-shaped rows, 4 partitions,
    one-vs-rest categorical splits."""
    Xn, Xc, y = synthetic_ctr(8000, seed=0)
    enc = tcat.fit_categorical_encoder(Xc, n_bins=100)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    kw = dict(n_trees=4, max_depth=5, n_bins=100, cat_features=cat,
              min_split_gain=1e-3)
    outs = _run(pools, 4, X, y, kw)
    port = outs[0]["ensemble"]
    used = port.feature[~port.is_leaf & (port.feature >= 0)]
    assert np.isin(used, cat).any()
    _match(_ref(X, y, kw, 4), port, kw)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("split_comms", ["allreduce", "reduce_scatter"])
def test_int8_bitwise(pools, P, split_comms):
    X, y = synthetic_binary(4001, n_features=8, seed=7)
    kw = dict(BASE, grad_dtype="int8", subsample=0.8, seed=5,
              split_comms=split_comms)
    port = _run(pools, P, X, y, kw)[0]["ensemble"]
    _bitwise(port, _ref(X, y, kw, P))
    _bitwise(port, api.train(X, y, TrainConfig(device="cpu",
                                               **kw)).ensemble)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_fused_equals_granular(pools, binary, grad_dtype):
    X, y = binary
    Xv, yv = synthetic_binary(500, n_features=10, seed=12)
    kw = dict(BASE, n_trees=6, grad_dtype=grad_dtype, subsample=0.9)
    fit = dict(eval_set=(Xv, yv), eval_metric="auc")
    fused = _run(pools, 2, X, y, kw, fit)
    gran = _run(pools, 2, X, y, kw, fit, loop="granular")
    _bitwise(fused[0]["ensemble"], gran[0]["ensemble"])
    scores = [[r["valid_auc"] for r in o["history"]] for o in fused + gran]
    assert all(s == scores[0] for s in scores)
    # The eval set is scored whole on every rank: the single device's
    # metric on the same trees.
    single = api.train(X, y, TrainConfig(device="cpu", **kw), **fit)
    if grad_dtype == "int8":
        assert [r["valid_auc"] for r in single.history] == scores[0]


def test_early_stopping_replicated(pools, binary):
    X, y = binary
    Xv, yv = synthetic_binary(500, n_features=10, seed=13)
    kw = dict(BASE, n_trees=30, max_depth=3, grad_dtype="int8",
              learning_rate=0.5)
    fit = dict(eval_set=(Xv, yv), eval_metric="logloss",
               early_stopping_rounds=2)
    outs = _run(pools, 2, X, y, kw, fit)
    single = api.train(X, y, TrainConfig(device="cpu", **kw), **fit)
    assert [o["best_round"] for o in outs] == [single.best_round] * 2
    _bitwise(outs[0]["ensemble"], single.ensemble)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("grad", ["f32", "int8"])
def test_granular_histogram_is_global(pools, P, grad):
    rng = np.random.default_rng(P)
    R, F, B, n = 1001, 6, 16, 4
    Xb = rng.integers(0, B, (R, F)).astype(np.uint8)
    ni = rng.integers(-1, n, R).astype(np.int32)
    if grad == "int8":
        g = rng.integers(-127, 128, R).astype(np.int8)
        h = rng.integers(0, 128, R).astype(np.int8)
    else:
        g = rng.standard_normal(R).astype(np.float32)
        h = rng.random(R).astype(np.float32)
    outs = pools(P).run(tasks.granular_hist, Xb, g, h, ni, n,
                        dict(n_bins=B))
    want = ref.build_histograms(Xb, g.astype(np.float32),
                                h.astype(np.float32), ni, n, B)
    for got in outs:
        if grad == "int8":
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want.astype(np.int32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got, outs[0])


def test_no_group_refuses_partitions(binary):
    X, y = binary
    with pytest.raises(ValueError, match="process group"):
        api.train(X, y, TrainConfig(device="cpu", n_partitions=2, **BASE))


@pytest.mark.parametrize("n_partitions", [1, 4])
def test_world_size_mismatch_refused(pools, binary, n_partitions):
    X, y = binary
    with pytest.raises(RuntimeError,
                       match=f"n_partitions={n_partitions} but the process "
                             "group has 2 ranks"):
        pools(2).run(tasks.train, X, y,
                     dict(BASE, n_partitions=n_partitions))


def test_ranks_that_disagree_are_refused(pools, binary):
    X, y = binary
    with pytest.raises(RuntimeError, match="ranks disagree"):
        pools(2).run(tasks.train_shifted, X, y, BASE, 1e-3)


@pytest.mark.parametrize("P", [1, 2])
def test_scoring_backend_cached_on_a_rank(pools, P):
    """A rank's scoring backend (n_partitions=1, no group bound) comes
    from the cache, so its compiled-model tables survive between
    api.predict calls; a backend that binds the group (n_partitions the
    world size, P = 1 included) is built anew."""
    outs = pools(P).run(tasks.backend_reuse, BASE)
    assert outs == [(P > 1, True)] * P


def _mesh_kw(n_trees):
    return dict(BASE, n_trees=n_trees, grad_dtype="int8", subsample=0.9)


def test_checkpoint_resume_on_the_same_mesh(pools, binary, tmp_path):
    """(2, 2), int8: stopped after 3 of 6 rounds and resumed on the same
    mesh, bitwise the uninterrupted run and the single device's."""
    X, y = binary
    mesh_kw = dict(_mesh_kw(6), mesh_shape=(2, 2))
    whole = _run(pools, 4, X, y, mesh_kw)[0]["ensemble"]
    _bitwise(whole, api.train(X, y, TrainConfig(device="cpu",
                                                **_mesh_kw(6))).ensemble)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    _run(pools, 4, X, y, dict(mesh_kw, n_trees=3), ck)
    resumed = _run(pools, 4, X, y, mesh_kw, ck)[0]
    assert len(resumed["history"]) == 3
    _bitwise(resumed["ensemble"], whole)


@pytest.mark.parametrize("layout", [dict(mesh_shape=(2, 2)),
                                    dict(host_partitions=2, n_partitions=2)],
                         ids=["2x2", "2hx2"])
def test_checkpoint_of_a_mesh_resumes_on_one_process(pools, binary, tmp_path,
                                                     layout):
    """A 4-rank checkpoint resumes with no group at all (the layout is not
    in the fingerprint), bitwise the uninterrupted single-device run."""
    X, y = binary
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    _run(pools, 4, X, y, dict(_mesh_kw(3), **layout), ck)
    cfg = TrainConfig(device="cpu", **_mesh_kw(6))
    resumed = api.train(X, y, cfg, **ck)
    assert len(resumed.history) == 3
    _bitwise(resumed.ensemble, api.train(X, y, cfg).ensemble)


def test_checkpoint_written_by_rank_0_read_by_every_rank(pools, binary,
                                                         tmp_path):
    """Global rank 0 alone writes; every rank resumes the same round;
    ranks that would resume different checkpoints are refused."""
    X, y = binary
    kw = dict(_mesh_kw(4), mesh_shape=(2, 2))
    ck = dict(checkpoint_dir=str(tmp_path / "shared"), checkpoint_every=2)
    outs = pools(4).run(tasks.train_saves, X, y, dict(kw, n_trees=2), ck)
    assert [o["saves"] for o in outs] == [[2], [], [], []]
    outs = pools(4).run(tasks.train_saves, X, y, kw, ck)
    assert [o["saves"] for o in outs] == [[4], [], [], []]
    assert [len(o["history"]) for o in outs] == [2] * 4
    api.train(X, y, TrainConfig(device="cpu", **_mesh_kw(2)),
              checkpoint_dir=str(tmp_path / "own" / "rank0"),
              checkpoint_every=1)
    with pytest.raises(RuntimeError, match="resumed different checkpoints"):
        pools(4).run(tasks.train_own_dir, X, y, kw, str(tmp_path / "own"))


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_world_of_one_equals_no_group_and_resumes(pools, binary, tmp_path,
                                                  grad_dtype):
    """One rank in a group runs every collective (the card's one-card
    run of chip_smoke's multi phase) and grows the no-group trees bit for
    bit; its checkpoints resume (n_partitions=1)."""
    X, y = binary
    kw = dict(BASE, n_trees=6, grad_dtype=grad_dtype)
    whole = _run(pools, 1, X, y, kw)[0]
    assert whole["counters"]["comms.calls"] > 0
    _bitwise(whole["ensemble"],
             api.train(X, y, TrainConfig(device="cpu", **kw)).ensemble)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    _run(pools, 1, X, y, dict(kw, n_trees=3), ck)
    resumed = _run(pools, 1, X, y, kw, ck)[0]
    assert len(resumed["history"]) == 3
    _bitwise(resumed["ensemble"], whole["ensemble"])
