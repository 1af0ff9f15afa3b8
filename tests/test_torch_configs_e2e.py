"""Five-config integration matrix of the port, the twin of
tests/test_configs_e2e.py: one miniature of each BASELINE config through
the port's CLI (`python -m ddt_tpu_torch.cli`, `--device cpu`: the
kernels' plain versions), each asserting its key invariant.

  1. Higgs binary, depth 6, 255 bins      -> test_config1_higgs
  2. Covertype 7 classes, depth 8         -> test_config2_covertype
  3. Criteo CTR, one-vs-rest categorical,
     row partitions                        -> test_config3_criteo
  4. a 1000-tree ensemble, batch scoring   -> test_config4_scoring
  5. wide streamed stress over shards,
     row partitions                        -> test_config5_stream

Each miniature is also run through the reference's CLI (`ddt_tpu.cli`)
on the same arguments, on its CPU backend (its device backend on
JAX-CPU for int8, which the CPU backend refuses), and the port is held
to it at the reference's own tolerances (tests/test_configs_e2e.py
config 3): the same tree structure bit for bit, leaves to rtol 2e-4 /
atol 2e-5 (the port's exact int64 sums and the reference's f32 sums part
by f32 rounding; bitwise in int8, where both sum exactly), the train
loss to rtol 1e-5, and the reference's scorer on the port's model to
rtol 2e-4 / atol 2e-5 of the port's scores.

Sizes are the reference's miniatures, cut further where the plain
versions on the CPU would dominate the suite's time (config 4 scores
5,000 rows, not 100,000). Runs over several ranks are gloo ranks of
parallel/spawn, each calling the CLI (parallel/tasks.cli).
"""

import json

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.cli import main as jmain
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch import api
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.data import chunks as chunks_mod
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.parallel import spawn, tasks
from tree_compare import assert_trees_match_mod_ties


@pytest.fixture(scope="module")
def pool():
    p = spawn.Pool(2, backend="gloo", device="cpu", timeout_s=120.0)
    yield p
    p.close()


def _run(capsys, argv, cli=main):
    capsys.readouterr()
    assert cli(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _ref_run(capsys, argv, backend="cpu"):
    """The reference's CLI on the same arguments, on `backend`."""
    return _run(capsys, [*argv, f"--backend={backend}"], cli=jmain)


def _assert_like_reference(port, ref, exact_leaves=False):
    """The reference's tolerance (module docstring)."""
    for k in ("feature", "threshold_bin", "is_leaf"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                      err_msg=k)
    if exact_leaves:
        np.testing.assert_array_equal(port.leaf_value, ref.leaf_value)
    else:
        np.testing.assert_allclose(port.leaf_value, ref.leaf_value,
                                   rtol=2e-4, atol=2e-5)


def _ref_scores(capsys, argv, out):
    """The reference's `cli predict` of the same arguments (the port's
    model), its scores."""
    _ref_run(capsys, [*argv, f"--out={out}"])
    return np.load(out)


def _auc(scores, y):
    order = np.argsort(scores)
    ranks = np.empty(len(y))
    ranks[order] = np.arange(1, len(y) + 1)
    pos = y > 0.5
    n1, n0 = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


def test_config1_higgs(tmp_path, capsys):
    """Config 1: Higgs-shape binary at depth 6 and 255 bins, CLI train
    then predict; the scores separate the classes."""
    model = str(tmp_path / "higgs.npz")
    train = ["train", "--dataset=higgs", "--rows=20000", "--trees=10",
             "--depth=6", "--bins=255"]
    rec = _run(capsys, [*train, "--device=cpu", f"--out={model}"])
    assert rec["trees"] == 10 and rec["depth"] == 6
    assert rec["final_train_loss"] < 0.60
    jmodel = str(tmp_path / "higgs_ref.npz")
    jrec = _ref_run(capsys, [*train, f"--out={jmodel}"])
    _assert_like_reference(TreeEnsemble.load(model), JEnsemble.load(jmodel))
    np.testing.assert_allclose(rec["final_train_loss"],
                               jrec["final_train_loss"], rtol=1e-5)
    scores = str(tmp_path / "s.npy")
    predict = ["predict", f"--model={model}", "--dataset=higgs",
               "--rows=4000", "--bins=255"]
    _run(capsys, [*predict, "--device=cpu", f"--out={scores}"])
    s = np.load(scores)
    np.testing.assert_allclose(
        s, _ref_scores(capsys, predict, str(tmp_path / "s_ref.npy")),
        rtol=2e-4, atol=2e-5)
    assert s.shape == (4000,) and (0 <= s).all() and (s <= 1).all()
    _, y = datasets.synthetic_binary(4000, seed=0)
    assert _auc(s, y) > 0.70


def test_config2_covertype(tmp_path, capsys):
    """Config 2: 7-class softmax (one tree a class a round) at depth 8."""
    model = str(tmp_path / "cov.npz")
    train = ["train", "--dataset=covertype", "--rows=8000", "--trees=4",
             "--depth=8", "--bins=63"]
    rec = _run(capsys, [*train, "--device=cpu", f"--out={model}"])
    ens = TreeEnsemble.load(model)
    assert ens.loss == "softmax" and ens.n_classes == 7
    assert ens.n_trees == 4 * 7
    assert rec["final_train_loss"] < np.log(7)
    jmodel = str(tmp_path / "cov_ref.npz")
    jrec = _ref_run(capsys, [*train, f"--out={jmodel}"])
    _assert_like_reference(ens, JEnsemble.load(jmodel))
    np.testing.assert_allclose(rec["final_train_loss"],
                               jrec["final_train_loss"], rtol=1e-5)
    scores = str(tmp_path / "cs.npy")
    predict = ["predict", f"--model={model}", "--dataset=covertype",
               "--rows=2000", "--bins=63"]
    _run(capsys, [*predict, "--device=cpu", f"--out={scores}"])
    p = np.load(scores)
    np.testing.assert_allclose(
        p, _ref_scores(capsys, predict, str(tmp_path / "cs_ref.npy")),
        rtol=2e-4, atol=2e-5)
    assert p.shape == (2000, 7)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)


def test_config3_criteo(pool, tmp_path, capsys):
    """Config 3: Criteo-shaped rows with one-vs-rest categorical splits;
    two row partitions (gloo ranks running the CLI) grow the
    one-partition run's trees, bitwise in int8 (exact sums) and but for
    proven ties in f32 (its wire sums f32); the one-partition run is the
    reference's (its device backend on JAX-CPU in int8, bitwise)."""
    common = ["train", "--dataset=criteo", "--rows=8000", "--trees=4",
              "--depth=5", "--bins=100", "--cat-splits=onehot"]
    for dt in ("int8", "f32"):
        m2 = str(tmp_path / f"c2_{dt}.npz")
        m1 = str(tmp_path / f"c1_{dt}.npz")
        pool.run(tasks.cli, [*common, f"--grad-dtype={dt}",
                             "--partitions=2", f"--out={m2}"])
        _run(capsys, [*common, f"--grad-dtype={dt}", "--device=cpu",
                      f"--out={m1}"])
        e2, e1 = TreeEnsemble.load(m2), TreeEnsemble.load(m1)
        assert e2.has_cat_splits
        mj = str(tmp_path / f"cj_{dt}.npz")
        _ref_run(capsys, [*common, f"--grad-dtype={dt}", f"--out={mj}"],
                 backend="tpu" if dt == "int8" else "cpu")
        _assert_like_reference(e1, JEnsemble.load(mj),
                               exact_leaves=dt == "int8")
        if dt == "int8":
            for k in ("feature", "threshold_bin", "is_leaf", "leaf_value"):
                np.testing.assert_array_equal(getattr(e2, k),
                                              getattr(e1, k), err_msg=k)
        else:
            assert_trees_match_mod_ties(e1, e2, 0.0)


def test_config4_scoring(tmp_path, capsys):
    """Config 4: a trained model tiled to 1000 trees scores a batch
    through `cli predict`; the NumPy scorer and the reference's `cli
    predict` agree, and the model is the reference's."""
    X, y = datasets.synthetic_binary(3000, n_features=12, seed=9)
    res = api.train(X, y, n_trees=10, max_depth=6, n_bins=63,
                    backend="cpu", log_every=10**9)
    jres = japi.train(X, y, n_trees=10, max_depth=6, n_bins=63,
                      backend="cpu", log_every=10**9)
    _assert_like_reference(res.ensemble, jres.ensemble)
    big = TreeEnsemble.concat([res.ensemble] * 100)
    assert big.n_trees == 1000
    model = str(tmp_path / "big.npz")
    api.save_model(model, big, mapper=res.mapper)
    Xs, _ = datasets.synthetic_binary(5_000, n_features=12, seed=10)
    data = str(tmp_path / "batch.npz")
    np.savez(data, X=Xs, y=np.zeros(len(Xs), np.float32))
    scores = str(tmp_path / "big_scores.npy")
    predict = ["predict", f"--model={model}", f"--data={data}"]
    rec = _run(capsys, [*predict, "--device=cpu", f"--out={scores}"])
    assert rec["rows"] == 5_000
    raw = big.predict_raw(res.mapper.transform(Xs), binned=True)
    with np.errstate(over="ignore"):
        want = 1.0 / (1.0 + np.exp(-raw))
    np.testing.assert_allclose(np.load(scores), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.load(scores),
        _ref_scores(capsys, predict, str(tmp_path / "big_ref.npy")),
        rtol=2e-4, atol=2e-5)


def test_config5_stream(pool, tmp_path, capsys):
    """Config 5: 256 binned features streamed from on-disk shards over two
    row partitions (gloo ranks running the CLI): the in-memory trees bit
    for bit (the streamed tables are exact) and the reference's streamed
    CLI run on the same shards, then out-of-core scoring over the same
    shards, which the reference's scorer repeats."""
    F, rows_per, n_chunks = 256, 4000, 4
    parts = [datasets.stress_binned_chunk(c, rows_per, n_features=F,
                                          seed=77) for c in range(n_chunks)]
    Xb = np.concatenate([p[0] for p in parts])
    y = np.concatenate([p[1] for p in parts])
    d = str(tmp_path / "shards")
    chunks_mod.shard_arrays(Xb, y, d, n_chunks=n_chunks)
    model = str(tmp_path / "stream.npz")
    pool.run(tasks.cli, ["train", "--partitions=2", "--trees=4",
                         "--depth=5", "--bins=255", f"--stream-dir={d}",
                         f"--out={model}"])
    ens = TreeEnsemble.load(model)
    assert ens.n_trees == 4
    full = api.train(Xb, y, n_trees=4, max_depth=5, n_bins=255,
                     device="cpu", binned=True, log_every=10**9).ensemble
    for k in ("feature", "threshold_bin", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(getattr(ens, k), getattr(full, k),
                                      err_msg=k)
    jmodel = str(tmp_path / "stream_ref.npz")
    _ref_run(capsys, ["train", "--trees=4", "--depth=5", "--bins=255",
                      f"--stream-dir={d}", f"--out={jmodel}"])
    _assert_like_reference(ens, JEnsemble.load(jmodel))
    sdir = str(tmp_path / "scores")
    predict = ["predict", f"--model={model}", f"--stream-dir={d}"]
    _run(capsys, [*predict, "--device=cpu", f"--out={sdir}"])

    def scores(at):
        return np.concatenate([np.load(f"{at}/scores_{c:05d}.npy")
                               for c in range(n_chunks)])

    got = scores(sdir)
    assert got.shape == (rows_per * n_chunks,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, full.predict(Xb, binned=True),
                               rtol=1e-5, atol=1e-6)
    jdir = str(tmp_path / "scores_ref")
    _ref_run(capsys, [*predict, f"--out={jdir}"])
    np.testing.assert_allclose(got, scores(jdir), rtol=2e-4, atol=2e-5)
