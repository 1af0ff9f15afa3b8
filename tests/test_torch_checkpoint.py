"""Checkpoint and resume in the port (utils/checkpoint, Driver), on the CPU.

A run stopped at a checkpoint and resumed equals the uninterrupted run
bit for bit here: resume rebuilds pred and the eval margins with
TreeEnsemble.predict_raw_roundwise, the fit loop's own f32 order, and
every later round then computes what it computed before (fused and
granular, f32 and int8, binary and softmax, with an eval set). The
hardening mirrors the reference's tests/test_checkpoint.py and
tests/test_robustness.py checkpoint cases: the sha256 pair digest, a torn
pair falls back to the newest valid history pair, corrupt everything
starts afresh, keep-last-3 history, and a valid checkpoint of an
incompatible config raises. The ensemble file loads in ddt_tpu.
"""

import json
import os

import numpy as np
import pytest

from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary, synthetic_multiclass
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.utils import checkpoint

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


class Granular(CUDADevice):
    grow_rounds = None


def _data(loss, R=1500):
    if loss == "softmax":
        X, y = synthetic_multiclass(R, n_features=8, n_classes=3, seed=4)
    else:
        X, y = synthetic_binary(R, n_features=8, seed=4)
    Xb, _ = quantize(X, n_bins=31)
    return Xb, y


def _driver(cfg, fused, **kw):
    return Driver(get_backend(cfg) if fused else Granular(cfg), cfg, **kw)


def _same(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "granular"])
@pytest.mark.parametrize("case", ["logloss-f32", "logloss-int8",
                                  "softmax-f32", "softmax-int8"])
def test_resumed_equals_uninterrupted_bitwise(tmp_path, case, fused):
    loss, grad_dtype = case.split("-")
    Xb, y = _data(loss)
    cfg = TrainConfig(n_trees=8, max_depth=3, n_bins=31, device="cpu",
                      loss=loss, n_classes=3, grad_dtype=grad_dtype,
                      subsample=0.8, colsample_bytree=0.7, seed=2,
                      fused_block_rounds=3)
    ev = dict(eval_set=(Xb[1200:], y[1200:]))
    whole = _driver(cfg, fused)
    full = whole.fit(Xb[:1200], y[:1200], **ev)
    ck = str(tmp_path / "ck")
    first = cfg.replace(n_trees=5)
    _driver(first, fused, checkpoint_dir=ck, checkpoint_every=2).fit(
        Xb[:1200], y[:1200], **ev)
    assert json.load(open(os.path.join(ck, "cursor.json")))[
        "completed_rounds"] == 5
    again = _driver(cfg, fused, checkpoint_dir=ck, checkpoint_every=2)
    resumed = again.fit(Xb[:1200], y[:1200], **ev)
    _same(full, resumed)
    # The resumed rounds' eval scores are the uninterrupted run's.
    assert [r["valid_logloss"] for r in again.history] == \
        [r["valid_logloss"] for r in whole.history[5:]]


def test_resume_in_the_other_loop_and_block_size(tmp_path):
    """Checkpoints written by the granular loop resume in the fused one
    (and at another block size, which the fingerprint leaves out)."""
    Xb, y = _data("logloss")
    cfg = TrainConfig(n_trees=7, max_depth=3, n_bins=31, device="cpu",
                      grad_dtype="int8")
    full = _driver(cfg, True).fit(Xb, y)
    ck = str(tmp_path / "ck")
    _driver(cfg.replace(n_trees=4), False, checkpoint_dir=ck,
            checkpoint_every=4).fit(Xb, y)
    other = cfg.replace(fused_block_rounds=2)
    _same(full, _driver(other, True, checkpoint_dir=ck).fit(Xb, y))


def test_checkpoint_cadence_history_and_cross_load(tmp_path):
    Xb, y = _data("logloss")
    cfg = TrainConfig(n_trees=11, max_depth=3, n_bins=31, device="cpu",
                      fused_block_rounds=4)
    ck = str(tmp_path / "ck")
    ens = _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=2).fit(
        Xb, y)
    hist = sorted(d for d in os.listdir(ck) if d.startswith("ckpt-"))
    assert hist == ["ckpt-000008", "ckpt-000010", "ckpt-000011"]
    cur = json.load(open(os.path.join(ck, "cursor.json")))
    assert cur["completed_rounds"] == 11
    assert cur["ensemble_digest"] == checkpoint._sha256_file(
        os.path.join(ck, "ensemble.npz"))
    ref = JEnsemble.load(os.path.join(ck, "ensemble.npz"))
    np.testing.assert_array_equal(ref.feature, ens.feature)
    np.testing.assert_array_equal(ref.leaf_value, ens.leaf_value)


def _fresh(cfg, F):
    return empty_ensemble(cfg.n_trees, cfg.max_depth, F, cfg.learning_rate,
                          0.0, cfg.loss, n_bins=cfg.n_bins)


def test_torn_pair_falls_back_to_history(tmp_path):
    Xb, y = _data("logloss")
    cfg = TrainConfig(n_trees=6, max_depth=3, n_bins=31, device="cpu")
    ck = str(tmp_path / "ck")
    saved = _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=2).fit(
        Xb, y)
    # A crash between the two replaces: a new ensemble file (a new inode,
    # as os.replace lands it) beside a stale cursor. The digest catches
    # it; resume takes ckpt-000006's pair, which still holds the old one.
    tmp = os.path.join(ck, "torn.npz")
    with open(tmp, "wb") as f:
        f.write(b"torn")
    os.replace(tmp, os.path.join(ck, "ensemble.npz"))
    ens = _fresh(cfg, Xb.shape[1])
    assert checkpoint.try_resume(ck, ens, cfg) == 6
    _same(saved, ens)
    # Bit rot in place also hits the linked history entry: one save older.
    with open(os.path.join(ck, "ckpt-000006", "ensemble.npz"), "r+b") as f:
        f.write(b"rot")
    assert checkpoint.try_resume(ck, _fresh(cfg, Xb.shape[1]), cfg) == 4
    # Every pair corrupt: start afresh, never crash.
    for d in [ck] + [os.path.join(ck, n) for n in os.listdir(ck)
                     if n.startswith("ckpt-")]:
        with open(os.path.join(d, "cursor.json"), "w") as f:
            f.write("{trunc")
    assert checkpoint.try_resume(ck, _fresh(cfg, Xb.shape[1]), cfg) == 0


def test_missing_half_of_a_pair_falls_back(tmp_path):
    Xb, y = _data("logloss")
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=31, device="cpu")
    ck = str(tmp_path / "ck")
    _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=2).fit(Xb, y)
    os.remove(os.path.join(ck, "cursor.json"))
    assert checkpoint.try_resume(ck, _fresh(cfg, Xb.shape[1]), cfg) == 4
    assert checkpoint.try_resume(str(tmp_path / "none"),
                                 _fresh(cfg, Xb.shape[1]), cfg) == 0


@pytest.mark.parametrize("change", [dict(max_depth=4),
                                    dict(learning_rate=0.2),
                                    dict(grad_dtype="int8"),
                                    dict(loss="mse")])
def test_incompatible_config_raises(tmp_path, change):
    Xb, y = _data("logloss")
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=31, device="cpu")
    ck = str(tmp_path / "ck")
    _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=2).fit(Xb, y)
    other = cfg.replace(**change)
    with pytest.raises(ValueError, match="incompatible"):
        _driver(other, True, checkpoint_dir=ck).fit(Xb, y)


def test_fingerprint_leaves_out_system_fields(tmp_path):
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=31, device="cpu")
    fp = checkpoint.cfg_fingerprint(cfg)
    for k in ("n_trees", "device", "fused_block_rounds", "predict_impl"):
        assert k not in fp
    assert fp == checkpoint.cfg_fingerprint(cfg.replace(
        n_trees=9, fused_block_rounds=3, device="cuda"))
    assert json.loads(json.dumps(fp)) == fp
    Xb, y = _data("logloss")
    ck = str(tmp_path / "ck")
    _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=2).fit(Xb, y)
    with pytest.raises(ValueError, match="raise n_trees"):
        checkpoint.try_resume(ck, _fresh(cfg.replace(n_trees=2),
                                         Xb.shape[1]),
                              cfg.replace(n_trees=2))
    with pytest.raises(ValueError, match="checkpoint_every"):
        Driver(get_backend(cfg), cfg, checkpoint_dir=ck, checkpoint_every=0)


def test_early_stop_saves_the_truncated_model(tmp_path):
    rng = np.random.default_rng(5)
    Xb = rng.integers(0, 31, (600, 5)).astype(np.uint8)
    y = (rng.random(600) < 0.5).astype(np.int64)         # noise labels
    cfg = TrainConfig(n_trees=40, max_depth=3, n_bins=31, device="cpu")
    ck = str(tmp_path / "ck")
    d = _driver(cfg, True, checkpoint_dir=ck, checkpoint_every=5)
    ens = d.fit(Xb[:400], y[:400], eval_set=(Xb[400:], y[400:]),
                early_stopping_rounds=3)
    assert ens.n_trees == d.best_round + 1 < 40
    cur = json.load(open(os.path.join(ck, "cursor.json")))
    assert cur["completed_rounds"] == d.best_round + 1
