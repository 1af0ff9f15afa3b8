"""Faults planted in the program under test, to show that a run's check
catches them (benchmark/tests and benchmark/calibrate.py; a benchmark
run never plants one). Each is a context manager that patches the
program's modules for its duration:

  state_unchanged  every round after the first leaves the model as it
                   was: its trees come back with zero leaves;
  half_rows        half of the rows left out: a job trains on the first
                   half (a batch is scored on its first half, the rest
                   left at 0);
  no_exchange      the histogram exchange between ranks left out: each
                   rank splits on its own rows' histograms;
  answer_altered   an answer altered where it is produced: one leaf of
                   one tree of each trained model changes sign (one
                   row in a hundred of each scored batch is flipped).
"""

from __future__ import annotations

import contextlib

import numpy as np

import ddt_tpu_torch.api as api
from ddt_tpu_torch import driver
from ddt_tpu_torch.parallel import comms


@contextlib.contextmanager
def _patched(obj, name: str, new):
    old = getattr(obj, name)
    setattr(obj, name, new(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _store_unchanged(old):
    def store(self, ens, slot, tree):
        old(self, ens, slot, tree)
        if slot >= self.cfg.n_outputs:
            ens.leaf_value[slot] = 0.0
    return store


def _train_half(old):
    def train(X, y, cfg=None, **kw):
        n = X.shape[0] // 2
        kw.pop("mapper", None)
        return old(X[:n], np.asarray(y)[:n], cfg, **kw)
    return train


def _predict_half(old):
    def predict(ens, X, **kw):
        n = X.shape[0] // 2
        out = np.zeros(X.shape[0], np.float32)
        out[:n] = old(ens, X[:n], **kw)
        return out
    return predict


def _hist_local(old):
    def hist_reduce(hist, group, *, mode="allreduce", comms_dtype="f32",
                    scatter_dim=1, async_op=False):
        out = hist
        if mode == "reduce_scatter":
            w = hist.shape[scatter_dim] // comms.world(group)
            out = hist.narrow(scatter_dim, comms.rank(group) * w, w)
        out = out.contiguous().clone()
        return comms.Pending(out) if async_op else out
    return hist_reduce


def _train_altered(old):
    def train(X, y, cfg=None, **kw):
        res = old(X, y, cfg, **kw)
        ens = res.ensemble
        rng = np.random.default_rng(ens.n_trees)
        t = int(rng.integers(ens.n_trees))
        leaves = np.flatnonzero(ens.is_leaf[t] & (ens.leaf_value[t] != 0))
        if leaves.size:
            ens.leaf_value[t, leaves[0]] *= -1.0
        return res
    return train


def _predict_altered(old):
    def predict(ens, X, **kw):
        out = old(ens, X, **kw)
        out[::100] = 1.0 - out[::100]
        return out
    return predict


def plant(name: str, kind: str):
    """The fault `name` for a loop of `kind` ("train_jobs" or
    "score_batches")."""
    train = kind == "train_jobs"
    if name == "state_unchanged" and train:
        return _patched(driver.Driver, "_store", _store_unchanged)
    if name == "half_rows":
        return _patched(api, "train" if train else "predict",
                        _train_half if train else _predict_half)
    if name == "no_exchange" and train:
        return _patched(comms, "hist_reduce", _hist_local)
    if name == "answer_altered":
        return _patched(api, "train" if train else "predict",
                        _train_altered if train else _predict_altered)
    raise ValueError(f"no fault {name!r} for {kind}")
