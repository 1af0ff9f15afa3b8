"""Driver: the host boosting loop over a DeviceBackend.

Port of ddt_tpu/driver.py's two loops. `fit` takes the fused block loop
(`_fit_fused`, driver.py:815-900) whenever the backend has `grow_rounds`,
as the reference does, and the granular loop (`_fit_granular`,
driver.py:578-634) otherwise; the tests also call the granular loop
directly, as the fused loop's yardstick.

Granular, per round: gradients -> bagging mask (cfg.subsample < 1) ->
grow one tree (with the round's colsample mask when cfg.colsample_bytree
< 1) -> add its per-row delta to the boosting state -> copy the tree to
the host (the copy waits for the round's device work).

Fused, per block of min(n_trees - rnd, cfg.fused_block_rounds) rounds:
the block's colsample masks are drawn on the host, as the granular loop
draws them, and handed over as [K, F]; the backend runs the K rounds on
the device (on the card, replays of one captured round) and the block's
trees and per-round losses come back in one fetch.

Both masks are pure functions of (cfg.seed, round) (ops/sampling); the
bagging mask is drawn on the gradients' device by the hash's tensor twin,
bit for bit the reference's row_keep_np, so no per-round mask crosses the
bus. Telemetry, checkpoints, eval sets and softmax are not ported yet.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ddt_tpu_torch.backends.base import (PACKED_FIELDS, DeviceBackend,
                                         unpack_tree)
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.ops.grad import base_score_np

log = logging.getLogger("ddt_tpu_torch.driver")

#: Rounds between train-loss log lines (the granular loop reads the loss
#: back from the device for them, so only when INFO logging is on).
LOG_EVERY = 10


class Driver:
    """Boosting loop: `fit(Xb, y)` -> TreeEnsemble."""

    def __init__(self, backend: DeviceBackend, cfg: TrainConfig):
        self.backend = backend
        self.cfg = cfg

    def fit(self, Xb, y: np.ndarray) -> TreeEnsemble:
        """Train on binned uint8 rows [R, F]: a host array, or a tensor
        (binned on the device by api.train, say), which the backend takes
        where it lies."""
        cfg = self.cfg
        if not isinstance(Xb, torch.Tensor):
            Xb = np.asarray(Xb)
        y = np.asarray(y)
        if Xb.dtype not in (np.uint8, torch.uint8) or Xb.ndim != 2:
            raise TypeError(f"Xb must be uint8 binned data [R, F], got "
                            f"{Xb.dtype} {tuple(Xb.shape)}")
        R, F = Xb.shape
        if y.shape != (R,):
            raise ValueError(f"y must be [R]={R}, got {y.shape}")
        bs = base_score_np(y, cfg.loss)

        data = self.backend.upload(Xb)
        y_dev = self.backend.upload_labels(y)
        pred = self.backend.init_pred(y_dev, bs)
        ens = empty_ensemble(cfg.n_trees, cfg.max_depth, F,
                             cfg.learning_rate, bs, cfg.loss,
                             n_bins=cfg.n_bins)
        if getattr(self.backend, "grow_rounds", None) is not None:
            return self._fit_fused(data, y_dev, pred, ens)
        return self._fit_granular(data, y_dev, pred, ens)

    def _store(self, ens: TreeEnsemble, rnd: int, tree) -> None:
        for k in PACKED_FIELDS:
            getattr(ens, k)[rnd] = tree[k]

    def _fit_granular(self, data, y_dev, pred,
                      ens: TreeEnsemble) -> TreeEnsemble:
        cfg = self.cfg
        R, F = data.shape
        t0 = time.perf_counter()
        for rnd in range(cfg.n_trees):
            g, h = self.backend.grad_hess(pred, y_dev)
            if cfg.subsample < 1.0:
                keep = sampling.row_keep(cfg.seed, rnd, 0, R, cfg.subsample,
                                         device=g.device)
                g, h = self.backend.apply_row_mask(g, h, keep)
            fmask = (sampling.colsample_mask(cfg.seed, rnd, 0, F,
                                             cfg.colsample_bytree)
                     if cfg.colsample_bytree < 1.0 else None)
            # One output column, so the absolute tree id rnd * C + c is rnd.
            handle, delta = self.backend.grow_tree(
                data, g, h, feature_mask=fmask, tree_id=rnd)
            pred = self.backend.apply_delta(pred, delta, 0)
            self._store(ens, rnd, self.backend.fetch_tree(handle))
            if (rnd + 1) % LOG_EVERY == 0 and log.isEnabledFor(logging.INFO):
                log.info("round %d/%d train_loss=%.6f (%.1f ms/round)",
                         rnd + 1, cfg.n_trees,
                         self.backend.loss_value(pred, y_dev),
                         1e3 * (time.perf_counter() - t0) / (rnd + 1))
        return ens

    def _fit_fused(self, data, y_dev, pred,
                   ens: TreeEnsemble) -> TreeEnsemble:
        """Block loop over backend.grow_rounds: K rounds a call, one fetch
        of their trees and losses. Without checkpoints, eval or early
        stopping, which are not ported yet."""
        cfg = self.cfg
        F = data.shape[1]
        rnd = 0
        while rnd < cfg.n_trees:
            K = min(cfg.n_trees - rnd, cfg.fused_block_rounds)
            t0 = time.perf_counter()
            if cfg.colsample_bytree < 1.0:
                fmasks = np.stack([
                    sampling.colsample_mask(cfg.seed, rnd + k, 0, F,
                                            cfg.colsample_bytree)
                    for k in range(K)])
                trees_h, pred, losses_h = self.backend.grow_rounds_masked(
                    data, pred, y_dev, K, fmasks, first_round=rnd)
            else:
                trees_h, pred, losses_h = self.backend.grow_rounds(
                    data, pred, y_dev, K, first_round=rnd)
            trees, losses = self.backend.fetch_rounds(trees_h, losses_h)
            dt = time.perf_counter() - t0
            for k in range(K):
                r = rnd + k
                self._store(ens, r, unpack_tree(trees[k]))
                if (r + 1) % LOG_EVERY == 0:
                    log.info("round %d/%d train_loss=%.6f (%.1f ms/round)",
                             r + 1, cfg.n_trees, float(losses[k]),
                             1e3 * dt / K)
            rnd += K
        return ens
