"""Driver: the host boosting loop over a DeviceBackend.

Port of the granular loop of ddt_tpu/driver.py (:578-634), the path the
reference's `_fit` takes whenever a backend has no fused `grow_rounds`.
Per round: gradients -> bagging mask (cfg.subsample < 1) -> grow one tree
(with the round's colsample mask when cfg.colsample_bytree < 1) -> add
its per-row delta to the boosting state -> copy the tree to the host (the
copy waits for the round's device work). Both masks are pure functions of
(cfg.seed, round) (ops/sampling); the bagging mask is drawn on the
gradients' device by the hash's tensor twin, bit for bit the reference's
row_keep_np, so no per-round mask crosses the bus. Telemetry,
checkpoints, eval sets and softmax are not ported yet.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ddt_tpu_torch.backends.base import DeviceBackend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.ops.grad import base_score_np

log = logging.getLogger("ddt_tpu_torch.driver")

#: Rounds between train-loss log lines (each reads the loss back from the
#: device, so it is taken only when INFO logging is on).
LOG_EVERY = 10


class Driver:
    """Boosting loop: `fit(Xb, y)` -> TreeEnsemble."""

    def __init__(self, backend: DeviceBackend, cfg: TrainConfig):
        self.backend = backend
        self.cfg = cfg

    def fit(self, Xb: np.ndarray, y: np.ndarray) -> TreeEnsemble:
        cfg = self.cfg
        Xb = np.asarray(Xb)
        y = np.asarray(y)
        if Xb.dtype != np.uint8 or Xb.ndim != 2:
            raise TypeError(f"Xb must be uint8 binned data [R, F], got "
                            f"{Xb.dtype} {Xb.shape}")
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
            tree = self.backend.fetch_tree(handle)
            for k in ("feature", "threshold_bin", "is_leaf", "leaf_value",
                      "split_gain", "default_left"):
                getattr(ens, k)[rnd] = tree[k]
            if (rnd + 1) % LOG_EVERY == 0 and log.isEnabledFor(logging.INFO):
                log.info("round %d/%d train_loss=%.6f (%.1f ms/round)",
                         rnd + 1, cfg.n_trees,
                         self.backend.loss_value(pred, y_dev),
                         1e3 * (time.perf_counter() - t0) / (rnd + 1))
        return ens
