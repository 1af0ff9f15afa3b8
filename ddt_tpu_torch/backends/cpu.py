"""CPUDevice: the NumPy / native C++ oracle behind the port's
DeviceBackend (port of ddt_tpu/backends/cpu.py), selected by
TrainConfig(backend="cpu").

The reference pairs its device kernels with a CPU reference and states
its goal against it (BASELINE: ">=5x the repo's CPU-reference histogram
throughput"). This backend wraps the oracle trainer
(reference/numpy_trainer.py) behind the contract the port's Driver
trains through, so:

- the backend-parity tests drive the oracle and CUDADevice through the
  same Driver (tests/test_torch_backends.py), and
- a benchmark measures the baseline's Mrows/s on the same contract as
  the card (chip_smoke.py's `baseline` phase).

The histogram, split-gain and traversal steps take the native C++
kernels (native/, built at first use) when they build, the oracle's
NumPy kernels otherwise; `hist_impl` records which ran ("native" or
"numpy"). `use_native=True` raises when the library cannot be built, so
a baseline number is never quietly a NumPy one; `use_native=False` pins
NumPy. Both are bitwise the oracle.

Handles: the binned rows and labels stay host arrays; predictions and
gradients are torch CPU tensors over the same memory (the Driver slices
them and draws the bagging mask on their device). The oracle is the f32
ground truth: quantized gradients, a mesh and the streamed trainer are
refused.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.reference import numpy_trainer as ref
from ddt_tpu_torch.utils.metrics import evaluate


class CPULabels(NamedTuple):
    """Labels and optional instance weights: the opaque `y` handle."""

    y: np.ndarray
    w: np.ndarray | None


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class CPUDevice(DeviceBackend):
    """NumPy (native-C++-accelerated when it builds) reference backend."""

    name = "cpu"

    def __init__(self, cfg: TrainConfig, use_native: bool | None = None):
        super().__init__(cfg)
        if cfg.grad_dtype != "f32":
            # The f32 ground truth the quantized path is measured against:
            # running it quantized would be circular.
            raise NotImplementedError(
                f"grad_dtype={cfg.grad_dtype!r} is not supported on the CPU "
                "oracle backend; use backend='cuda' (device='cpu' runs it on "
                "the CPU)")
        if cfg.world_size > 1:
            raise NotImplementedError(
                "the CPU oracle backend trains on one process; a mesh needs "
                "backend='cuda'")
        self.device = torch.device("cpu")
        self._native = self._native_split = None
        self._native_split_full = self._native_traverse = None
        if use_native is not False:
            try:
                from ddt_tpu_torch import native

                native.load()
                self._native = native.histogram_native
                self._native_split = native.split_gain_native
                self._native_split_full = native.split_gain_full_native
                self._native_traverse = native.traverse_native
            except ImportError:
                if use_native:
                    raise
        #: Which histogram implementation ran: "native" or "numpy".
        self.hist_impl = "native" if self._native is not None else "numpy"

    # ------------------------------------------------------------------ #

    def upload(self, Xb, shard: bool = True) -> np.ndarray:
        Xb = np.ascontiguousarray(_np(Xb))
        if Xb.dtype != np.uint8 or Xb.ndim != 2:
            raise TypeError(f"binned data must be uint8 [R, F], got "
                            f"{Xb.dtype} {Xb.shape}")
        if Xb.size and int(Xb.max()) >= self.cfg.n_bins:
            raise ValueError(f"binned data holds bin {int(Xb.max())} >= "
                             f"n_bins={self.cfg.n_bins}")
        return Xb

    def upload_labels(self, y, sample_weight=None,
                      shard: bool = True) -> CPULabels:
        w = None
        if sample_weight is not None:
            w = np.asarray(sample_weight, np.float32)
            if w.shape != np.shape(y):
                raise ValueError(f"sample_weight must be [R]={len(y)}, got "
                                 f"{w.shape}")
            if not np.all(np.isfinite(w)) or (w < 0).any():
                raise ValueError("sample_weight must be finite and >= 0")
            if not (w > 0).any():
                raise ValueError("sample_weight is all zero")
        return CPULabels(np.asarray(y), w)

    # ------------------------------------------------------------------ #

    def build_histograms(self, data, g, h, node_index, n_nodes) -> np.ndarray:
        args = (_np(data), _np(g), _np(h), _np(node_index), n_nodes,
                self.cfg.n_bins)
        if self._native is not None:
            return self._native(*args)
        return ref.build_histograms(*args)

    def best_splits(self, hist):
        hist = _np(hist)
        if self._native_split is not None:
            return self._native_split(hist, self.cfg.reg_lambda,
                                      self.cfg.min_child_weight)
        return ref.best_splits(hist, self.cfg.reg_lambda,
                               self.cfg.min_child_weight)[:3]

    # ------------------------------------------------------------------ #

    def init_pred(self, y: CPULabels, base: float) -> torch.Tensor:
        R = y.y.shape[0]
        if self.cfg.loss == "softmax":
            return torch.zeros((R, self.cfg.n_classes), dtype=torch.float32)
        return torch.full((R,), base, dtype=torch.float32)

    def load_pred(self, raw: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(raw, np.float32))

    def grad_hess(self, pred, y: CPULabels):
        g, h = ref.grad_hess(_np(pred), y.y, self.cfg.loss)
        if y.w is not None:
            w = y.w[:, None] if g.ndim == 2 else y.w
            g, h = g * w, h * w
        return (torch.from_numpy(np.ascontiguousarray(g, np.float32)),
                torch.from_numpy(np.ascontiguousarray(h, np.float32)))

    def apply_row_mask(self, g, h, mask):
        m = torch.as_tensor(_np(mask)).to(torch.float32)
        if g.dim() == 2:
            m = m[:, None]
        return g * m, h * m

    def grow_tree(self, data, g, h, feature_mask=None,
                  tree_id: int = 0) -> tuple[HostTree, Any]:
        split_full = None
        if self._native_split_full is not None:
            def split_full(hist, fm, missing, cm):
                return self._native_split_full(
                    hist, self.cfg.reg_lambda, self.cfg.min_child_weight,
                    feature_mask=fm, missing_bin=missing, cat_mask=cm)
        fm = None if feature_mask is None else _np(feature_mask).astype(bool)
        tree = ref.grow_tree(
            _np(data), np.ascontiguousarray(_np(g), np.float32),
            np.ascontiguousarray(_np(h), np.float32), self.cfg,
            hist_fn=self.build_histograms, feature_mask=fm,
            split_full_fn=split_full)
        delta = (self.cfg.learning_rate
                 * tree["leaf_value"][tree["leaf_of_row"]]).astype(np.float32)
        host = HostTree(
            feature=tree["feature"], threshold_bin=tree["threshold_bin"],
            is_leaf=tree["is_leaf"], leaf_value=tree["leaf_value"],
            split_gain=tree["split_gain"],
            default_left=tree["default_left"])
        return host, torch.from_numpy(delta)

    def apply_delta(self, pred, delta, class_idx: int):
        if pred.dim() == 2:
            out = pred.clone()
            out[:, class_idx] += delta
            return out
        return pred + delta

    def loss_value(self, pred, yh: CPULabels) -> float:
        loss, y, w = self.cfg.loss, yh.y, yh.w
        pred = _np(pred)

        def wmean(per_row):
            if w is None:
                return float(np.mean(per_row))
            return float(np.average(per_row, weights=w))

        if loss == "logloss":
            p = 1.0 / (1.0 + np.exp(-pred.astype(np.float64)))
            p = np.clip(p, 1e-12, 1 - 1e-12)
            return wmean(-(y * np.log(p) + (1 - y) * np.log(1 - p)))
        if loss == "mse":
            return wmean((pred - y) ** 2)
        z = pred - pred.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return wmean(-logp[np.arange(y.shape[0]), y.astype(np.int64)])

    def eval_round(self, val_data, val_pred, handles, val_y: CPULabels,
                   metric: str):
        """One round's trees (a HostTree per class) added to the eval
        margins in f32, tree by tree; the metric on the host (f64)."""
        out = _np(val_pred).copy()
        lr = np.float32(self.cfg.learning_rate)
        for c, tree in enumerate(handles):
            leaf = self._leaves(val_data, tree)[0]
            d = (lr * tree["leaf_value"][leaf]).astype(np.float32)
            if out.ndim == 2:
                out[:, c] += d
            else:
                out += d
        return torch.from_numpy(out), evaluate(metric, val_y.y, out)

    def _leaves(self, Xb, tree: HostTree) -> np.ndarray:
        """Leaf slot [1, R] of one host tree."""
        cfg = self.cfg
        feat, thr = tree["feature"][None], tree["threshold_bin"][None]
        leaf, dl = tree["is_leaf"][None], tree["default_left"][None]
        cat = (np.isin(feat, cfg.cat_features) if cfg.cat_features
               else None)
        if self._native_traverse is not None:
            return self._native_traverse(
                Xb, feat, thr, leaf, cfg.max_depth, default_left=dl,
                missing_bin_value=cfg.missing_bin_value, cat_node=cat)
        from ddt_tpu_torch.streaming import _leaf_slot

        return _leaf_slot(Xb, feat[0], thr[0], leaf[0], cfg.max_depth,
                          dl[0], cfg.missing_bin_value,
                          cfg.cat_features)[None]

    # ------------------------------------------------------------------ #

    def predict_raw(self, ens: TreeEnsemble, Xb, compiled=None
                    ) -> np.ndarray:
        """Raw margins of binned rows on the host: the native traversal and
        the ensemble's own aggregation, or the ensemble's NumPy path.
        `compiled` is accepted for the contract and unused."""
        Xb = np.ascontiguousarray(_np(Xb), np.uint8)
        if self._native_traverse is None:
            return ens.predict_raw(Xb, binned=True)
        use_missing = ens.missing_bin and ens.default_left is not None
        leaf = self._native_traverse(
            Xb, ens.feature, ens.threshold_bin, ens.is_leaf, ens.max_depth,
            default_left=ens.default_left,
            missing_bin_value=ens.n_bins - 1 if use_missing else -1,
            cat_node=(np.isin(ens.feature, ens.cat_features)
                      if ens.has_cat_splits else None))
        return ens.aggregate_leaves(leaf)
