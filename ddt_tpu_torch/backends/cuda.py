"""CUDADevice: the port's DeviceBackend (port of ddt_tpu/backends/tpu.py's
single-device path).

Data, labels, gradients and boosting state live as torch tensors on
`cfg.device`. On "cuda" the histogram and traversal steps launch the
port's kernels (ops/hist_cuda, ops/predict_cuda); on "cpu" the same code
runs their plain versions, which is how the tests drive it. A "cuda"
config without a visible card raises: the backend never moves to the CPU
by itself.

Scoring keeps a small per-model cache of the scoring operands on the
device (on "cuda" the kernel's packed tables), keyed on the model's
content token (the reference's TPUDevice._predict_fn keeps the same
cache), so repeated scoring of an unchanged model uploads, pushes down
and packs nothing: a cache hit launches only the kernel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import CompiledEnsemble, TreeEnsemble
from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import histogram as hist_ops
from ddt_tpu_torch.ops import predict as predict_ops
from ddt_tpu_torch.ops import split as split_ops


class LabelHandle(NamedTuple):
    """Labels on the device: the opaque `y` the Driver threads through
    grad_hess / loss_value (per-dataset state lives in handles, not on
    the backend, which is cached and shared)."""

    y: torch.Tensor     # f32 [R]


class CUDADevice(DeviceBackend):
    """Single-device histogram-GBDT backend on PyTorch tensors."""

    name = "cuda"
    PREDICT_CACHE_MAX = 4

    def __init__(self, cfg: TrainConfig):
        super().__init__(cfg)
        if cfg.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain versions on the CPU")
        self.device = torch.device(cfg.device)
        self.hist_subtraction = grow_ops.resolve_hist_subtraction(
            cfg.hist_subtraction, self.device.type)
        # token -> (CompiledEnsemble, prepared operands), LRU order.
        self._predict_cache: dict[str, tuple] = {}

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else self._put(np.asarray(a))

    # ------------------------------------------------------------------ #
    # data plane
    # ------------------------------------------------------------------ #

    def upload(self, Xb: np.ndarray) -> torch.Tensor:
        Xb = np.asarray(Xb)
        if Xb.dtype != np.uint8 or Xb.ndim != 2:
            raise TypeError(
                f"binned data must be uint8 [R, F], got {Xb.dtype} "
                f"{Xb.shape}")
        if Xb.size and int(Xb.max()) >= self.cfg.n_bins:
            raise ValueError(
                f"binned data holds bin {int(Xb.max())} >= n_bins="
                f"{self.cfg.n_bins}")
        return self._put(Xb)

    def upload_labels(self, y: np.ndarray,
                      sample_weight: np.ndarray | None = None
                      ) -> LabelHandle:
        if sample_weight is not None:
            raise NotImplementedError(
                "sample_weight is not ported yet (ROADMAP.md)")
        return LabelHandle(self._put(np.asarray(y, np.float32)))

    # ------------------------------------------------------------------ #
    # granular kernels (parity surface)
    # ------------------------------------------------------------------ #

    def build_histograms(self, data, g, h, node_index, n_nodes):
        return hist_ops.build_histograms(
            data, self._tensor(g).float().contiguous(),
            self._tensor(h).float().contiguous(),
            self._tensor(node_index).to(torch.int32).contiguous(),
            n_nodes, self.cfg.n_bins)

    def best_splits(self, hist):
        return split_ops.best_splits_impl(
            self._tensor(hist), self.cfg.reg_lambda,
            self.cfg.min_child_weight)[:3]

    # ------------------------------------------------------------------ #
    # training ops
    # ------------------------------------------------------------------ #

    def init_pred(self, y: LabelHandle, base: float) -> torch.Tensor:
        return torch.full(y.y.shape, base, dtype=torch.float32,
                          device=self.device)

    def load_pred(self, raw: np.ndarray) -> torch.Tensor:
        return self._put(np.asarray(raw, np.float32))

    def grad_hess(self, pred, y: LabelHandle):
        return grad_ops.grad_hess(pred, y.y, self.cfg.loss)

    def grow_tree(self, data, g, h, feature_mask=None,
                  tree_id: int = 0) -> tuple[Any, Any]:
        """Returns (packed [6, N] f32 tree on the device, delta [R]): no
        host sync here; `fetch_tree` copies the tree to the host."""
        if feature_mask is not None:
            raise NotImplementedError(
                "colsample feature masks are not ported yet (ROADMAP.md)")
        cfg = self.cfg
        tree = grow_ops.grow_tree(
            data, g.contiguous(), h.contiguous(),
            max_depth=cfg.max_depth, n_bins=cfg.n_bins,
            reg_lambda=cfg.reg_lambda,
            min_child_weight=cfg.min_child_weight,
            min_split_gain=cfg.min_split_gain,
            hist_subtraction=self.hist_subtraction)
        delta = grow_ops.tree_predict_delta(tree, cfg.learning_rate)
        # One [6, N] f32 array: a single device->host copy per tree
        # (int32 and bool node values are exact in f32).
        packed = torch.stack([
            tree.feature.float(), tree.threshold_bin.float(),
            tree.is_leaf.float(), tree.leaf_value, tree.split_gain,
            tree.default_left.float()])
        return packed, delta

    def fetch_tree(self, handle) -> HostTree:
        packed = handle.cpu().numpy()
        return HostTree(
            feature=packed[0].astype(np.int32),
            threshold_bin=packed[1].astype(np.int32),
            is_leaf=packed[2].astype(bool),
            leaf_value=packed[3].astype(np.float32),
            split_gain=packed[4].astype(np.float32),
            default_left=packed[5].astype(bool),
        )

    def apply_delta(self, pred, delta, class_idx: int):
        if class_idx != 0:
            raise ValueError("one output column (softmax is not ported yet)")
        return pred + delta

    def loss_value(self, pred, y: LabelHandle) -> float:
        return float(grad_ops.mean_loss(pred, y.y, self.cfg.loss))

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #

    def _prepared(self, ens: TreeEnsemble,
                  compiled: CompiledEnsemble | None):
        """(CompiledEnsemble, its scoring operands on the device, as
        predict.prepare builds them), cached per model."""
        token = compiled.token if compiled is not None \
            else ens.cache_token()
        hit = self._predict_cache.pop(token, None)
        if hit is None:
            ce = compiled if compiled is not None else ens.compile(
                tree_chunk=64)
            hit = (ce, predict_ops.prepare(
                self._put(ce.eff_feat), self._put(ce.eff_thr),
                self._put(ce.bot_val), self._put(ce.cls_oh),
                max_depth=ce.max_depth,
                eff_dl=None if ce.eff_dl is None else self._put(ce.eff_dl),
                eff_cat=None if ce.eff_cat is None
                else self._put(ce.eff_cat)))
        self._predict_cache[token] = hit            # most recently used
        while len(self._predict_cache) > self.PREDICT_CACHE_MAX:
            self._predict_cache.pop(next(iter(self._predict_cache)))
        return hit

    def predict_raw(self, ens: TreeEnsemble, Xb: np.ndarray,
                    compiled=None) -> np.ndarray:
        ce, ops = self._prepared(ens, compiled)
        Xb = np.asarray(Xb)
        if Xb.dtype != np.uint8 or Xb.ndim != 2:
            raise TypeError(
                f"binned data must be uint8 [R, F], got {Xb.dtype} "
                f"{Xb.shape}")
        out = predict_ops.predict_prepared(
            ops, self._put(Xb), learning_rate=ce.learning_rate,
            base=ce.base_score, tree_chunk=ce.tree_chunk,
            missing_bin_value=ce.missing_bin_value)
        return out.cpu().numpy()
