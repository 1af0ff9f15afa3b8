"""DeviceBackend: the Driver's device contract (port of
ddt_tpu/backends/base.py, same method names).

The Driver sees only upload / upload_labels / init_pred / grad_hess /
apply_row_mask / grow_tree / fetch_tree / apply_delta / loss_value /
predict_raw; the granular kernels (build_histograms, best_splits) stay on
the interface as the parity surface. Boosting state (raw predictions) and
the data live where the backend wants them: opaque handles flow Driver ->
grad_hess -> grow_tree -> apply_delta without a host round trip; only the
grown tree's node arrays come back per tree.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np

from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble


class HostTree(dict):
    """One grown tree, host side: numpy arrays feature / threshold_bin /
    is_leaf / leaf_value / split_gain / default_left, each [n_nodes_total]."""


class DeviceBackend(abc.ABC):
    """Uniform device API for histogram-GBDT training and inference."""

    name: str = "abstract"

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    # --- data plane ---

    @abc.abstractmethod
    def upload(self, Xb: np.ndarray) -> Any:
        """Ship the binned uint8 matrix [R, F] to the device."""

    @abc.abstractmethod
    def upload_labels(self, y: np.ndarray,
                      sample_weight: np.ndarray | None = None) -> Any:
        """Ship labels [R] (with optional per-row weights)."""

    # --- granular kernels (the parity surface) ---

    @abc.abstractmethod
    def build_histograms(self, data: Any, g: Any, h: Any, node_index: Any,
                         n_nodes: int) -> Any:
        """Per-(node, feature, bin) (g, h) sums: [n_nodes, F, n_bins, 2]
        f32. `node_index` is the level-local node per row (-1 = frozen)."""

    @abc.abstractmethod
    def best_splits(self, hist: Any) -> tuple[Any, Any, Any]:
        """Per-node (gain f32, feature i32, threshold_bin i32)."""

    # --- training ops (what the Driver calls per tree) ---

    @abc.abstractmethod
    def init_pred(self, y: Any, base: float) -> Any:
        """Initial raw scores [R] filled with `base`."""

    @abc.abstractmethod
    def load_pred(self, raw: np.ndarray) -> Any:
        """Adopt host raw scores [R] as the boosting state."""

    @abc.abstractmethod
    def grad_hess(self, pred: Any, y: Any) -> tuple[Any, Any]:
        """Loss gradients/hessians at `pred`: f32 [R]."""

    @abc.abstractmethod
    def apply_row_mask(self, g: Any, h: Any, mask: Any) -> tuple[Any, Any]:
        """Bagging: (g, h) with the rows where `mask` (bool [R]) is False
        zeroed."""

    @abc.abstractmethod
    def grow_tree(self, data: Any, g: Any, h: Any,
                  feature_mask: np.ndarray | None = None,
                  tree_id: int = 0) -> tuple[Any, Any]:
        """Grow one tree. Returns (tree handle, delta): a handle to the
        tree's node arrays (resolve with fetch_tree) and the per-row
        raw-score increment lr * leaf_value[leaf_of_row] (for
        apply_delta)."""

    def fetch_tree(self, handle: Any) -> HostTree:
        """Resolve a grow_tree handle to host node arrays."""
        return handle

    @abc.abstractmethod
    def apply_delta(self, pred: Any, delta: Any, class_idx: int) -> Any:
        """pred updated by delta."""

    @abc.abstractmethod
    def loss_value(self, pred: Any, y: Any) -> float:
        """Mean training loss at `pred` (host float; may sync)."""

    # --- inference ---

    @abc.abstractmethod
    def predict_raw(self, ens: TreeEnsemble, Xb: np.ndarray,
                    compiled=None) -> np.ndarray:
        """Batch scoring of binned rows: raw margins [R] or [R, C] on host.
        `compiled` is an optional CompiledEnsemble already built for ens."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} backend={self.name!r}>"
