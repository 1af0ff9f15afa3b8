"""DeviceBackend: the Driver's device contract (port of
ddt_tpu/backends/base.py, same method names).

The Driver sees only upload / upload_labels / init_pred / load_pred /
grad_hess / apply_row_mask / grow_tree / fetch_tree / apply_delta /
loss_value / eval_round / predict_raw, and the optional fused rounds
(grow_rounds / grow_rounds_masked / grow_rounds_eval / fetch_rounds),
which it takes whenever a backend has them; the granular kernels (build_histograms, best_splits) stay on the
interface as the parity surface. Boosting state (raw predictions) and
the data live where the backend wants them (`device`): opaque handles flow
Driver -> grad_hess -> grow_tree -> apply_delta without a host round
trip; only the grown trees' node arrays come back, per tree on the
granular loop and once a block on the fused one.
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


#: Rows of a packed tree record [6, N] f32 (int32 and bool node values are
#: exact in f32): one device->host copy carries a whole tree.
PACKED_FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value",
                 "split_gain", "default_left")


def unpack_tree(packed: np.ndarray) -> HostTree:
    """A packed [6, N] f32 tree record -> HostTree."""
    return HostTree(
        feature=packed[0].astype(np.int32),
        threshold_bin=packed[1].astype(np.int32),
        is_leaf=packed[2].astype(bool),
        leaf_value=packed[3].astype(np.float32),
        split_gain=packed[4].astype(np.float32),
        default_left=packed[5].astype(bool),
    )


class DeviceBackend(abc.ABC):
    """Uniform device API for histogram-GBDT training and inference."""

    name: str = "abstract"
    #: Where the backend keeps data and state (a torch.device).
    device: Any = None
    #: The mesh it trains on (parallel/mesh.Mesh; None: one device), its
    #: row group (the ranks holding this rank's columns, by row shard), its
    #: feature group (None without feature shards), the row shards and
    #: this rank's row shard.
    mesh: Any = None
    group: Any = None
    feature_group: Any = None
    world: int = 1
    rank: int = 0
    #: The partition recorder's span factory while a fit records per-rank
    #: lanes (the Driver sets it on a mesh), else None.
    partition_span: Any = None

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    # --- data plane ---

    @abc.abstractmethod
    def upload(self, Xb: Any, shard: bool = True) -> Any:
        """Ship the binned uint8 matrix [R, F] (host, or a tensor) to the
        device: on a mesh this rank's row block and column slab, unless
        `shard` is False (an eval set, which every rank scores whole)."""

    @abc.abstractmethod
    def upload_labels(self, y: np.ndarray,
                      sample_weight: np.ndarray | None = None,
                      shard: bool = True) -> Any:
        """Ship labels [R] (with optional per-row weights), cut as
        `upload` cuts the rows."""

    def row_start(self, n_local: int) -> int:
        """Global id of this rank's first row, its block holding n_local
        rows (0 on one device): the bagging and rounding draws' base."""
        return self.rank * n_local

    def n_features(self, data: Any) -> int:
        """Global width of uploaded training rows (data's own unless the
        backend cut a column slab)."""
        return data.shape[1]

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
        """Initial raw scores [R] filled with `base` ([R, C] for
        softmax)."""

    @abc.abstractmethod
    def load_pred(self, raw: np.ndarray) -> Any:
        """Adopt host raw scores [R] or [R, C] as the boosting state (or as
        eval-set margins)."""

    @abc.abstractmethod
    def grad_hess(self, pred: Any, y: Any) -> tuple[Any, Any]:
        """Loss gradients/hessians at `pred`, times the instance weights:
        f32 [R], or [R, C] for softmax."""

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

    def block_bounds(self, n_rows: int) -> tuple[int, int, int]:
        """(start, stop, local rows with padding) of this process's block
        of an n_rows streamed chunk: the whole chunk on one device."""
        return 0, n_rows, n_rows

    # --- fused rounds (optional: the Driver takes them when present) ---
    #
    # grow_rounds(data, pred, y, n_rounds, first_round=0) runs n_rounds
    # boosting rounds on the device, C trees a round, and returns device
    # handles (packed trees [n_rounds, 6, N] f32, [n_rounds, C, 6, N] for
    # softmax; the new pred; losses [n_rounds] f32: the loss after each
    # round, loss_value's semantics). Bagging masks and quantized-gradient
    # rounding keys come from the absolute round first_round + k.
    # grow_rounds_masked(data, pred, y, n_rounds, fmasks, first_round=0)
    # adds the host-drawn colsample masks, bool [n_rounds, C, F].
    # grow_rounds_eval(data, pred, y, n_rounds, val_data, val_pred, val_y,
    # metric, first_round=0, fmasks=None) also adds each tree to the eval
    # margins and returns the new margins and the metric after each round,
    # scores [n_rounds] f32. The reference's contract
    # (ddt_tpu/backends/tpu.py:798-1095).
    grow_rounds = None
    grow_rounds_masked = None
    grow_rounds_eval = None

    def fetch_rounds(self, trees: Any, losses: Any, scores: Any = None
                     ) -> tuple:
        """Resolve grow_rounds' trees and losses (and eval scores) to host
        arrays."""
        out = (np.asarray(trees), np.asarray(losses))
        return out if scores is None else out + (np.asarray(scores),)

    @abc.abstractmethod
    def eval_round(self, val_data: Any, val_pred: Any, handles: list,
                   val_y: Any, metric: str) -> tuple[Any, Any]:
        """Add one round's trees (a grow_tree handle per class) to the eval
        margins: (new margins, the metric, a device scalar)."""

    @abc.abstractmethod
    def apply_delta(self, pred: Any, delta: Any, class_idx: int) -> Any:
        """pred updated by delta (in column class_idx of an [R, C] pred)."""

    @abc.abstractmethod
    def loss_value(self, pred: Any, y: Any) -> float:
        """Mean training loss at `pred` (host float; may sync)."""

    # --- inference ---

    @abc.abstractmethod
    def predict_raw(self, ens: TreeEnsemble, Xb: Any,
                    compiled=None) -> np.ndarray:
        """Batch scoring of binned rows (host uint8, or a uint8 tensor,
        scored where it lies when that is the backend's device): raw
        margins [R] or [R, C] on host. `compiled` is an optional
        CompiledEnsemble already built for ens."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} backend={self.name!r}>"
