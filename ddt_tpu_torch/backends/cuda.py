"""CUDADevice: the port's DeviceBackend (port of ddt_tpu/backends/tpu.py's
single-device path).

Data, labels, gradients and boosting state live as torch tensors on
`cfg.device`. On "cuda" the histogram and traversal steps launch the
port's kernels (ops/hist_cuda, ops/predict_cuda); on "cpu" the same code
runs their plain versions, which is how the tests drive it. A "cuda"
config without a visible card raises: the backend never moves to the CPU
by itself.

Scoring keeps a small per-model cache of the scoring operands on the
device, keyed on the model's content token (the reference's
TPUDevice._predict_fn keeps the same cache), so repeated scoring of an
unchanged model uploads, pushes down and packs nothing: a cache hit
launches only the kernel. The entry holds the tier that serves the model:
with cfg.predict_impl="lut" / "lut4" the quantized tables of
ops/predict_lut (kernels K4 / K5), walked down int4 -> int8 -> f32 when a
fits guard refuses the shape; otherwise the traversal kernel's f32
tables. `resolved_predict_impl(token)` reports the tier.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import CompiledEnsemble, TreeEnsemble
from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import histogram as hist_ops
from ddt_tpu_torch.ops import predict as predict_ops
from ddt_tpu_torch.ops import predict_lut, predict_lut_cuda
from ddt_tpu_torch.ops import split as split_ops

log = logging.getLogger("ddt_tpu_torch.backends.cuda")


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
        # token -> (CompiledEnsemble, prepared operands), LRU order; and
        # token -> the tier those operands serve. Both under _cache_lock.
        self._predict_cache: dict[str, tuple] = {}
        self._predict_impl_resolved: dict[str, str] = {}
        self._cache_lock = threading.Lock()

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

    def resolved_predict_impl(self, token: str) -> str:
        """The scoring tier that serves model `token` after the ladder
        ("lut4" | "lut" | "f32"; "f32" when the model never scored
        here)."""
        with self._cache_lock:
            return self._predict_impl_resolved.get(token, "f32")

    def _smem_limit(self) -> int:
        if self.device.type == "cuda":
            return _build.smem_limit(self.device)
        return predict_lut_cuda.SMEM_LIMIT_H100

    def _lut_operands(self, ce: CompiledEnsemble, n_features: int,
                      tier: str):
        """The quantized tier `tier` ("lut" int8, "lut4" int4) of one
        model on the device, or None when that kernel's fits guard
        refuses the shape (the caller walks the ladder down)."""
        if tier == "lut4":
            tables = ce.quantize(leaf_dtype="int4")
            packed = tables.pack_int4()
            if not predict_lut.predict_lut4_fits(
                    tables.n_trees_padded, tables.tree_chunk,
                    tables.max_depth, n_features, tables.n_classes_out,
                    smem_limit=self._smem_limit(),
                    thr_packed=packed.thr_packed):
                return None
            host_ops, static = packed.ops, packed.static_kwargs()
        else:
            tables = ce.quantize()
            if not predict_lut.predict_lut_fits(
                    tables.n_trees_padded, tables.tree_chunk,
                    tables.max_depth, n_features, tables.n_classes_out,
                    smem_limit=self._smem_limit(),
                    leaf_dtype=tables.leaf_dtype):
                return None
            host_ops = predict_lut.lut_device_operands(tables)
            static = predict_lut.lut_static_kwargs(tables)
        # What the kernel would otherwise derive per call, once per model.
        n_int = (1 << tables.max_depth) - 1
        static.update(
            cls=self._put(tables.cls_oh.argmax(axis=1).astype(np.int32)),
            max_feature=int(tables.eff_feat[:, :n_int].max()))
        return predict_lut.LutOperands(
            tier, tuple(self._put(a) for a in host_ops), static)

    def _scoring_operands(self, ce: CompiledEnsemble, n_features: int):
        """(operands, tier): the reference's ladder (TPUDevice._predict_fn)
        int4 -> int8 -> f32, each step taken only when the fits guard
        refuses the shape, decided before any launch."""
        impl = self.cfg.predict_impl
        lut = None
        if impl == "lut4":
            lut = self._lut_operands(ce, n_features, "lut4")
            if lut is None:
                log.warning(
                    "predict_impl='lut4': shape exceeds the int4 kernel's "
                    "shared memory; falling back to the int8 LUT tier")
        if lut is None and impl in ("lut", "lut4"):
            lut = self._lut_operands(ce, n_features, "lut")
            if lut is None:
                log.warning(
                    "predict_impl=%r: shape exceeds the LUT kernel's "
                    "shared memory; falling back to the f32 path", impl)
        if lut is not None:
            return lut, lut.tier
        return predict_ops.prepare(
            self._put(ce.eff_feat), self._put(ce.eff_thr),
            self._put(ce.bot_val), self._put(ce.cls_oh),
            max_depth=ce.max_depth,
            eff_dl=None if ce.eff_dl is None else self._put(ce.eff_dl),
            eff_cat=None if ce.eff_cat is None
            else self._put(ce.eff_cat)), "f32"

    def _prepared(self, ens: TreeEnsemble,
                  compiled: CompiledEnsemble | None):
        """(CompiledEnsemble, its scoring operands on the device: the
        serving tier's LutOperands, or predict.prepare's f32 operands),
        cached per model. The lock makes lookups and inserts atomic, so
        a swap warming a new model on one thread and a dispatcher scoring
        on another share the cache; operands are built outside it."""
        token = compiled.token if compiled is not None \
            else ens.cache_token()
        with self._cache_lock:
            hit = self._predict_cache.pop(token, None)
            if hit is not None:
                self._predict_cache[token] = hit    # most recently used
                return hit
        ce = compiled if compiled is not None else ens.compile(
            tree_chunk=64)
        ops, tier = self._scoring_operands(ce, ens.n_features)
        hit = (ce, ops)
        with self._cache_lock:
            self._predict_cache[token] = hit
            self._predict_impl_resolved[token] = tier
            while len(self._predict_cache) > self.PREDICT_CACHE_MAX:
                gone = next(iter(self._predict_cache))
                self._predict_cache.pop(gone)
                self._predict_impl_resolved.pop(gone, None)
        return hit

    def predict_raw(self, ens: TreeEnsemble, Xb: np.ndarray,
                    compiled=None) -> np.ndarray:
        ce, ops = self._prepared(ens, compiled)
        Xb = np.asarray(Xb)
        if Xb.dtype != np.uint8 or Xb.ndim != 2:
            raise TypeError(
                f"binned data must be uint8 [R, F], got {Xb.dtype} "
                f"{Xb.shape}")
        if isinstance(ops, predict_lut.LutOperands):
            out = ops.score(self._put(Xb))
        else:
            out = predict_ops.predict_prepared(
                ops, self._put(Xb), learning_rate=ce.learning_rate,
                base=ce.base_score, tree_chunk=ce.tree_chunk,
                missing_bin_value=ce.missing_bin_value)
        return out.cpu().numpy()
