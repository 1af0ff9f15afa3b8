"""Traversal kernel wrapper (csrc/lut.cu `ddt_traverse_f32`): the Hopper
counterpart of ddt_tpu/ops/predict_pallas.py::_traverse_kernel (K3).

K3 is the template of the LUT kernels (K4, K5) with f32 leaves: the same
tree-major records (ops/predict_lut_cuda.node_words / assemble_records),
the same TMA staging, descent and tree-order sums, and the same launch
plan (ops/predict_lut_cuda.plan_launch: (row, tree) pairs over threads for
small batches, two rows a thread for large ones). Design and bound are
stated in the source. `pack_tables` builds a model's records once, on its
device; `traverse_cuda` then checks its arguments, looks up the cached
plan and makes one ctypes call. Missing-value and categorical routing and
C <= 32 classes are kept, as K3's contract has them.

The plain version of the same function is ops/predict.
predict_effective_plain; ops/predict.predict_prepared dispatches CUDA
tensors here and CPU tensors there. The kernel equals it bit for bit at
every batch size. This wrapper never falls back: a CPU tensor, a shape the
plan refuses, or a failed launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.ops import predict_lut_cuda as L
from ddt_tpu_torch.utils import launches as _launches

#: Kernel launches since the last reset (chip_smoke reads it around the
#: main path). Counted only where the kernel is launched.
launches = 0

MAX_CLASSES = L.MAX_CLASSES
LEAF_DTYPE = "float32"      # the records' leaf kind (csrc/lut.cu kF32)


class Tables(NamedTuple):
    """One CompiledEnsemble's packed records, on the card."""

    rec: torch.Tensor       # uint8 [n_trees, record_bytes(D, "float32")]
    n_trees: int            # trees packed: trailing all-zero ones left out
    n_trees_padded: int     # the CompiledEnsemble's tree count
    max_feature: int        # largest split feature (-1: no split at all)
    max_depth: int
    n_classes: int
    use_missing: bool
    use_cat: bool


def pack_tables(eff_feat, eff_thr, bot_val, cls_oh, max_depth: int,
                eff_dl=None, eff_cat=None) -> Tables:
    """CompiledEnsemble arrays (tree-major, on one device) -> K3's records
    on that device, built once per model: a node word per internal node
    (thresholds clamped to [-1, 256], which routes every uint8 bin as the
    int32 threshold does), the class, and the bottom-level values as raw
    f32 bits. Trailing trees whose values are all +-0.0 (the padding) are
    left out. Two host syncs read the tree and feature counts."""
    Tpad, C = cls_oh.shape
    if C > MAX_CLASSES:
        raise ValueError(f"{C} classes; the kernel takes at most "
                         f"{MAX_CLASSES}")
    n_int = (1 << max_depth) - 1
    f = eff_feat[:, :n_int].to(torch.int32)
    t = eff_thr[:, :n_int].clamp(-1, 256).to(torch.int32)
    word = L.node_words(
        f, t, dl=None if eff_dl is None else eff_dl[:, :n_int],
        cat=None if eff_cat is None else eff_cat[:, :n_int])
    vals = bot_val.to(torch.float32).contiguous()
    zero = (vals.view(torch.int32) & 0x7FFFFFFF) == 0
    ones = torch.ones(Tpad, dtype=torch.float32, device=f.device)
    r = L.assemble_records(word, cls_oh.argmax(dim=1), ones,
                           vals.view(torch.uint8), zero, max_depth,
                           LEAF_DTYPE)
    return Tables(rec=r.rec, n_trees=r.n_trees, n_trees_padded=Tpad,
                  max_feature=r.max_feature, max_depth=max_depth,
                  n_classes=int(C), use_missing=eff_dl is not None,
                  use_cat=eff_cat is not None)


def traverse_cuda(tables: Tables, X: torch.Tensor, *, learning_rate: float,
                  base: float, tree_chunk: int = 64,
                  missing_bin_value: int = -1) -> torch.Tensor:
    """f32 [R, C] margins base + lr * sum of leaf values, X uint8 [R, F]
    contiguous on the card holding the tables."""
    if X.device.type != "cuda":
        raise TypeError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.uint8 or X.dim() != 2 or not X.is_contiguous():
        raise TypeError("X must be a contiguous uint8 [R, F] tensor")
    dev = X.device
    if tables.rec.device != dev:
        raise ValueError(f"tables on {tables.rec.device}, X on {dev}")
    if tables.n_trees_padded % tree_chunk:
        raise ValueError(f"padded tree count {tables.n_trees_padded} is "
                         f"not a multiple of tree_chunk={tree_chunk}")
    R, F = X.shape
    C = tables.n_classes
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    if tables.max_feature >= F:
        raise ValueError(f"split feature {tables.max_feature} is >= the "
                         f"data's {F} columns")
    D = tables.max_depth
    plan = L.plan_launch(R, tables.n_trees, D, F, LEAF_DTYPE, C,
                         _build.smem_limit(dev), L.sm_count(dev))
    lib = L.library()
    with torch.cuda.device(dev):
        status = lib.ddt_traverse_f32(
            X.data_ptr(), tables.rec.data_ptr(), out.data_ptr(), R, F,
            tables.n_trees, D, tree_chunk,
            L.record_bytes(D, LEAF_DTYPE) // 4, C,
            missing_bin_value if tables.use_missing else -1,
            int(tables.use_missing or tables.use_cat), int(plan.pairs),
            plan.rows, plan.sub, float(learning_rate), float(base),
            plan.smem, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "ddt_traverse_f32 launch")
    _launches.count(__name__, "launches")
    return out
