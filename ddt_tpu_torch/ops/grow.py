"""Whole-tree growth: the level loop on one device.

Port of ddt_tpu/ops/grow.py for one device, ordinal splits, f32 or
quantized gradients, with an optional colsample feature mask (no mesh,
feature axis, missing-value or categorical training yet). Per level:
histograms (ops/histogram: the CUDA kernel on the card, the plain segment
form on the CPU) -> node totals -> best splits (ops/split) -> node values
and split decisions -> row routing. Every step is a PyTorch op queued on
the tensors' device; the host reads nothing until the Driver fetches the
finished tree.

Quantized gradients (grad_dtype "int8" | "int16"): g/h are quantized once
per tree (ops/grad.quantize_gradients); histograms, node totals and leaf
sums add the integer q's exactly in int32; the sibling-subtraction carry
keeps the int32 form, so parent - left is exact; and each level's
histogram is dequantized exactly once, hist * (gscale, hscale), before
the gain scan.

Row routing keeps a dense per-row heap node id. The reference packs the
per-node tables into one int32 and selects each row's entry with a one-hot
compare+reduce, because gathers are slow on a TPU; here each row's entry is
a gather, which selects the same integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import histogram as H
from ddt_tpu_torch.ops import split as S


def resolve_hist_subtraction(flag: str, device_type: str,
                             integer_hists: bool = False) -> bool:
    """cfg.hist_subtraction ('auto'|'on'|'off') -> bool for this device.

    'auto' is on for CUDA and off on the CPU: parent - left changes
    right-child sums by f32 ULPs against a direct build, which the CPU
    suites' bitwise contracts with the reference's CPU path would see
    (the reference gates it to its accelerator for the same reason).
    With `integer_hists` (quantized gradients) parent - left is exact in
    int32, so 'auto' is on everywhere."""
    if flag == "on":
        return True
    if flag == "off":
        return False
    if flag != "auto":
        raise ValueError(
            f"hist_subtraction must be auto|on|off, got {flag!r}")
    return integer_hists or device_type == "cuda"


def level_histograms(Xb, g, h, node_index, n_level: int, n_bins: int, *,
                     parent_hist=None, parent_split=None) -> torch.Tensor:
    """One level's [n_level, F, B, 2] histograms.

    With the previous level's histograms and split decisions, only LEFT
    children are built from rows (half the kernel work); each right child
    is parent - left, and children of parents that did not split are
    exactly zero (otherwise a frozen parent's phantom right child would
    inherit its mass and could win a split no training row reaches).
    Dtype-generic: on the quantized path the carry and the left build are
    int32 and the subtraction is exact."""
    if parent_hist is None or n_level < 2:
        return H.build_histograms(Xb, g, h, node_index, n_level, n_bins)
    half = n_level // 2
    is_left = (node_index >= 0) & (node_index % 2 == 0)
    li = torch.where(is_left, node_index // 2, -1).to(torch.int32)
    hist_left = H.build_histograms(Xb, g, h, li, half, n_bins)
    gate = parent_split.reshape(half, 1, 1, 1)
    hist_right = torch.where(gate, parent_hist - hist_left, 0)
    hist = torch.stack([hist_left, hist_right], dim=1)
    return hist.reshape((n_level,) + hist_left.shape[1:])


class TreeArrays(NamedTuple):
    """One grown tree in heap layout + per-row leaf assignment."""

    feature: torch.Tensor        # int32 [n_nodes_total], -1 on leaves
    threshold_bin: torch.Tensor  # int32 [n_nodes_total]
    is_leaf: torch.Tensor        # bool  [n_nodes_total]
    leaf_value: torch.Tensor     # f32 [n_nodes_total]
    split_gain: torch.Tensor     # f32 [n_nodes_total], 0 on leaves
    default_left: torch.Tensor   # bool  [n_nodes_total] (all False here)
    leaf_of_row: torch.Tensor    # int32 [R] heap slot where each row landed


def grow_tree(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor, *,
              max_depth: int, n_bins: int, reg_lambda: float,
              min_child_weight: float, min_split_gain: float,
              hist_subtraction: bool = False, grad_dtype: str = "f32",
              quant_tree_id: int = 0, quant_seed: int = 0,
              feature_mask: torch.Tensor | None = None) -> TreeArrays:
    """Grow one complete-heap tree from uint8 Xb [R, F] and f32 g, h [R]
    (the same decisions as ddt_tpu/ops/grow.grow_tree on one device).

    grad_dtype "int8"/"int16" quantizes g/h once, keyed by (quant_seed,
    quant_tree_id, row); feature_mask (bool [F] on Xb's device, False =
    excluded) restricts every level's split candidates (colsample)."""
    R, F = Xb.shape
    dev = Xb.device
    N = 2 ** (max_depth + 1) - 1

    feature = torch.full((N,), -1, dtype=torch.int32, device=dev)
    threshold_bin = torch.zeros(N, dtype=torch.int32, device=dev)
    is_leaf = torch.zeros(N, dtype=torch.bool, device=dev)
    leaf_value = torch.zeros(N, dtype=torch.float32, device=dev)
    split_gain = torch.zeros(N, dtype=torch.float32, device=dev)
    default_left = torch.zeros(N, dtype=torch.bool, device=dev)

    node_id = torch.zeros(R, dtype=torch.int32, device=dev)
    frozen = torch.zeros(R, dtype=torch.bool, device=dev)
    prev_hist = prev_split = None

    quant = grad_dtype != "f32"
    if quant:
        g, h, gscale, hscale = grad_ops.quantize_gradients(
            g, h, grad_dtype=grad_dtype, tree_id=quant_tree_id,
            seed=quant_seed)
        scale2 = torch.stack([gscale, hscale])    # [2] dequantize vector

    for depth in range(max_depth):
        offset = (1 << depth) - 1
        n_level = 1 << depth
        node_index = torch.where(frozen, -1, node_id - offset) \
            .to(torch.int32)
        hist = level_histograms(Xb, g, h, node_index, n_level, n_bins,
                                parent_hist=prev_hist,
                                parent_split=prev_split)
        G, Hh = S.node_totals(hist)
        hist_q = hist
        if quant:
            # The one dequantize per level: integer sums, then * scale.
            G = G.to(torch.float32) * gscale
            Hh = Hh.to(torch.float32) * hscale
            hist = hist.to(torch.float32) * scale2
        gains, feats, bins, dls = S.best_splits_impl(
            hist, reg_lambda, min_child_weight, feature_mask)
        # An empty node at reg_lambda = 0 would store -0/0 = NaN, which a
        # predict-time row can reach: guarded to 0.
        value = torch.where(Hh > 0, -G / (Hh + reg_lambda), 0.0)
        do_split = (gains > min_split_gain) & torch.isfinite(gains) \
            & (Hh > 0)
        sl = slice(offset, offset + n_level)
        feature[sl] = torch.where(do_split, feats, -1)
        threshold_bin[sl] = torch.where(do_split, bins, 0)
        is_leaf[sl] = ~do_split
        leaf_value[sl] = torch.where(do_split, 0.0, value)
        split_gain[sl] = torch.where(do_split, gains, 0.0)
        default_left[sl] = do_split & dls

        # Route rows through the new splits: gather each row's node entry.
        idx = (node_id - offset).clamp(0, n_level - 1).to(torch.int64)
        split_here = do_split[idx] & ~frozen
        feat_r = feats[idx].to(torch.int64)
        fv = Xb.gather(1, feat_r[:, None])[:, 0].to(torch.int32)
        go_right = (fv > bins[idx]).to(torch.int32)
        node_id = torch.where(split_here, 2 * node_id + 1 + go_right,
                              node_id)
        frozen = frozen | ~split_here

        if hist_subtraction:       # the int32 form on the quantized path
            prev_hist, prev_split = hist_q, do_split

    # Final level: leaf values from per-terminal-node (G, H) sums.
    offset = (1 << max_depth) - 1
    n_last = 1 << max_depth
    active = ~frozen
    idx = (node_id - offset).clamp(0, n_last - 1)
    GH = grad_ops.leaf_gh_sums(idx, active, g, h, n_last)
    Gl, Hl = GH[:, 0], GH[:, 1]
    if quant:
        Gl = Gl.to(torch.float32) * gscale
        Hl = Hl.to(torch.float32) * hscale
    vals = torch.where(Hl > 0, -Gl / (Hl + reg_lambda), 0.0)
    sl = slice(offset, offset + n_last)
    is_leaf[sl] = True
    leaf_value[sl] = vals
    return TreeArrays(feature, threshold_bin, is_leaf, leaf_value,
                      split_gain, default_left, node_id)


def tree_predict_delta(tree: TreeArrays,
                       learning_rate: float) -> torch.Tensor:
    """Per-row raw-score increment of a freshly grown tree: lr * the value
    of the slot each row landed in (no re-traversal during training)."""
    return learning_rate * tree.leaf_value[tree.leaf_of_row.to(torch.int64)]
