"""Per-chunk device steps of the streamed trainer (port of
ddt_tpu/ops/stream.py).

The streamed trainer (ddt_tpu_torch/streaming.py) grows each tree level
by level over chunks of rows that do not fit the card together: per level
every chunk adds its rows' histogram into the level's table, with each
row's node found again by routing it through the tree grown so far
(`partial_node_index`, stateless: no per-row state survives a chunk), and
its gradients computed again from the chunk's resident predictions and
labels (`chunk_grads`). Everything here is PyTorch on the chunk's device;
the histogram is K1 (ops/histogram: the kernel on the card, the plain
version on the CPU).

The tables are exact, so they accumulate on the device: f32 gradients
add their 64-bit fixed-point sums (ops/histogram.build_histograms_exact)
into one int64 table per level, quantized ones their int32 sums, each
chunk's kernel adding straight into the table (`out`). Chunked sums then
equal the whole: the streamed tree is the in-memory tree bit for bit, and
nothing is fetched a chunk.

Where the reference folds the previous round's pred update into the next
round's depth-0 pass (it routes every row through the finished trees
again, which needs the chunk's rows), the leaf pass here keeps each row's
leaf slot resident (`stream_leaf_gh` returns it, an int32 heap id: 4
bytes a row and class): the update is then `lr * leaf_value[slot]`, the in-memory fit
loop's own product and add, and needs no chunk read. `stream_round_start`
folds that update into the round's statistics pass (`stream_grad_stats`:
the max |g| and |h| that fix the exact path's scales, and the quantized
path's sums), which reads no chunk either. A tree therefore reads each
chunk max_depth + 1 times (max_depth histogram passes and the leaf pass),
as the reference's folded loop does, and the round's scales exist before
its depth-0 build.

`apply_tree_pred` (= `stream_update_pred`) routes rows through a finished
tree: the resumed trainer's replay of the restored trees and the
validation margins' update.
"""

from __future__ import annotations

import torch

from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import histogram as H
from ddt_tpu_torch.ops.grow import apply_tree_pred, go_right

#: stream_update_pred is apply_tree_pred, as in the reference.
stream_update_pred = apply_tree_pred


def route(Xb: torch.Tensor, feature: torch.Tensor,
          threshold_bin: torch.Tensor, is_leaf: torch.Tensor, depth: int,
          default_left: torch.Tensor | None = None,
          missing_bin_value: int = -1,
          cat_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Heap slot of each row after `depth` routing steps through the
    tree's first `depth` levels (int64 [R]): a row that reached a leaf
    above stays there. The in-memory level loop's (node_id, frozen)
    evolution, recomputed from the node arrays alone."""
    node = torch.zeros(Xb.shape[0], dtype=torch.int64, device=Xb.device)
    feature = feature.to(torch.int64)
    thr = threshold_bin.to(torch.int32)
    for _ in range(depth):
        f = feature[node].clamp(min=0)
        fv = Xb.gather(1, f[:, None])[:, 0].to(torch.int32)
        right = go_right(
            fv, thr[node], None if cat_mask is None else cat_mask[f],
            None if default_left is None else default_left[node],
            missing_bin_value)
        node = torch.where(is_leaf[node], node,
                           2 * node + 1 + right.to(torch.int64))
    return node


def partial_node_index(Xb, feature, threshold_bin, is_leaf, depth: int,
                       default_left=None, missing_bin_value: int = -1,
                       cat_mask=None) -> torch.Tensor:
    """Level-local node per row at `depth` (int32 [R]; -1 = frozen at an
    earlier leaf)."""
    node = route(Xb, feature, threshold_bin, is_leaf, depth, default_left,
                 missing_bin_value, cat_mask)
    offset = (1 << depth) - 1
    return torch.where(node >= offset, node - offset, -1).to(torch.int32)


def chunk_grads(pred: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                weighted: bool, loss: str, class_idx: int = 0,
                row_keep: torch.Tensor | None = None):
    """(g, h) f32 [R] of one class column: the loss's gradients at pred
    times the instance weights (when `weighted`) and the 0/1 bagging mask,
    the in-memory round's elementwise steps on these rows."""
    g, h = grad_ops.grad_hess(pred, y, loss)
    if weighted:
        v = valid[:, None] if g.dim() == 2 else valid
        g, h = g * v, h * v
    if row_keep is not None:
        m = row_keep.to(torch.float32)
        if g.dim() == 2:
            m = m[:, None]
        g, h = g * m, h * m
    if g.dim() == 2:
        g, h = g[:, class_idx].contiguous(), h[:, class_idx].contiguous()
    return g, h


def stream_level_hist(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                      tree, depth: int, out: torch.Tensor, *, n_bins: int,
                      scales: torch.Tensor | None = None,
                      build_left: bool = False, missing_bin_value: int = -1,
                      cat_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Add one chunk's level-`depth` histogram into `out` (int64 on the
    exact path, f32 g/h with `scales`; int32 for quantized g/h): each
    row's node from the partial tree (`tree`: feature, threshold_bin,
    is_leaf, default_left on the chunk's device), LEFT children only,
    keyed by their parent, with `build_left` (sibling subtraction)."""
    feature, thr, is_leaf, dl = tree
    ni = partial_node_index(Xb, feature, thr, is_leaf, depth, dl,
                            missing_bin_value, cat_mask)
    n_nodes = 1 << depth
    if build_left:
        ni = grow_ops.left_children(ni)
        n_nodes //= 2
    return H.build_level(Xb, g, h, ni, n_nodes, n_bins, scales, out=out)


def stream_leaf_gh(Xb: torch.Tensor, gq: torch.Tensor, hq: torch.Tensor,
                   tree, max_depth: int, out: torch.Tensor, *,
                   missing_bin_value: int = -1,
                   cat_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Add one chunk's final-level (G, H) sums of the integer values gq,
    hq (int64 fixed point, or quantized) into `out` [2^max_depth, 2];
    returns each row's leaf slot (the heap node it stopped at, int32: heap
    ids reach 2^(max_depth + 1) - 2, past int16 from depth 15 on)."""
    feature, thr, is_leaf, dl = tree
    node = route(Xb, feature, thr, is_leaf, max_depth, dl,
                 missing_bin_value, cat_mask)
    offset = (1 << max_depth) - 1
    n_last = 1 << max_depth
    out.add_(grad_ops.leaf_gh_sums((node - offset).clamp(0, n_last - 1),
                                   node >= offset, gq, hq, n_last))
    return node.to(torch.int32)


def stream_grad_stats(grads: list, exact: bool) -> torch.Tensor:
    """One chunk's statistics over its per-class (g, h) pairs: f32 [C, 2]
    (max|g|, max|h|) for the exact path, f32 [C, 4] (max|g|, sum|g|,
    max|h|, sum|h|) for quantized gradients (ops/grad.grad_abs_stats'
    terms). The trainer maxes (and sums) them over chunks and ranks."""
    rows = []
    for g, h in grads:
        ag, ah = g.abs(), h.abs()
        if exact:
            rows.append(grad_ops.abs_max2(g, h))
        else:
            rows.append(torch.stack([ag.max(), ag.sum(), ah.max(),
                                     ah.sum()]))
    return torch.stack(rows)


def stream_round_start(pred: torch.Tensor, slots: torch.Tensor | None,
                       leaf_values: list | None, learning_rate: float,
                       grads_fn, exact: bool) -> torch.Tensor:
    """The round-start step of one chunk, no chunk read: the previous
    round's trees added to pred from the resident leaf slots ([C, R]
    int32; leaf_values one f32 [N] a class) in class order, in place,
    then the new round's statistics (stream_grad_stats) of
    grads_fn(pred) -> [(g, h)] a class."""
    if slots is not None:
        apply_slots(pred, slots, leaf_values, learning_rate)
    return stream_grad_stats(grads_fn(pred), exact)


def apply_slots(pred: torch.Tensor, slots: torch.Tensor, leaf_values: list,
                learning_rate: float) -> None:
    """pred[:, c] += lr * leaf_values[c][slot] for each class c (pred [R]
    with one class), in place: the in-memory round's tree_predict_delta
    and add."""
    for c, lv in enumerate(leaf_values):
        delta = learning_rate * lv[slots[c].to(torch.int64)]
        (pred[:, c] if pred.dim() == 2 else pred).add_(delta)
