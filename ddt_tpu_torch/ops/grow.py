"""Whole-tree growth: the level loop, on one device or on each rank of a
hosts x rows x features mesh.

Port of ddt_tpu/ops/grow.py: f32 or quantized gradients, an optional
colsample feature mask, learned missing-value directions, one-vs-rest
categorical splits, row and feature partitions over process groups, and
slab-pipelined histogram collectives. Per level: histograms
(ops/histogram: the CUDA kernel on the card, the plain segment form on the
CPU) -> the histogram collective -> node totals -> best splits (ops/split)
-> node values and split decisions -> row routing. Every step is a
PyTorch op queued on the tensors' device (the collectives are
stream-ordered too); the host reads nothing until the Driver fetches the
finished tree.

Row partitions (`group`, the row group: every rank holding the same
columns, by row shard; None on one device): each rank holds a block of
rows and grows the same tree. The histogram collective (parallel/comms.
hist_reduce) runs after the left-child build and before the sibling
subtraction, so only left children move from level 1 on, and the carry
is the merged form. Under split_comms="allreduce" every rank of the row
group holds the whole merged histogram of its columns. Under
"reduce_scatter" rank i holds the merged F/P slab i of them (`col_ids`
maps its columns to local ids, padded columns never valid): node totals
then come from the row vectors through an all-reduce, the split search
runs on the slab and comms.combine_shard_winners picks the single-device
argmax's winner. Quantized gradients take their scales from the row
group's rows and their rounding draws from global row ids; the final
leaf sums are all-reduced over the row group.

Feature partitions (`feature_group`, every rank holding the same rows,
by feature shard): Xb is the rank's column slab [R, F / Pf] of the
global matrix (zero columns pad the last, and never win), global column
f_lo + j at local j. Node totals come from the row vectors; the split
search runs on the rank's columns (the colsample and categorical masks,
global [n_features], are sliced to them) and the winners, with global
feature ids, are combined over the feature group (allreduce) or over the
world (reduce-scatter, where every rank owns a distinct column set).
Node totals and leaf sums are exact on every rank (integer sums of the
same rows), so every rank of a feature group holds the same ones. The
winning column lives on one feature shard: each rank gathers a row's bin
where it owns the column and 0 elsewhere, and an int32 all-reduce over
the feature group hands every rank the bin (ddt_tpu/ops/grow.py:547-565;
R x 4 bytes a level, counted in comms.other_bytes).

Slabs (`comms_slabs` > 1, ddt_tpu/ops/grow.py:100-220): a level's build
and collective split into feature slabs (`slab_widths`, aligned to the
row shards so only the last pads under reduce-scatter); each slab's
kernel reads its columns in place and its collective is issued
asynchronously, so slab k's wire overlaps slab k+1's kernel, and all are
waited before the concatenation. Integer sums are bitwise at any slab
count; an f32 wire's sums may round differently (the wire's reduction
order depends on where an element falls in its chunks); int32_fixed
quantizes each slab on its own grid.

Exact f32 sums (grad_dtype "f32", ops/grad "EXACT f32 HISTOGRAMS"): once
per tree g and h get a power-of-two scale each from their max over every
row (a MAX all-reduce over the row group), the histogram kernel's exact
mode sums rint(g * 2^k) in int64, and node totals and leaf sums add the
same rounded values in int64. On one device the histogram stays int64
through the sibling subtraction (exact) and the split search (its prefix
sums too), and every aggregate converts to f32 once; the trees then do
not depend on the order the card summed the rows in. Under a process
group each rank's table is exact and converts to f32 before the wire, so
the payload stays the f32 one the payload model counts, and the
collective's order (fixed on one topology) decides the last bits; node
totals and leaf sums cross as f32 the same way.

Routing stays rank-local without a feature axis: the decisions are the
same on every rank.

The OOM ladder (ops/histogram, module docstring) runs at the level step:
`grow_levels` with the backend's `ladder` retries a level (build, sibling
subtraction, split search) one rung lower after an allocation failure,
on one device; rung 1 drops the carried parent table, rungs >= 2 build
and split the level one node slab at a time. Under a process group
(`group` or `feature_group`) the ranks must issue the same collectives
whatever their rungs: the table is built, carried and reduced as at rung
0, and the ladder steps at the split search alone, whose rungs >= 2 split
the reduced table by node slabs; a rank that steps down alone changes no
collective. No rung lowers what a mesh's build allocates, so there an
injected fault is retried where it fired (before the collective) and a
real allocation failure is raised (ops/histogram.HistLadder.retry_build).

Quantized gradients (grad_dtype "int8" | "int16"): g/h are quantized once
per tree (ops/grad.quantize_gradients); histograms, node totals and leaf
sums add the integer q's exactly in int32; the sibling-subtraction carry
keeps the int32 form, so parent - left is exact; and each level's
histogram is dequantized exactly once, hist * (gscale, hscale), before
the gain scan.

Row routing keeps a dense per-row heap node id. The reference packs the
per-node tables into one int32 and selects each row's entry with a one-hot
compare+reduce, because gathers are slow on a TPU; here each row's entry is
a gather, which selects the same integers. A row goes right when its bin
is above the node's threshold; at a categorical node when its bin is not
the node's category; and a row in the reserved missing bin (n_bins - 1,
missing_policy="learn") follows the opposite of the node's learned
default direction (`go_right`, shared with `apply_tree_pred`, which
routes the validation rows of the Driver's eval set through a finished
tree: the reference's ops/stream.apply_tree_pred).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple

import torch

from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import histogram as H
from ddt_tpu_torch.ops import split as S
from ddt_tpu_torch.parallel import comms


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


def slab_widths(F: int, slabs: int, row_shards: int) -> list[int]:
    """Feature-slab widths of the slab-pipelined build + collective (the
    reference's grow._slab_widths): each but the last a multiple of
    `row_shards`, so that under reduce-scatter only the last slab pads.
    [F] when pipelining is off or F too narrow to split."""
    if slabs <= 1:
        return [F]
    fc = -(-F // (slabs * row_shards)) * row_shards
    if fc <= 0 or fc >= F:
        return [F]
    return [min(fc, F - i) for i in range(0, F, fc)]


def _no_reduce(x, async_op: bool = False):
    return comms.Pending(x) if async_op else x


def assemble_subtracted(parent_hist: torch.Tensor, hist_left: torch.Tensor,
                        parent_split: torch.Tensor) -> torch.Tensor:
    """A level's [n_level, F, B, 2] histograms from the previous level's
    (merged) ones and this level's LEFT children: right = parent - left,
    exactly zero under a parent that did not split (a frozen parent's
    phantom right child would otherwise inherit its mass), interleaved
    back to level order (left 2p, right 2p + 1)."""
    half = hist_left.shape[0]
    gate = parent_split.reshape(half, 1, 1, 1)
    hist_right = torch.where(gate, parent_hist - hist_left, 0)
    hist = torch.stack([hist_left, hist_right], dim=1)
    return hist.reshape((2 * half,) + hist_left.shape[1:])


def level_histograms(Xb, g, h, node_index, n_level: int, n_bins: int, *,
                     parent_hist=None, parent_split=None,
                     reduce=None, widths=None,
                     scales: torch.Tensor | None = None,
                     span=None, ladder=None) -> torch.Tensor:
    """One level's [n_level, F, B, 2] histograms, merged over the ranks by
    `reduce(hist, async_op)` (the histogram collective; None on one
    device): the merged slab under reduce-scatter.

    `widths` (slab_widths) pipelines the build and the collective over
    feature slabs: each slab's kernel reads columns [lo, lo + w) of Xb in
    place and its collective is issued asynchronously before the next
    slab's kernel; the merged slabs are concatenated.

    With the previous level's (merged) histograms and split decisions,
    only LEFT children are built from rows and merged (half the kernel
    work and half the payload); each right child is parent - left, and
    children of parents that did not split are exactly zero (otherwise a
    frozen parent's phantom right child would inherit its mass and could
    win a split no training row reaches). Dtype-generic: on the quantized
    path the carry and the left build are int32, on the exact path
    (`scales`: f32 g/h summed in fixed point, ops/histogram.
    build_histograms_exact) int64 until `reduce` converts it, and the
    subtraction is exact.

    Every build goes through ops/histogram.build_table (the `hist.build`
    seam); with `ladder` (on a mesh) an injected fault at a build is
    retried there, before its collective, and a real allocation failure
    raised (HistLadder.retry_build). `span` (the partition recorder's
    `span("hist")`, or None) times each build on this rank before its
    collective is issued, so another rank's lateness does not show in
    this rank's lane."""
    if reduce is None:
        reduce = _no_reduce
    widths = widths or [Xb.shape[1]]

    def build_once(X, ni, n_nodes):
        if span is None:
            return H.build_table(X, g, h, ni, n_nodes, n_bins, scales)
        with span():
            return H.build_table(X, g, h, ni, n_nodes, n_bins, scales)

    def build(X, ni, n_nodes):
        if ladder is None:
            return build_once(X, ni, n_nodes)
        return ladder.retry_build(lambda: build_once(X, ni, n_nodes))

    def build_reduced(ni, n_nodes):
        if len(widths) == 1:
            return reduce(build(Xb, ni, n_nodes))
        pending, lo = [], 0
        for w in widths:
            pending.append(reduce(build(Xb[:, lo:lo + w], ni, n_nodes),
                                  async_op=True))
            lo += w
        return torch.cat([p.wait() for p in pending], dim=1)

    if parent_hist is None or n_level < 2:
        return build_reduced(node_index, n_level)
    li = left_children(node_index)
    return assemble_subtracted(parent_hist, build_reduced(li, n_level // 2),
                               parent_split)


def left_children(node_index: torch.Tensor) -> torch.Tensor:
    """Level-local node index of the rows of LEFT children, keyed by their
    parent (node // 2); -1 for right children and frozen rows."""
    is_left = (node_index >= 0) & (node_index % 2 == 0)
    return torch.where(is_left, node_index // 2, -1).to(torch.int32)


def split_level(hist: torch.Tensor, G: torch.Tensor, Hh: torch.Tensor, *,
                reg_lambda: float, min_child_weight: float,
                feature_mask=None, missing_bin: bool = False, cat_mask=None,
                dequant: torch.Tensor | None = None,
                inv_scale: torch.Tensor | None = None):
    """Best splits of one level from its histogram and node totals (G, Hh
    [n_level]): the one conversion of integer sums to f32 and the split
    search. Quantized (`dequant`, the f32 [2] scales): hist, G and Hh are
    the raw integer sums, dequantized once before the gain scan. Exact
    path (an int64 hist with `inv_scale`, its f32 [2] 2^-k): G and Hh
    convert once, the split search takes the int64 hist (ops/split).
    Returns (gains, feats, bins, default_left, G, Hh) with f32 G, Hh."""
    if dequant is not None:
        G = G.to(torch.float32) * dequant[0]
        Hh = Hh.to(torch.float32) * dequant[1]
        hist = hist.to(torch.float32) * dequant
    elif not G.is_floating_point():
        G = G.to(torch.float32) * inv_scale[0]
        Hh = Hh.to(torch.float32) * inv_scale[1]
    gains, feats, bins, dls = S.best_splits_impl(
        hist, reg_lambda, min_child_weight, feature_mask,
        missing_bin=missing_bin, cat_mask=cat_mask,
        inv_scale=None if hist.is_floating_point() else inv_scale)
    return gains, feats, bins, dls, G, Hh


def split_by_slabs(split, n_level: int, per: int, slab):
    """`split` (split_level's partial) over node slabs of `per` nodes:
    slab(lo, hi) -> (hist, G, Hh) of nodes [lo, hi), each split before
    the next is made, the [n_level] results concatenated (the split
    search is per node, so they are bitwise the whole level's)."""
    if per >= n_level:
        return split(*slab(0, n_level))
    parts = [split(*slab(lo, min(n_level, lo + per)))
             for lo in range(0, n_level, per)]
    return tuple(torch.cat(p) for p in zip(*parts))


def new_tree(max_depth: int, n_rows: int, device) -> "TreeArrays":
    """Empty node arrays of one depth-`max_depth` heap tree, every row at
    the root."""
    N = 2 ** (max_depth + 1) - 1
    return TreeArrays(
        torch.full((N,), -1, dtype=torch.int32, device=device),
        torch.zeros(N, dtype=torch.int32, device=device),
        torch.zeros(N, dtype=torch.bool, device=device),
        torch.zeros(N, dtype=torch.float32, device=device),
        torch.zeros(N, dtype=torch.float32, device=device),
        torch.zeros(N, dtype=torch.bool, device=device),
        torch.zeros(n_rows, dtype=torch.int32, device=device))


def record_level(tree: "TreeArrays", depth: int, gains, feats, bins, dls,
                 G, Hh, *, reg_lambda: float,
                 min_split_gain: float) -> torch.Tensor:
    """Write level `depth`'s decisions into the tree's node arrays in
    place: a node splits when its gain passes min_split_gain and it holds
    hessian mass, else it is a leaf of value -G / (H + lambda). Returns
    do_split, bool [2^depth]."""
    n_level = 1 << depth
    offset = n_level - 1
    # An empty node at reg_lambda = 0 would store -0/0 = NaN, which a
    # predict-time row can reach: guarded to 0.
    value = torch.where(Hh > 0, -G / (Hh + reg_lambda), 0.0)
    do_split = (gains > min_split_gain) & torch.isfinite(gains) & (Hh > 0)
    sl = slice(offset, offset + n_level)
    tree.feature[sl] = torch.where(do_split, feats, -1)
    tree.threshold_bin[sl] = torch.where(do_split, bins, 0)
    tree.is_leaf[sl] = ~do_split
    tree.leaf_value[sl] = torch.where(do_split, 0.0, value)
    tree.split_gain[sl] = torch.where(do_split, gains, 0.0)
    tree.default_left[sl] = do_split & dls
    return do_split


def record_leaves(tree: "TreeArrays", max_depth: int, Gl, Hl,
                  reg_lambda: float) -> None:
    """The last level's leaf values from its f32 (G, H) sums, in place."""
    offset = (1 << max_depth) - 1
    n_last = 1 << max_depth
    vals = torch.where(Hl > 0, -Gl / (Hl + reg_lambda), 0.0)
    sl = slice(offset, offset + n_last)
    tree.is_leaf[sl] = True
    tree.leaf_value[sl] = vals


def go_right(fv: torch.Tensor, thr: torch.Tensor, cat: torch.Tensor | None,
             dl: torch.Tensor | None, missing_bin_value: int
             ) -> torch.Tensor:
    """The routing rule (bool): per row its bin `fv` and its node's
    threshold `thr`, categorical flag `cat` and default direction `dl`
    (None where the model has no such nodes or no missing bin)."""
    right = fv > thr
    if cat is not None:
        # One-vs-rest: the matched category goes left.
        right = torch.where(cat, fv != thr, right)
    if dl is not None and missing_bin_value >= 0:
        right = torch.where(fv == missing_bin_value, ~dl, right)
    return right


def cat_feature_mask(cat_features, n_features: int,
                     device) -> torch.Tensor | None:
    """bool [n_features] of the one-vs-rest columns, or None when there are
    none (the reference's ops/split.cat_feature_vec)."""
    if not cat_features:
        return None
    if max(cat_features) >= n_features:
        raise ValueError(f"cat_features index {max(cat_features)} out of "
                         f"range for {n_features} features")
    m = torch.zeros(n_features, dtype=torch.bool, device=device)
    m[list(cat_features)] = True
    return m


class TreeArrays(NamedTuple):
    """One grown tree in heap layout + per-row leaf assignment."""

    feature: torch.Tensor        # int32 [n_nodes_total], -1 on leaves
    threshold_bin: torch.Tensor  # int32 [n_nodes_total]
    is_leaf: torch.Tensor        # bool  [n_nodes_total]
    leaf_value: torch.Tensor     # f32 [n_nodes_total]
    split_gain: torch.Tensor     # f32 [n_nodes_total], 0 on leaves
    default_left: torch.Tensor   # bool  [n_nodes_total] NaN-row direction
    leaf_of_row: torch.Tensor    # int32 [R] heap slot where each row landed


def grow_tree(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor, *,
              max_depth: int, n_bins: int, reg_lambda: float,
              min_child_weight: float, min_split_gain: float,
              hist_subtraction: bool = False, grad_dtype: str = "f32",
              quant_tree_id=0, quant_seed: int = 0,
              feature_mask: torch.Tensor | None = None,
              missing_bin: bool = False,
              cat_mask: torch.Tensor | None = None, group=None,
              split_comms: str = "allreduce",
              hist_comms_dtype: str = "f32", feature_group=None,
              world_group=None, n_features: int | None = None,
              comms_slabs: int = 1, row_shard: int | None = None,
              shard_ordered: bool = False, hist_span=None,
              ladder=None, level_probe=None) -> TreeArrays:
    """Grow one complete-heap tree from uint8 Xb [R, F] and f32 g, h [R]
    (the same decisions as ddt_tpu/ops/grow.grow_tree).

    grad_dtype "f32" sums in 64-bit fixed point (module docstring, "Exact
    f32 sums"); "int8"/"int16" quantizes g/h once, keyed by (quant_seed,
    quant_tree_id, global row), the tree id an int or a 0-dim int64
    tensor on Xb's device; feature_mask (bool [n_features] on Xb's
    device, False = excluded) restricts every level's split candidates
    (colsample). missing_bin: bin n_bins - 1 holds NaN rows and every
    split learns their direction; cat_mask (bool [n_features] on Xb's
    device, from cat_feature_mask) marks the one-vs-rest columns. With
    `group` (the row group), Xb, g and h are this rank's block of a
    row-partitioned matrix (row shard s's rows start at global row s * R)
    and split_comms ("allreduce" | "reduce_scatter", resolved),
    hist_comms_dtype and comms_slabs pick the histogram collective. With
    `feature_group`, Xb holds this rank's columns [f * F, (f + 1) * F) of
    the n_features global ones (f the rank in the feature group; columns
    past n_features are padding), and `world_group` is every rank (the
    winner combine under reduce-scatter). Returned feature ids are
    global (module docstring).

    `row_shard` is the row shard Xb holds (default: the rank's place in
    the row group; after a straggler rotation, the shard the rank holds
    now): the rounding draws' global rows start at row_shard * R.
    `shard_ordered` (cfg.straggler_repartition) makes the reductions over
    the row group independent of which rank holds which shard: on an f32
    wire the exact path's aggregates cross it as int64 (exact, so the
    trees are one device's), and the quantized path's |g| / |h| sums add
    in shard order (comms.psum_ordered); int32_fixed is order-free as it
    is, a bf16 wire's f32 sums are not. `hist_span` times each histogram
    build (level_histograms' `span`)."""
    R, F = Xb.shape
    dev = Xb.device
    P = comms.world(group)
    on_mesh = group is not None or feature_group is not None
    if ladder is None:
        ladder = H.HistLadder(carry=hist_subtraction and not on_mesh)
    if row_shard is None:
        row_shard = comms.rank(group)
    rs = split_comms == "reduce_scatter" and group is not None
    fsh = feature_group is not None
    Fg = F if n_features is None else n_features
    f_lo = comms.rank(feature_group) * F
    widths = slab_widths(F, comms_slabs, P)
    quant = grad_dtype != "f32"
    scales = inv = dequant = None
    if quant:
        g, h, gscale, hscale = grad_ops.quantize_gradients(
            g, h, grad_dtype=grad_dtype, tree_id=quant_tree_id,
            seed=quant_seed, row_start=row_shard * R, group=group,
            n_rows_global=R * P,
            shard=row_shard if shard_ordered else None)
        dequant = torch.stack([gscale, hscale])    # [2] dequantize vector
        gq, hq = g, h
    else:
        # The tree's fixed-point grid: 2^k per channel from the global
        # max over every rank's rows.
        scales = grad_ops.fixed_scales(
            comms.pmax(grad_ops.abs_max2(g, h), group), R * P)
        inv = grad_ops.fixed_inverse(scales)
        gq = grad_ops.to_fixed(g, scales[0])
        hq = grad_ops.to_fixed(h, scales[1])

    int_wire = shard_ordered and hist_comms_dtype == "f32"

    def to_wire(x):
        """An exact rank-local int64 aggregate as f32 for a collective
        (as int64 itself on the int64 wire)."""
        if scales is None or int_wire:
            return x
        return x.to(torch.float32) * inv

    def hist_collective(hs, async_op=False):
        if group is None:
            return _no_reduce(hs, async_op)
        hs = to_wire(hs)
        if rs:
            hs = comms.pad_to_multiple(hs, 1, P)
        return comms.hist_reduce(
            hs, group, mode="reduce_scatter" if rs else "allreduce",
            comms_dtype=hist_comms_dtype, scatter_dim=1, async_op=async_op)

    fm_loc, cm_loc = feature_mask, cat_mask
    if fsh:
        # The rank's columns: global ids f_lo + j, real below Fg (the
        # zero padding never wins); the global masks sliced to them.
        gid = f_lo + torch.arange(F, dtype=torch.int64, device=dev)
        real = gid < Fg
        gcl = gid.clamp(max=Fg - 1)
        fm_loc = real if feature_mask is None else feature_mask[gcl] & real
        cm_loc = None if cat_mask is None else cat_mask[gcl] & real
    if rs:
        # Rank i's scattered slab: from each pipelined slab of width w
        # (padded to P * b) its contiguous block of b local columns;
        # padded ids (>= F) are never candidates.
        parts, lo = [], 0
        for w in widths:
            b = -(-w // P)
            parts.append(lo + comms.rank(group) * b + torch.arange(
                b, dtype=torch.int64, device=dev))
            lo += w
        col_ids = parts[0] if len(parts) == 1 else torch.cat(parts)
        valid_loc = col_ids < F
        cid = col_ids.clamp(max=F - 1)
        fm_loc = valid_loc if fm_loc is None else fm_loc[cid] & valid_loc
        cm_loc = None if cm_loc is None else cm_loc[cid] & valid_loc
    # The winner combine: over every rank holding a distinct column set.
    combine_group = world_group if rs and fsh else group if rs \
        else feature_group

    def row_sums(x, modeled=False):
        """Per-node sums of the row vectors over the row group (as f32
        on the exact path's wire)."""
        return comms.psum(to_wire(x) if group is not None else x, group,
                          modeled=modeled)

    tree = new_tree(max_depth, R, dev)
    node_id = tree.leaf_of_row
    frozen = torch.zeros(R, dtype=torch.bool, device=dev)

    def level(depth, parent_hist, parent_split, rung, split):
        """One level's split results and its table to carry (None at a
        rung that carries none); `rung` is the ladder's (module
        docstring)."""
        offset = (1 << depth) - 1
        n_level = 1 << depth
        # In place: one [R] int32 buffer, no temporary beside it.
        node_index = torch.sub(node_id, offset).masked_fill_(frozen, -1)
        per = H.slab_nodes(rung, n_level)
        if not on_mesh and per < n_level:
            # One node slab at a time, each table freed before the next.
            def slab(lo, hi):
                with hist_span() if hist_span else nullcontext():
                    hs = H.build_table(Xb, g, h, node_index, hi - lo, n_bins,
                                       scales, node_lo=lo)
                return (hs,) + S.node_totals(hs)

            return split_by_slabs(split, n_level, per, slab), None
        hist = level_histograms(Xb, g, h, node_index, n_level, n_bins,
                                parent_hist=parent_hist,
                                parent_split=parent_split,
                                reduce=hist_collective, widths=widths,
                                scales=scales, span=hist_span,
                                ladder=ladder if on_mesh else None)
        if rs or fsh:
            # The ranks hold different columns: node totals from the row
            # vectors, one all-reduce of the [n_level, 2] pair.
            GH = row_sums(grad_ops.leaf_gh_sums(
                node_index.clamp(min=0), node_index >= 0, gq, hq, n_level))
            G, Hh = GH[:, 0], GH[:, 1]
        else:
            G, Hh = S.node_totals(hist)
        if not on_mesh:
            return split(hist, G, Hh), hist if rung == 0 else None

        def slab(lo, hi):
            return hist[lo:hi], G[lo:hi], Hh[lo:hi]

        # On a mesh the split search alone is retried and slabbed.
        return ladder.run(lambda r: split_by_slabs(
            split, n_level, H.slab_nodes(r, n_level), slab)), hist

    def winners(gains, feats, bins, dls):
        if rs:
            feats = col_ids[feats.to(torch.int64)].to(torch.int32)
        if combine_group is not None:
            gains, feats, bins, dls = comms.combine_shard_winners(
                gains, feats + f_lo, bins, dls, combine_group,
                n_features=F * comms.world(feature_group), n_bins=n_bins,
                missing_bin=missing_bin)
        return gains, feats, bins, dls

    def route(depth, feats, bins, dls, do_split):
        """Route rows through the new splits: gather each row's node
        entry."""
        nonlocal frozen
        offset = (1 << depth) - 1
        n_level = 1 << depth
        idx = (node_id - offset).clamp(0, n_level - 1).to(torch.int64)
        split_here = do_split[idx] & ~frozen
        feat_r = feats[idx].to(torch.int64)
        if fsh:
            # The owner of the winning column gathers, the others add 0.
            loc = feat_r - f_lo
            own = (loc >= 0) & (loc < F)
            fv = torch.where(own, Xb.gather(
                1, loc.clamp(0, F - 1)[:, None])[:, 0].to(torch.int32), 0)
            fv = comms.psum(fv, feature_group)
        else:
            fv = Xb.gather(1, feat_r[:, None])[:, 0].to(torch.int32)
        right = go_right(
            fv, bins[idx],
            None if cat_mask is None
            else cat_mask[feats.clamp(max=Fg - 1)][idx],
            dls[idx] if missing_bin else None,
            n_bins - 1 if missing_bin else -1).to(torch.int32)
        node_id.copy_(torch.where(split_here, 2 * node_id + 1 + right,
                                  node_id))
        frozen = frozen | ~split_here

    def leaf_sums():
        offset = (1 << max_depth) - 1
        n_last = 1 << max_depth
        idx = (node_id - offset).clamp(0, n_last - 1)
        return row_sums(grad_ops.leaf_gh_sums(idx, ~frozen, gq, hq, n_last),
                        modeled=True)

    # The histogram carry keeps the integer form off the wire.
    return grow_levels(
        tree, max_depth, level, leaf_sums, reg_lambda=reg_lambda,
        min_child_weight=min_child_weight, min_split_gain=min_split_gain,
        hist_subtraction=hist_subtraction, feature_mask=fm_loc,
        missing_bin=missing_bin, cat_mask=cm_loc, dequant=dequant,
        inv_scale=inv,
        winners=winners if rs or combine_group is not None else None,
        route=route, ladder=None if on_mesh else ladder,
        level_probe=level_probe)


def grow_levels(tree: TreeArrays, max_depth: int, level, leaf_sums, *,
                reg_lambda: float, min_child_weight: float,
                min_split_gain: float, hist_subtraction: bool,
                feature_mask=None, missing_bin: bool = False,
                cat_mask=None, dequant: torch.Tensor | None = None,
                inv_scale: torch.Tensor | None = None, winners=None,
                route=None, ladder=None, level_probe=None) -> TreeArrays:
    """The level loop of both trainers (grow_tree in memory, the streamed
    trainer over chunks), filling `tree`'s node arrays in place.

    Per depth: `level(depth, parent_hist, parent_split, rung, split) ->
    (split results, table to carry or None)` builds the level's merged
    histogram (right children by sibling subtraction when parent_hist is
    given: the previous level's table and do_split, passed with
    `hist_subtraction`) and its node totals, in their integer or f32
    form, and hands them to `split` (split_level with this loop's
    settings: it converts them once, `dequant` quantized, `inv_scale`
    exact, and finds the best splits), whole or by node slabs.
    With `ladder` (one device) the level step runs at the ladder's rung
    and again one rung lower after an allocation failure; a rung above 0
    gets no parent table, and the carry is dropped before the level
    runs again. Without it `rung` is 0 (the streamed trainer, whose
    builds retry an injected fault only, and a mesh, whose split search
    takes the ladder inside `level`). `level_probe(depth, parent_table,
    run)` (None: off) is handed each level step as `run` and returns its
    result: chip_smoke.py reads a level's peak memory there. `winners(
    gains, feats, bins, dls)` maps them to global features (partitioned
    columns; None keeps them); record_level writes the decisions;
    `route(depth, feats, bins, dls, do_split)` moves the
    rows (None where the caller routes from the node arrays). Then
    `leaf_sums()` gives the last level's [2^max_depth, 2] (G, H),
    converted to f32 once, and record_leaves."""
    def split(hist, G, Hh):
        return split_level(
            hist, G, Hh, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight, feature_mask=feature_mask,
            missing_bin=missing_bin, cat_mask=cat_mask, dequant=dequant,
            inv_scale=inv_scale)

    carry = [None, None]            # the parent's table and do_split
    for depth in range(max_depth):
        def step(rung, depth=depth):
            if rung > 0:
                carry[0] = None     # a lower rung holds no parent table
            return level(depth, carry[0], carry[1], rung, split)

        def run(step=step):
            return step(0) if ladder is None else ladder.run(step)

        res, hist = run() if level_probe is None \
            else level_probe(depth, carry[0], run)
        gains, feats, bins, dls, G, Hh = res
        if winners is not None:
            gains, feats, bins, dls = winners(gains, feats, bins, dls)
        do_split = record_level(tree, depth, gains, feats, bins, dls, G, Hh,
                                reg_lambda=reg_lambda,
                                min_split_gain=min_split_gain)
        if route is not None:
            route(depth, feats, bins, dls, do_split)
        if hist_subtraction and hist is not None:
            carry[:] = [hist, do_split]
        else:
            carry[:] = [None, None]
        # The carry list is the table's one reference: a step down at the
        # next level drops it there.
        del hist

    # Final level: leaf values from per-terminal-node (G, H) sums.
    GH = leaf_sums()
    if not GH.is_floating_point():
        GH = GH.to(torch.float32) * (dequant if dequant is not None
                                     else inv_scale)
    record_leaves(tree, max_depth, GH[:, 0], GH[:, 1], reg_lambda)
    return tree


def tree_predict_delta(tree: TreeArrays,
                       learning_rate: float) -> torch.Tensor:
    """Per-row raw-score increment of a freshly grown tree: lr * the value
    of the slot each row landed in (no re-traversal during training)."""
    return learning_rate * tree.leaf_value[tree.leaf_of_row.to(torch.int64)]


def apply_tree_pred(Xb: torch.Tensor, pred: torch.Tensor, feature,
                    threshold_bin, is_leaf, leaf_value, default_left=None,
                    *, max_depth: int, learning_rate: float,
                    class_idx: int = 0, missing_bin_value: int = -1,
                    cat_mask: torch.Tensor | None = None) -> None:
    """pred (column class_idx of an [R, C] pred) += lr * the leaf value
    each row of Xb reaches in one finished tree, in place: the Driver's
    eval-set margins, updated tree by tree as the fit loop updates its own
    (the same f32 product and add, in tree order). Node arrays [N] on
    Xb's device; plain PyTorch routing by gathers (the reference's
    ops/stream.apply_tree_pred). A row stops at the first leaf on its
    path."""
    node = torch.zeros(Xb.shape[0], dtype=torch.int64, device=Xb.device)
    feature = feature.to(torch.int64)
    thr = threshold_bin.to(torch.int32)
    for _ in range(max_depth):
        f = feature[node].clamp(min=0)
        fv = Xb.gather(1, f[:, None])[:, 0].to(torch.int32)
        right = go_right(
            fv, thr[node], None if cat_mask is None else cat_mask[f],
            None if default_left is None else default_left[node],
            missing_bin_value)
        node = torch.where(is_leaf[node], node,
                           2 * node + 1 + right.to(torch.int64))
    delta = learning_rate * leaf_value[node]
    if pred.dim() == 2:
        pred[:, class_idx].add_(delta)
    else:
        pred.add_(delta)
