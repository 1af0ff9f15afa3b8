"""LightGBM model.txt interop.

Port of ddt_tpu/models/lightgbm_io.py (plain Python and numpy): for the
same ensemble `to_lightgbm_text` writes the reference's text byte for
byte, and each package parses the other's text into equal arrays.

`to_lightgbm_text` renders a TreeEnsemble in LightGBM's plain-text model
format, so LightGBM's tooling (Booster(model_str=...), SHAP, treelite) can
load a model trained here and a model can be diffed tree by tree against
a LightGBM run. `from_lightgbm_text` parses it back.

Format notes (LightGBM's text serialization, stable since v2):
- one `Tree=<i>` block per tree; arrays are space-separated lines
- internal nodes are numbered 0..num_leaves-2, leaves 0..num_leaves-1;
  child references encode leaves as ~leaf_idx (i.e. -(leaf_idx+1))
- routing: value <= threshold goes LEFT (this repo's threshold_raw rule)
- decision_type bit 1 (value 2) = missing values default LEFT; bits 2-3
  = missing type (0 none, 1 zero, 2 NaN)
- leaf_value carries the final additive contribution (shrinkage already
  applied); the ensemble's base score is folded into the first round's
  leaves (LightGBM's boost_from_average does the same)

Exportable models: ordinal splits need raw thresholds (train through a
BinMapper). Categorical one-vs-rest splits export as LightGBM categorical
nodes (decision_type bit 0): the node's `threshold` indexes
`cat_boundaries`, which offsets into the `cat_threshold` uint32 bitset
array; a value v routes LEFT when bit v is set, and every exported bitset
has exactly one bit. NaN on categorical nodes follows the node's default
direction, as this repo's traversal does; that differs from LightGBM's
own NaN-in-categorical convention, so `to_lightgbm_text` warns when a
model mixes the two.

Import breadth: the parser also takes multi-bit bitsets (a LightGBM
categorical split sends a set of categories left). A k-bit set becomes a
chain of k one-vs-rest nodes: link j tests one member (matched goes LEFT
into a copy of the original left subtree), and the last link's right
child is the original right subtree. Routing is equivalent, NaN rows
included (they follow the node's default direction at every link). Each
such node adds k-1 levels of depth (past depth 30 the heap overflows and
the parser raises, naming the cause), the left subtree is copied k times,
and split_gain is kept on the first link only, so gain importances are
unchanged.
"""

from __future__ import annotations

import warnings

import numpy as np

from ddt_tpu_torch.models.tree import TreeEnsemble

_MISSING_NAN = 2 << 2        # decision_type missing-type field: NaN
_DEFAULT_LEFT = 2            # decision_type default-left bit
_CATEGORICAL = 1             # decision_type categorical-split bit


def _objective(ens: TreeEnsemble) -> str:
    if ens.loss == "logloss":
        return "binary sigmoid:1"
    if ens.loss == "softmax":
        return f"multiclass num_class:{ens.n_classes}"
    return "regression"


def _fmt(values) -> str:
    return " ".join(f"{float(v):.17g}" for v in values)


def _fmt_int(values) -> str:
    return " ".join(str(int(v)) for v in values)


def to_lightgbm_text(ens: TreeEnsemble,
                     feature_names: list[str] | None = None) -> str:
    """Render the ensemble as a LightGBM model.txt string."""
    if not ens.has_raw_thresholds:
        raise ValueError(
            "LightGBM export needs raw-value thresholds; train through a "
            "BinMapper (api.train) or fill them with "
            "api.fill_raw_thresholds first"
        )
    cat_set = (set(int(f) for f in ens.cat_features)
               if ens.has_cat_splits else set())
    if feature_names is None:
        feature_names = [f"Column_{i}" for i in range(ens.n_features)]
    C = ens.n_classes if ens.loss == "softmax" else 1
    lines = [
        "tree",
        "version=v3",
        f"num_class={C}",
        f"num_tree_per_iteration={C}",
        "label_index=0",
        f"max_feature_idx={ens.n_features - 1}",
        f"objective={_objective(ens)}",
        "feature_names=" + " ".join(feature_names),
        "feature_infos=" + " ".join(["[-inf:inf]"] * ens.n_features),
        "",
    ]
    use_missing = ens.missing_bin and ens.default_left is not None
    if use_missing and cat_set:
        warnings.warn(
            "exporting a model with BOTH learned NaN default directions "
            "and categorical splits: this repo routes NaN on categorical "
            "nodes by the per-node default direction, which differs from "
            "LightGBM's own NaN-in-categorical convention — the exported "
            "model scores NaN rows differently when loaded into real "
            "LightGBM (module docstring, 'NaN handling')",
            stacklevel=2,
        )
    for t in range(ens.n_trees):
        # Pre-order walk of the heap: internal nodes and leaves numbered
        # in encounter order (root = internal 0, LightGBM's convention).
        split_feature: list[int] = []
        split_gain: list[float] = []
        threshold: list[float] = []
        decision_type: list[int] = []
        left_child: list[int] = []
        right_child: list[int] = []
        leaf_value: list[float] = []
        cat_boundaries: list[int] = [0]    # prefix offsets into cat words
        cat_threshold: list[int] = []      # uint32 bitset words

        def walk(slot: int) -> int:
            """Returns the LightGBM child reference for heap `slot`:
            internal index, or ~leaf_idx for a leaf."""
            if ens.is_leaf[t, slot] or ens.feature[t, slot] < 0:
                v = float(ens.leaf_value[t, slot]) * ens.learning_rate
                if t < C:                      # fold base into round 0
                    v += ens.base_score
                leaf_value.append(v)
                return -len(leaf_value)        # ~(leaf_idx) == -(idx+1)
            i = len(split_feature)
            feat = int(ens.feature[t, slot])
            split_feature.append(feat)
            split_gain.append(float(ens.split_gain[t, slot]))
            dt = 0
            if feat in cat_set:
                # One-vs-rest: a single-bit bitset (matched category goes
                # LEFT); threshold holds the index into cat_boundaries.
                k = int(ens.threshold_bin[t, slot])
                words = [0] * (k // 32 + 1)
                words[k // 32] = 1 << (k % 32)
                threshold.append(float(len(cat_boundaries) - 1))
                cat_threshold.extend(words)
                cat_boundaries.append(len(cat_threshold))
                dt |= _CATEGORICAL
            else:
                threshold.append(float(ens.threshold_raw[t, slot]))
            if use_missing:
                dt |= _MISSING_NAN
                if ens.default_left[t, slot]:
                    dt |= _DEFAULT_LEFT
            decision_type.append(dt)
            left_child.append(0)               # patched after recursion
            right_child.append(0)
            left_child[i] = walk(2 * slot + 1)
            right_child[i] = walk(2 * slot + 2)
            return i

        walk(0)
        n_leaves = len(leaf_value)
        n_cat = len(cat_boundaries) - 1
        zeros = [0.0] * n_leaves
        izeros = [0] * max(1, n_leaves - 1)
        lines += [
            f"Tree={t}",
            f"num_leaves={n_leaves}",
            f"num_cat={n_cat}",
            "split_feature=" + _fmt_int(split_feature),
            "split_gain=" + _fmt(split_gain),
            "threshold=" + _fmt(threshold),
            "decision_type=" + _fmt_int(decision_type),
            "left_child=" + _fmt_int(left_child),
            "right_child=" + _fmt_int(right_child),
            "leaf_value=" + _fmt(leaf_value),
            "leaf_weight=" + _fmt(zeros),
            "leaf_count=" + _fmt_int([0] * n_leaves),
            "internal_value=" + _fmt([0.0] * max(1, n_leaves - 1)),
            "internal_weight=" + _fmt([0.0] * max(1, n_leaves - 1)),
            "internal_count=" + _fmt_int(izeros),
        ]
        if n_cat:
            lines += [
                "cat_boundaries=" + _fmt_int(cat_boundaries),
                "cat_threshold=" + _fmt_int(cat_threshold),
            ]
        lines += [
            "is_linear=0",
            f"shrinkage={ens.learning_rate:.17g}",
            "",
        ]
    lines += ["end of trees", "", "pandas_categorical:null", ""]
    return "\n".join(lines)


def _parse_block(lines: list[str], i: int) -> tuple[dict, int]:
    d: dict = {}
    while i < len(lines) and lines[i].strip():
        k, _, v = lines[i].partition("=")
        d[k] = v
        i += 1
    return d, i


def from_lightgbm_text(text: str) -> TreeEnsemble:
    """Parse a LightGBM model.txt back into a TreeEnsemble (heap layout).

    Supports what to_lightgbm_text writes (numerical splits, single-bit
    categorical nodes, optional NaN-missing default directions) PLUS
    externally-trained models with multi-category bitsets, which expand
    into equivalent one-vs-rest chains (module docstring, 'Import
    breadth'). Trees deeper than 30 levels after chain expansion overflow
    the heap and raise."""
    lines = text.splitlines()
    head, i = _parse_block(lines, 0)
    n_features = int(head["max_feature_idx"]) + 1
    C = int(head.get("num_class", 1))
    obj = head.get("objective", "regression")
    loss = ("logloss" if obj.startswith("binary")
            else "softmax" if obj.startswith("multiclass") else "mse")

    trees = []
    while i < len(lines):
        if not lines[i].startswith("Tree="):
            i += 1
            continue
        blk, i = _parse_block(lines, i)
        trees.append(blk)

    # Per-internal-node category-bit lists (None for numerical nodes),
    # parsed ONCE per tree: both the depth computation and the placement
    # need them — a k-bit categorical set expands into a k-link chain, so
    # it contributes k levels of depth where a numerical node adds 1.
    def bits_of(blk, t: int) -> list:
        if int(blk["num_leaves"]) == 1:
            return []
        sf = [int(v) for v in blk["split_feature"].split()]
        th = [float(v) for v in blk["threshold"].split()]
        dt = [int(float(v)) for v in blk["decision_type"].split()]
        cb = ct = None
        if int(blk.get("num_cat", "0")) != 0:
            cb = [int(v) for v in blk["cat_boundaries"].split()]
            ct = [int(v) for v in blk["cat_threshold"].split()]
        out: list = []
        for ref in range(len(sf)):
            if not (dt[ref] & _CATEGORICAL):
                out.append(None)
                continue
            if cb is None:
                # Malformed/foreign input: categorical decision_type bit
                # set but the tree block carries no bitset arrays. Fail
                # loudly like the other validation paths (a None subscript
                # would raise an opaque TypeError here otherwise).
                raise ValueError(
                    f"tree {t} node {ref}: categorical decision_type but "
                    "num_cat=0 (no cat_boundaries/cat_threshold arrays)"
                )
            cat_idx = int(th[ref])
            words = ct[cb[cat_idx]:cb[cat_idx + 1]]
            bits = [w * 32 + b for w, word in enumerate(words)
                    for b in range(32) if word >> b & 1]
            if not bits and (dt[ref] >> 2) == 2 and dt[ref] & _DEFAULT_LEFT:
                # Empty bitset + NaN-missing + default-LEFT: no category
                # matches, but NaN rows still exit into the LEFT subtree,
                # so the node cannot collapse away. Emit one match-nothing
                # link (sentinel category -1: LightGBM category values are
                # non-negative, so no real value ever equals it) whose
                # default_left carries the NaN route.
                bits = [-1]
            out.append(bits)
        return out

    tree_bits = [bits_of(b, t) for t, b in enumerate(trees)]

    # Depth of each parsed tree (longest root->leaf path), counting each
    # k-bit categorical node as the k levels its expansion chain occupies
    # (an all-rows-right empty bitset collapses to its RIGHT subtree:
    # 0 levels, and the dropped left subtree contributes no depth).
    def depth_of(blk, bits) -> int:
        if int(blk["num_leaves"]) == 1:
            return 0
        lc = [int(v) for v in blk["left_child"].split()]
        rc = [int(v) for v in blk["right_child"].split()]

        def d(ref: int) -> int:
            if ref < 0:
                return 0
            b = bits[ref]
            if b is None:                      # numerical node
                return 1 + max(d(lc[ref]), d(rc[ref]))
            if not b:                          # collapsed empty bitset
                return d(rc[ref])
            return len(b) + max(d(lc[ref]), d(rc[ref]))
        return d(0)

    max_depth = max(1, max(depth_of(b, bi)
                           for b, bi in zip(trees, tree_bits)))
    if max_depth > 30:
        raise ValueError(
            f"tree depth {max_depth} (after multi-category chain "
            "expansion) overflows the heap layout")
    # The heap is DENSE and its depth is GLOBAL: one k-category set deep
    # in one tree adds k-1 levels to EVERY tree's 2^(D+1)-1 node arrays.
    # Real LightGBM categorical splits routinely carry dozens of
    # categories, where the expansion allocates astronomically — fail
    # with the cause and the number, not a MemoryError from np.full.
    # 2^27 total nodes ~ 2.3 GB across the seven node arrays.
    total_nodes = len(trees) * (2 ** (max_depth + 1) - 1)
    if total_nodes > 2 ** 27:
        widest = max((len(b) for bi in tree_bits
                      for b in bi if b is not None), default=1)
        raise ValueError(
            f"multi-category chain expansion needs depth {max_depth} "
            f"across {len(trees)} trees = {total_nodes} heap nodes "
            f"(> 2^27): the dense heap layout cannot hold this model "
            f"(widest category set: {widest} bits). Models with large "
            "categorical sets are unrepresentable here; score them with "
            "LightGBM itself, or retrain with "
            "cat_features one-vs-rest splits"
        )
    n_nodes = 2 ** (max_depth + 1) - 1
    T = len(trees)
    feature = np.full((T, n_nodes), -1, np.int32)
    threshold_bin = np.zeros((T, n_nodes), np.int32)
    threshold_raw = np.zeros((T, n_nodes), np.float32)
    is_leaf = np.zeros((T, n_nodes), bool)
    leaf_value = np.zeros((T, n_nodes), np.float32)
    split_gain = np.zeros((T, n_nodes), np.float32)
    default_left = np.zeros((T, n_nodes), bool)
    any_missing = False
    cat_feats: set[int] = set()    # features with categorical nodes
    ord_feats: set[int] = set()    # features with numerical nodes

    for t, blk in enumerate(trees):
        bits_t = tree_bits[t]
        lv = [float(v) for v in blk["leaf_value"].split()]
        if int(blk["num_leaves"]) == 1:
            is_leaf[t, 0] = True
            leaf_value[t, 0] = lv[0]
            continue
        sf = [int(v) for v in blk["split_feature"].split()]
        sg = [float(v) for v in blk["split_gain"].split()]
        th = [float(v) for v in blk["threshold"].split()]
        dt = [int(float(v)) for v in blk["decision_type"].split()]
        lc = [int(v) for v in blk["left_child"].split()]
        rc = [int(v) for v in blk["right_child"].split()]

        def place(ref: int, slot: int, dup: bool = False) -> None:
            # `dup`: this subtree is a repeated COPY made by chain
            # expansion — its split gains are zeroed so gain-sum feature
            # importances count each original split exactly once.
            nonlocal any_missing
            if ref < 0:
                is_leaf[t, slot] = True
                leaf_value[t, slot] = lv[~ref]
                return
            bits = bits_t[ref]
            miss = (dt[ref] >> 2) == 2         # NaN missing type
            if miss:
                any_missing = True
            if bits is None:                   # numerical split
                ord_feats.add(sf[ref])
                feature[t, slot] = sf[ref]
                split_gain[t, slot] = 0.0 if dup else sg[ref]
                threshold_raw[t, slot] = th[ref]
                if miss:
                    default_left[t, slot] = bool(dt[ref] & _DEFAULT_LEFT)
                place(lc[ref], 2 * slot + 1, dup)
                place(rc[ref], 2 * slot + 2, dup)
                return
            if not bits:
                # Empty bitset reaching here means no category matches
                # AND NaN routes right too (default-right, or no missing
                # handling) — bits_of keeps a sentinel link otherwise —
                # so the node collapses to its right subtree; the no-op
                # split's gain vanishes with it.
                place(rc[ref], slot, dup)
                return
            # Categorical set -> a chain of one-vs-rest links: link j
            # tests bits[j] (matched goes LEFT into a copy of the left
            # subtree); the last link's right child is the right subtree.
            # NaN rows follow the node's default direction at EVERY link,
            # so default-left exits left at link 0 and default-right
            # falls through the chain — exactly the un-expanded routing.
            cat_feats.add(sf[ref])
            cur = slot
            for j, b in enumerate(bits):
                feature[t, cur] = sf[ref]
                # Gain on the first link only (same once-per-split rule).
                split_gain[t, cur] = 0.0 if dup or j > 0 else sg[ref]
                # Cat columns hold category ids in BOTH representations,
                # so bin and raw thresholds coincide.
                threshold_bin[t, cur] = b
                threshold_raw[t, cur] = float(b)
                if miss:
                    default_left[t, cur] = bool(dt[ref] & _DEFAULT_LEFT)
                place(lc[ref], 2 * cur + 1, dup or j > 0)
                if j < len(bits) - 1:
                    cur = 2 * cur + 2
            place(rc[ref], 2 * cur + 2, dup)

        place(0, 0)

    both = cat_feats & ord_feats
    if both:
        raise ValueError(
            f"features {sorted(both)} appear in both categorical and "
            "numerical nodes; TreeEnsemble derives split type from the "
            "feature, so mixed use is unrepresentable"
        )

    return TreeEnsemble(
        feature=feature,
        threshold_bin=threshold_bin,
        threshold_raw=threshold_raw,
        is_leaf=is_leaf,
        leaf_value=leaf_value,
        split_gain=split_gain,
        max_depth=max_depth,
        n_features=n_features,
        learning_rate=1.0,          # leaf values are final contributions
        base_score=0.0,             # folded into round 0's leaves
        loss=loss,
        n_classes=max(C, 2),
        has_raw_thresholds=True,
        cat_features=(np.asarray(sorted(cat_feats), np.int32)
                      if cat_feats else None),
        default_left=default_left if any_missing else None,
        # Raw-value traversal tests np.isnan directly; missing_bin=True
        # just switches the learned default_left directions on.
        missing_bin=any_missing,
    )
